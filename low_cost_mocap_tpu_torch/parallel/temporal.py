"""Temporal (sequence) parallelism: time-sharded offline processing.

Counterpart of ``low_cost_mocap_tpu/parallel/temporal.py``:

- ``process_sequence``: the per-frame vision pipeline is independent from
  frame to frame, so a recorded (T, ...) sequence shards over ``time``
  with no communication.  ``per_frame_fn`` takes a block of frames with a
  leading frame axis (the port's ops are batched; ``torch.func.vmap`` does
  not cover the matcher's data-dependent sorts).
- ``smooth_sharded``: zero-phase Butterworth smoothing is a sequential
  IIR, which couples time steps.  It runs block-parallel with halos: each
  block takes ``halo`` frames from each neighbour (by slicing in one
  process, by ``isend``/``irecv`` across processes: JAX's two
  ``ppermute``s), runs the forward and backward passes over
  [halo | block | halo] and keeps its own block.  The first and last
  blocks repeat their edge frame instead.  The IIR's impulse response
  decays geometrically, so a few dozen halo frames match the sequential
  smoother to float precision away from the sequence's edges.
"""

from __future__ import annotations

import torch

from low_cost_mocap_tpu_torch.ops import lowpass
from low_cost_mocap_tpu_torch.parallel.mesh import Mesh, shard_along
from low_cost_mocap_tpu_torch.utils import tree


def process_sequence(mesh: Mesh, frames_seq, per_frame_fn,
                     axis: str = "time"):
    """Run a per-frame function over a (T, ...) sequence (a tensor or a
    tuple of them), sharded over time: each shard's block of T/d frames
    goes to its device and through ``per_frame_fn`` (a block with a leading
    frame axis -> outputs with that axis).  T must be divisible by the axis
    size.  Returns the outputs concatenated along time on the tail device;
    across processes, this process's blocks only (no communication)."""
    leaves = frames_seq if isinstance(frames_seq, tuple) else (frames_seq,)
    blocks = list(zip(*(shard_along(mesh, axis, x) for x in leaves)))
    outs = [per_frame_fn(b if isinstance(frames_seq, tuple) else b[0])
            for b in blocks]
    tail = mesh.tail_device
    return tree.cat([tree.tree_map(lambda t: t.to(tail), o) for o in outs])


def _filtfilt_block(x, b, a):
    """Zero-phase forward + backward IIR over the leading axis."""
    y = lowpass.lpf_scan(x, b, a)
    return lowpass.lpf_scan(y.flip(0), b, a).flip(0)


def _neighbour_halos(mesh: Mesh, blocks: list, halo: int):
    """(left, right) halos of each of this process's blocks: the previous
    block's last ``halo`` frames and the next block's first, the global
    first and last blocks repeating their edge frame."""
    n = len(blocks)
    lefts = [blocks[i - 1][-halo:] if i else None for i in range(n)]
    rights = [blocks[i + 1][:halo] if i + 1 < n else None
              for i in range(n)]
    if mesh.distributed:
        import torch.distributed as dist

        rank = dist.get_rank(mesh.group)
        world = dist.get_world_size(mesh.group)
        stage = mesh.backend() == "gloo"

        def peer(r):
            return dist.get_global_rank(mesh.group, r)

        def wire(t):
            t = t.contiguous()
            return t.cpu() if stage else t

        ops, recv = [], {}
        if rank > 0:
            ops.append(dist.isend(wire(blocks[0][:halo]), peer(rank - 1),
                                  group=mesh.group))
            recv["left"] = wire(torch.empty_like(blocks[0][-halo:]))
            ops.append(dist.irecv(recv["left"], peer(rank - 1),
                                  group=mesh.group))
        if rank + 1 < world:
            ops.append(dist.isend(wire(blocks[-1][-halo:]), peer(rank + 1),
                                  group=mesh.group))
            recv["right"] = wire(torch.empty_like(blocks[-1][:halo]))
            ops.append(dist.irecv(recv["right"], peer(rank + 1),
                                  group=mesh.group))
        for op in ops:
            op.wait()
        if "left" in recv:
            lefts[0] = recv["left"].to(blocks[0].device)
        if "right" in recv:
            rights[-1] = recv["right"].to(blocks[-1].device)
    for i, blk in enumerate(blocks):
        if lefts[i] is None:
            lefts[i] = blk[:1].expand(halo, *blk.shape[1:])
        if rights[i] is None:
            rights[i] = blk[-1:].expand(halo, *blk.shape[1:])
    return lefts, rights


def smooth_sharded(mesh: Mesh, tracks, halo: int, axis: str = "time",
                   order: int = 5, cutoff_hz: float = 20.0,
                   sample_hz: float = 60.0):
    """Block-parallel zero-phase smoothing of (T, D) tracks with halos.

    Matches the sequential smoother (``smooth_reference``) away from the
    sequence's edges; ``halo`` sets the accuracy (32 is plenty for the
    reference's order-5, 20 Hz at 60 Hz design) and may not exceed a
    block.  Returns the smoothed tracks on the tail device; across
    processes, this process's blocks."""
    n = mesh.shape[axis]
    T = tracks.shape[0]
    if T % n:
        raise ValueError(f"{T} frames are not divisible by the {axis!r} "
                         f"axis size {n}")
    if not 0 < halo <= T // n:
        raise ValueError(f"halo {halo} must be in [1, {T // n}], a block")
    b, a = lowpass.butter_coeffs(order, cutoff_hz, sample_hz)
    blocks = shard_along(mesh, axis, tracks)
    lefts, rights = _neighbour_halos(mesh, blocks, halo)
    tail = mesh.tail_device
    out = []
    for blk, lh, rh in zip(blocks, lefts, rights):
        sm = _filtfilt_block(torch.cat([lh, blk, rh]), b, a)
        out.append(sm[halo:halo + blk.shape[0]].to(tail))
    return torch.cat(out)


def smooth_reference(tracks, order: int = 5, cutoff_hz: float = 20.0,
                     sample_hz: float = 60.0):
    """Sequential zero-phase smoother (one device; the golden result)."""
    b, a = lowpass.butter_coeffs(order, cutoff_hz, sample_hz)
    return _filtfilt_block(tracks, b, a)
