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

In one process each shard's work is a ``runtime.compiled.CompiledStep``
(a CUDA graph on the card, op by op on the CPU and inside
``compiled.disable_graphs()``), as JAX compiles ``jit(vmap(per_frame_fn))``
and ``_compiled_smooth``: ``per_frame_fn`` over a block, cached per
(function, block shapes, device), and the forward and backward passes over
an extended block, cached per (its shape, the filter, device).  The steps
are lazy (the first call at a new shape runs op by op and the second
captures), and a graph's outputs are copied out before the next shard
replays it.  Across processes (a ``torch.distributed`` group) both run op
by op, as decided when the call starts; the halo exchange is never in a
graph.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from low_cost_mocap_tpu_torch.ops import lowpass
from low_cost_mocap_tpu_torch.parallel.mesh import Mesh, shard_along
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.utils import tree

# the per-block steps by shape, and the lock that lets one call at a time
# use them and their buffers
_BLOCKS, _SMOOTH = compiled.GraphCache(), compiled.GraphCache()
_LOCK = threading.RLock()


def cached_steps() -> list:
    """The compiled steps the caches hold."""
    return _BLOCKS.values() + _SMOOTH.values()


def _shape_key(t) -> tuple:
    return tuple((tuple(x.shape), x.dtype, x.device) for x in tree.leaves(t))


def _block_step(fn, state, block):
    return state, fn(block)


def _run_blocks(mesh: Mesh, cache, key_of, build, blocks) -> list:
    """Each block through its cached step (op by op across processes),
    the outputs copied out of the step's buffers.  A step's buffers past
    the block's (the filter's coefficients) are its own constants."""
    ctx = (compiled.disable_graphs() if mesh.distributed
           else contextlib.nullcontext())
    outs = []
    with _LOCK, ctx:
        for b in blocks:
            step = cache.get(key_of(b), lambda b=b: build(b))
            _, out = step((), b, *step.args[1:])
            outs.append(tree.tree_map(
                lambda t: t.to(mesh.tail_device, copy=True), out))
    return outs


def process_sequence(mesh: Mesh, frames_seq, per_frame_fn,
                     axis: str = "time"):
    """Run a per-frame function over a (T, ...) sequence (a tensor or a
    tuple of them), sharded over time: each shard's block of T/d frames
    goes to its device and through ``per_frame_fn`` (a block with a leading
    frame axis -> outputs with that axis).  T must be divisible by the axis
    size.  Returns the outputs concatenated along time on the tail device;
    across processes, this process's blocks only (no communication)."""
    is_tuple = isinstance(frames_seq, tuple)
    leaves = frames_seq if is_tuple else (frames_seq,)
    blocks = [b if is_tuple else b[0]
              for b in zip(*(shard_along(mesh, axis, x) for x in leaves))]
    step_fn = functools.partial(_block_step, per_frame_fn)
    outs = _run_blocks(
        mesh, _BLOCKS, lambda b: (per_frame_fn, _shape_key(b)),
        lambda b: compiled.CompiledStep(
            step_fn, (), tree.tree_map(torch.empty_like, b), lazy=True,
            name="process_sequence"), blocks)
    return tree.cat(outs)


def _filtfilt_block(x, b, a):
    """Zero-phase forward + backward IIR over the leading axis."""
    y = lowpass.lpf_scan(x, b, a)
    return lowpass.lpf_scan(y.flip(0), b, a).flip(0)


def _smooth_step(state, x, b, a):
    return state, _filtfilt_block(x, b, a)


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
    exts = [torch.cat([lh, blk, rh])
            for blk, lh, rh in zip(blocks, lefts, rights)]

    def build(x):
        coeffs = [torch.as_tensor(c, dtype=x.dtype, device=x.device)
                  for c in (b, a)]
        return compiled.CompiledStep(
            _smooth_step, (), torch.empty_like(x), *coeffs, lazy=True,
            name="smooth_sharded")

    outs = _run_blocks(
        mesh, _SMOOTH, lambda x: (_shape_key(x), b.tobytes(), a.tobytes()),
        build, exts)
    return torch.cat([sm[halo:halo + blk.shape[0]]
                      for sm, blk in zip(outs, blocks)])


def smooth_reference(tracks, order: int = 5, cutoff_hz: float = 20.0,
                     sample_hz: float = 60.0):
    """Sequential zero-phase smoother (one device; the golden result)."""
    b, a = lowpass.butter_coeffs(order, cutoff_hz, sample_hz)
    return _filtfilt_block(tracks, b, a)
