"""Camera-sharded live pipeline: the multi-device frame step.

Counterpart of ``low_cost_mocap_tpu/parallel/dist_pipeline.py``.  Frames
are the big data of the system (C x H x W a frame set); every later stage
works on a few hundred floats.  So each shard of the ``cam`` axis takes
its C/d cameras to its device and detects their blobs there with the
``detect_blobs`` kernel (its plain version for CPU tensors), one launch a
shard; the centroids and masks are gathered in camera order, as one
(C, K, 3) [x, y, valid] tensor (JAX's ``all_gather``); and the small
tail — ``models.pipeline.track_from_blobs``, or ``scan_track_from_blobs``
over a batch with the ``kalman_bank`` kernel once — runs on the gathered
blobs.

These functions run op by op: the reference of the Engine's camera-sharded
steps, which capture ``detect_gather`` and the tail as CUDA graphs
(``runtime/engine.py``).  A graph holds its buffers' addresses, so unlike
the JAX package's ``lru_cache`` of compiled programs a graph is not shared
between callers: each Engine keeps its own, one per kind of step.

The JAX step runs the tail replicated on every device.  Here it runs once
per process, on the mesh's first device, and returns its results there:
in one process that is the one copy, and across processes every rank runs
it on its own device from the same gathered blobs, so the ranks' results
are equal bit for bit.  Detection is per camera, so a shard's cameras get
the same bits as in one launch over all cameras, and the tail sees the
same tensor as the single-device step.
"""

from __future__ import annotations

import torch

from low_cost_mocap_tpu_torch.models.pipeline import (pack_outputs,
                                                      scan_track_from_blobs,
                                                      tail_kwargs,
                                                      track_from_blobs)
from low_cost_mocap_tpu_torch.ops import detect, detect_cuda
from low_cost_mocap_tpu_torch.parallel.mesh import Mesh, shard_along


def detect_shard(frames, cfg, packed: bool):
    """One shard's (..., C/d, H, W[/8]) frames -> (..., C/d, K, 3)
    [x, y, valid] float32 blobs: one detection launch over every frame of
    the shard."""
    if packed:
        f = detect.unpack_bits(frames)
        thr = 0.5
    else:
        f = frames.to(torch.float32) * (1.0 / 255.0) \
            if not frames.is_floating_point() else frames
        thr = cfg.detect_threshold
    lead = f.shape[:-2]
    blobs, valid, _ = detect_cuda.find_blobs(
        f.reshape(-1, *f.shape[-2:]).contiguous(), thr, cfg.max_blobs,
        cc_iters=cfg.cc_iters)
    out = torch.cat([blobs, valid[..., None].to(torch.float32)], dim=-1)
    return out.reshape(*lead, *out.shape[-2:])


def detect_gather(mesh: Mesh, shards, cfg, *, packed: bool = False,
                  dim: int = 0) -> torch.Tensor:
    """This process's shards (each (..., C/d, H, W[/8]) on its device, in
    shard order, the camera axis at ``dim``) detected each on its device
    and gathered in camera order on the tail device: (..., C, K, 3)
    [x, y, valid].  On one device it holds no host read, so a graph can
    capture it (``runtime/engine.py``'s mesh steps)."""
    parts = [detect_shard(s, cfg, packed) for s in shards]
    g = mesh.gather(parts)                       # (d, ..., C/d, K, 3)
    # shards along the camera axis, in order: camera c = shard c // (C/d)
    g = torch.movedim(g, 0, dim)                 # (..., d, C/d, K, 3)
    return g.reshape(*g.shape[:dim], -1, *g.shape[dim + 2:])


def gather_blobs(mesh: Mesh, frames, cfg, *, axis: str = "cam",
                 packed: bool = False, dim: int = 0) -> torch.Tensor:
    """Detect each shard's cameras on its device and gather the blobs in
    camera order on the tail device: frames (..., C, H, W[/8]) with the
    camera axis at ``dim`` -> (..., C, K, 3) [x, y, valid]."""
    return detect_gather(mesh, shard_along(mesh, axis, frames, dim=dim),
                         cfg, packed=packed, dim=dim)


def dist_frame_step(mesh: Mesh, state, frames, dt, Ps, K, dist,
                    to_world_matrix, Fs, rig, cfg, *, axis: str = "cam",
                    packed: bool = False, with_obs: bool = False,
                    pack: bool = False):
    """One camera-sharded frame step over ``mesh``.

    frames: (C, H, W) uint8 (or (C, H, W//8) bit-packed rows when
    ``packed``), a tensor or numpy array on any device; C must be
    divisible by the ``axis`` size.  The state and calibration tensors
    live on the tail device.  Returns (state, FrameOutputs) as
    ``models.pipeline.frame_step`` does, or (state, packed row) with
    ``pack``, on the tail device."""
    blobs = gather_blobs(mesh, frames, cfg, axis=axis, packed=packed)
    st, out = track_from_blobs(
        state, blobs[..., :2], blobs[..., 2] > 0.5, dt, Ps, K, dist,
        to_world_matrix, Fs, **tail_kwargs(rig, cfg, with_obs))
    return st, (pack_outputs(out) if pack else out)


def dist_scan_frame_step(mesh: Mesh, state, frames_b, dts, Ps, K, dist,
                         to_world_matrix, Fs, rig, cfg, *,
                         axis: str = "cam", packed: bool = False,
                         with_obs: bool = False):
    """B camera-sharded frames in one step: each shard detects its cameras
    of the whole batch in one launch over (B*C/d, H, W), the blobs are
    gathered once, and ``scan_track_from_blobs`` runs the batch (the bank
    kernel once at B).

    frames_b: (B, C, H, W) uint8 (or (B, C, H, W//8) when ``packed``); C
    divisible by the axis size; dts: (B,).  Returns (state, packed (B, L)
    rows), decodable by ``models.pipeline.unpack_outputs_batch``."""
    blobs = gather_blobs(mesh, frames_b, cfg, axis=axis, packed=packed,
                         dim=1)
    return scan_track_from_blobs(
        state, blobs[..., :2], blobs[..., 2] > 0.5, dts, Ps, K, dist,
        to_world_matrix, Fs, **tail_kwargs(rig, cfg, with_obs))
