"""Offline processing of recorded sessions.

Counterpart of ``low_cost_mocap_tpu/models/offline.py``.  A recording of
T frame sets goes through the vision stages ``chunk`` frame sets at a time
(frame-independent, so each chunk is one batch of the geometry the live
path runs) and through the stateful trackers in time order:

- detection from frames is one ``detect_blobs`` launch per chunk on the
  card: the chunk's frame sets are stacked along the camera axis, which the
  kernel treats independently (dense uint8, 1-bit packed, or sparse
  lit-pixel frames; the last two unpacked or scattered on the device
  first); recordings detected on the host skip it (``frames_seq=(blobs,
  valid)``);
- the causal drone tracking is the ``kalman_bank`` kernel over the whole
  sequence in one launch (``kalman.update``'s semantics, as the JAX
  package's offline scan);
- ``smooth=True`` adds the RTS smoother (``kalman.smooth_sequence``: its
  forward pass with ``advance_on_miss`` runs the plain chain, which the
  kernel does not have) and, with body sets, ``smooth_body_sequence``.

``stream_recording`` processes unbounded recordings in blocks with the
tracker state carried across blocks and calls: a worker thread detects the
next block on the host (native detection, into one of two page-locked
buffers) while the current block's device work is enqueued; no device
synchronisation separates blocks.  Its drone results are bit-identical to
``process_recording`` on the same host-detected blobs, whatever the chunk
and block (the geometry gives a frame set the same bits in any batch); body
fits, batched over a chunk's frames through small matmuls, are
bit-identical when ``chunk`` equals ``block``.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import NamedTuple

import numpy as np
import torch

from low_cost_mocap_tpu_torch.config import EngineConfig, RigConfig
from low_cost_mocap_tpu_torch.control import bindings
from low_cost_mocap_tpu_torch.models import pipeline
from low_cost_mocap_tpu_torch.ops import (body_tracker, correspond, detect,
                                          detect_cuda, kalman, rigid,
                                          rigid_general)
from low_cost_mocap_tpu_torch.utils import tree


class SequenceResult(NamedTuple):
    object_points: torch.Tensor   # (T, N, 3) world-frame points
    point_valid: torch.Tensor     # (T, N)
    point_errors: torch.Tensor    # (T, N)
    objects_pos: torch.Tensor     # (T, N, 3) raw drone-triple fits
    objects_valid: torch.Tensor   # (T, N)
    tracked: kalman.TrackedObjects    # (T, O, ...) causal drone tracks
    bodies: object = None         # LocatedBodies (T, I, ...) with body sets
    body_tracks: object = None    # TrackedBodies (T, I, ...)
    smoothed: object = None       # TrackedObjects (T, O, ...), smooth=True
    smoothed_bodies: object = None  # SmoothedBodies (T, I, ...), smooth=True
    #                               with body sets


def _resolve_sets(body_template, max_bodies, body_sets):
    if body_sets is None and body_template is not None:
        body_sets = ((body_template, int(max_bodies)),)
    return tuple(body_sets) if body_sets else ()


def detect_recording_host(frames_u8_seq, threshold: float, max_blobs: int,
                          weighted: bool = False):
    """Native host detection over a whole (T, C, H, W) uint8 recording in
    one call (threshold + bit-pack, then connected-component centroids).
    Returns numpy (blobs (T, C, K, 2) f32, valid (T, C, K) bool),
    bit-identical to the detection kernel (exact components; the kernel at
    enough sweeps), ready for ``process_recording(frames_seq=(blobs,
    valid))``.  ``weighted``: intensity-weighted centroids."""
    frames = np.asarray(frames_u8_seq)
    T, C, H, W = frames.shape
    blobs, valid, _ = bindings.ingest_detect(
        frames.reshape(T * C, H, W), detect.threshold_cutoff(float(threshold)),
        max_blobs, weighted=weighted)
    return (blobs.reshape(T, C, max_blobs, 2),
            valid.reshape(T, C, max_blobs))


def _blob_tail(blobs, bvalid, Ps, K, dist, to_world_matrix, Fs,
               rig: RigConfig, cfg: EngineConfig):
    """The vision tail shared by the one-shot and the streamed paths, over
    a (L, C, K, ...) batch of frame sets: undistort, match, world, drone
    triples (the live path's geometry).  Returns (world points, valid,
    errors, LocatedObjects)."""
    _, m, pts_w, loc = pipeline._locate_frame(
        blobs, bvalid, Ps, K, dist, to_world_matrix, Fs,
        gate_px=cfg.epipolar_gate_px,
        max_candidates=cfg.max_candidates_per_cam,
        marker_dist1=rig.marker_dist_short,
        marker_dist2=rig.marker_dist_long, marker_tol=rig.marker_dist_tol,
        marker_side_min=rig.marker_side_min)
    return pts_w, m["valid"], m["errors"], loc


def _fit_bodies(pts_w, pvalid, body_sets):
    """Every set fit over the points the earlier sets left, batched over
    the (L, N, 3) frames: LocatedBodies (L, I, ...)."""
    live, parts = pvalid, []
    for tmpl, max_inst in body_sets:
        b, live = rigid_general.locate_bodies(
            pts_w, live, tmpl, max_instances=max_inst, return_live=True)
        parts.append(b)
    return rigid_general.LocatedBodies(*(torch.cat(x, dim=1)
                                         for x in zip(*parts)))


def _track_bodies(states, bodies, dts, body_sets):
    """The body trackers frame by frame, one per set over its slot slice.
    Returns (new states, TrackedBodies (T, I, ...))."""
    new, tracks, off = [], [], 0
    for si, (_, max_inst) in enumerate(body_sets):
        sl = slice(off, off + max_inst)
        st, per = states[si], []
        for k in range(dts.shape[0]):
            st, tb = body_tracker.update(st, bodies.t[k, sl], bodies.R[k, sl],
                                         bodies.rms[k, sl],
                                         bodies.valid[k, sl], dts[k])
            per.append(tb)
        new.append(st)
        tracks.append(tree.stack(per))
        off += max_inst
    return tuple(new), body_tracker.TrackedBodies(
        *(torch.cat(x, dim=1) for x in zip(*tracks)))


def _frames_chunk(frames_seq, lo, hi, dev, packed, sparse, shape):
    """Frame sets lo..hi as (L, C, H, W) float32 on ``dev``, and their
    detection threshold (None: the config's; 0.5 for binary frames)."""
    x = frames_seq[lo:hi]
    x = x.to(dev) if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x)).to(dev)
    if sparse:
        return torch.stack([detect.scatter_pixels(i, shape) for i in x]), 0.5
    if packed:
        return detect.unpack_bits(x), 0.5
    return x.to(torch.float32) * (1.0 / 255.0), None


def process_recording(frames_seq, Ps, K, dist, to_world_matrix,
                      rig: RigConfig, cfg: EngineConfig, dts=None,
                      packed: bool = False, sparse: bool = False,
                      chunk: int = 32, body_template=None,
                      max_bodies: int = 2, body_sets=None,
                      smooth: bool = False) -> SequenceResult:
    """Run a whole recording through vision and tracking on the device of
    the calibration tensors (``Ps``, ``K``, ``dist``, ``to_world_matrix``).

    frames_seq: (T, C, H, W) uint8 frames, (T, C, H, W//8) when
    ``packed``, (T, budget) int32 lit-pixel indices when ``sparse``
    (numpy or tensors), or ``(blobs (T, C, K, 2), valid (T, C, K))`` of a
    host detection (``detect_recording_host``).  dts: (T,) frame intervals
    (default 1 / target_fps).  ``chunk`` frame sets go through the vision
    at a time.  ``body_sets`` (((BodyTemplate, max_instances), ...); or
    ``body_template``/``max_bodies``): 6-DoF fits and tracks per frame.
    ``smooth``: also the RTS-smoothed drone tracks (and body tracks).
    """
    dev = Ps.device
    body_sets = _resolve_sets(body_template, max_bodies, body_sets)
    from_blobs = isinstance(frames_seq, tuple)
    T = len(frames_seq[0]) if from_blobs else len(frames_seq)
    dts = (torch.full((T,), 1.0 / cfg.target_fps) if dts is None
           else torch.as_tensor(dts)).to(dtype=torch.float32, device=dev)
    Fs = correspond._pairwise_fundamentals(Ps)
    shape = (rig.num_cameras, *rig.image_hw())
    outs, fits = [], []
    for lo in range(0, T, chunk):
        hi = min(lo + chunk, T)
        if from_blobs:
            blobs, bvalid = (torch.as_tensor(a[lo:hi]).to(dev)
                             for a in frames_seq)
        else:
            f, thr = _frames_chunk(frames_seq, lo, hi, dev, packed, sparse,
                                   shape)
            L, C = f.shape[:2]
            # one launch for the chunk: its frame sets side by side as
            # L*C cameras, which the detector treats independently
            b, v, _ = detect_cuda.find_blobs(
                f.reshape(L * C, *f.shape[2:]).contiguous(),
                cfg.detect_threshold if thr is None else thr, cfg.max_blobs,
                cc_iters=cfg.cc_iters)
            blobs, bvalid = b.view(L, C, -1, 2), v.view(L, C, -1)
        out = _blob_tail(blobs, bvalid, Ps, K, dist, to_world_matrix, Fs,
                         rig, cfg)
        outs.append(out)
        if body_sets:
            fits.append(_fit_bodies(out[0], out[1], body_sets))
    pts_w, pvalid, perr, loc = tree.cat(outs)
    _, tracked = pipeline._bank(
        kalman.init_state(rig.num_objects, device=dev), loc, dts,
        cfg.kalman_report, "auto")
    smoothed = bodies = body_tracks = smoothed_bodies = None
    if smooth:
        smoothed, _ = kalman.smooth_sequence(
            kalman.init_state(rig.num_objects, device=dev), loc.pos,
            loc.heading, loc.index, loc.valid, dts,
            process_noise=cfg.kalman_process_noise,
            meas_noise=cfg.kalman_measurement_noise)
    if body_sets:
        bodies = tree.cat(fits)
        _, body_tracks = _track_bodies(
            tuple(body_tracker.init_state(mi, device=dev)
                  for _, mi in body_sets), bodies, dts, body_sets)
        if smooth:
            parts, off = [], 0
            for _, max_inst in body_sets:
                sl = slice(off, off + max_inst)
                parts.append(body_tracker.smooth_body_sequence(
                    bodies.t[:, sl], bodies.R[:, sl], bodies.rms[:, sl],
                    bodies.valid[:, sl], dts, max_bodies=max_inst))
                off += max_inst
            smoothed_bodies = body_tracker.SmoothedBodies(
                *(torch.cat(x, dim=1) for x in zip(*parts)))
    return SequenceResult(pts_w, pvalid, perr, loc.pos, loc.valid, tracked,
                          bodies, body_tracks, smoothed, smoothed_bodies)


class StreamStats(NamedTuple):
    """Host-side timings of one ``stream_recording`` call (s): its wall
    time and the native detection's busy time in the worker thread."""
    wall_s: float
    detect_s: float
    blocks: int


def stream_recording(frames_u8_seq, Ps, K, dist, to_world_matrix,
                     rig: RigConfig, cfg: EngineConfig, dts=None,
                     block: int = 64, state=None, body_sets=None,
                     body_template=None, max_bodies: int = 2,
                     weighted: bool = False, stats: list | None = None):
    """Block-streamed processing: bounded host memory, tracker state
    carried across blocks (pass the returned state back in to continue),
    host detection of the next block overlapped with the current block's
    device work.

    frames_u8_seq: (T, C, H, W) uint8 of any length: each block's host
    detection fills a fixed (block, C, K, 3) page-locked buffer; a partial
    last block is zero-padded, and the ``live`` mask gates it, so a dead
    frame leaves every tracker state untouched (the bank runs the block's
    live prefix, the body trackers skip dead frames).  Returns
    (SequenceResult trimmed to T, final state); ``stats``, when given, gets
    a ``StreamStats``.
    """
    t_wall = time.perf_counter()
    dev = Ps.device
    cuda = dev.type == "cuda"
    body_sets = _resolve_sets(body_template, max_bodies, body_sets)
    frames = np.asarray(frames_u8_seq)
    T = frames.shape[0]
    if T == 0:
        raise ValueError("empty recording")
    dts = np.full((T,), 1.0 / cfg.target_fps, np.float32) if dts is None \
        else np.asarray(dts, np.float32)
    if state is None:
        state = kalman.init_state(rig.num_objects, device=dev)
        if body_sets:
            state = (state, tuple(body_tracker.init_state(mi, device=dev)
                                  for _, mi in body_sets))
    kstate, bstates = state if body_sets else (state, ())
    C, KB = rig.num_cameras, cfg.max_blobs
    cutoff = detect.threshold_cutoff(cfg.detect_threshold)
    ring = [torch.zeros((block, C, KB, 3), pin_memory=cuda)
            for _ in range(2)]
    uploaded = [None, None]          # the event after each slot's upload
    detect_s = [0.0]
    Fs = correspond._pairwise_fundamentals(Ps)
    n_blocks = -(-T // block)

    def host_detect(i):
        """Block i into ring slot i % 2; returns its live mask."""
        t0 = time.perf_counter()
        slot = i % 2
        if uploaded[slot] is not None:
            uploaded[slot].synchronize()   # that slot's last upload is done
        blk = frames[i * block:(i + 1) * block]
        buf = ring[slot].numpy()
        live = np.zeros((block,), bool)
        live[:len(blk)] = True
        bindings.ingest_detect_packed(blk, cutoff, KB, weighted=weighted,
                                      out=buf[:len(blk)])
        buf[len(blk):] = 0.0
        detect_s[0] += time.perf_counter() - t0
        return live

    outs, fits, tracks, btracks = [], [], [], []
    with concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="lcm-offline-detect") as pool:
        nxt = pool.submit(host_detect, 0)
        for i in range(n_blocks):
            live = nxt.result()
            slot = i % 2
            if cuda:
                up = ring[slot].to(dev, non_blocking=True)
                uploaded[slot] = torch.cuda.Event()
                uploaded[slot].record()
            else:
                up = ring[slot].clone()
            if i + 1 < n_blocks:
                nxt = pool.submit(host_detect, i + 1)
            n_live = int(live.sum())
            d = torch.from_numpy(dts[i * block:i * block + n_live]).to(dev)
            out = _blob_tail(up[..., :2], up[..., 2] > 0.5, Ps, K, dist,
                             to_world_matrix, Fs, rig, cfg)
            loc = out[3]
            # the gate: dead frames are a suffix, so the trackers run over
            # the live prefix only
            kstate, tr = pipeline._bank(
                kstate, rigid.LocatedObjects(*(x[:n_live] for x in loc)),
                d, cfg.kalman_report, "auto")
            outs.append(tuple(x[:n_live] for x in out[:3])
                        + (rigid.LocatedObjects(*(x[:n_live] for x in loc)),))
            tracks.append(tr)
            if body_sets:
                b = _fit_bodies(out[0], out[1], body_sets)
                b = rigid_general.LocatedBodies(*(x[:n_live] for x in b))
                bstates, tb = _track_bodies(bstates, b, d, body_sets)
                fits.append(b)
                btracks.append(tb)
    pts_w, pvalid, perr, loc = tree.cat(outs)
    res = SequenceResult(pts_w, pvalid, perr, loc.pos, loc.valid,
                         tree.cat(tracks),
                         tree.cat(fits) if body_sets else None,
                         tree.cat(btracks) if body_sets else None)
    if stats is not None:
        stats.append(StreamStats(time.perf_counter() - t_wall, detect_s[0],
                                 n_blocks))
    return res, ((kstate, bstates) if body_sets else kstate)
