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
  valid)``); a recording in host memory goes up a chunk at a time
  through a page-locked, double-buffered ring on a copy stream
  (``_Staging``), each chunk's upload under the previous chunk's vision;
- the causal drone tracking is the ``kalman_bank`` kernel over the whole
  sequence in one launch (``kalman.update``'s semantics, as the JAX
  package's offline scan);
- ``smooth=True`` adds the RTS smoother (``kalman.smooth_sequence``: its
  forward filter, ``advance_on_miss``, is the ``kalman_bank`` kernel's
  forward instantiation over the whole sequence in one launch,
  ``kalman_cuda.forward_scan``; its backward pass two launches of the
  file's backward kernels, ``kalman_cuda.backward_scan``: the gains of
  every step at once, then one sweep) and, with body sets,
  ``smooth_body_sequence``.

``stream_recording`` processes unbounded recordings in blocks with the
tracker state carried across blocks and calls: a worker thread detects the
next block on the host (native detection, into one of two page-locked
buffers) while the current block's device work is enqueued; no device
synchronisation separates blocks.  Its drone results are bit-identical to
``process_recording`` on the same host-detected blobs, whatever the chunk
and block (the geometry gives a frame set the same bits in any batch); body
fits, batched over a chunk's frames through small matmuls, are
bit-identical when ``chunk`` equals ``block``.

Both run as compiled steps (``runtime/compiled.py``; the JAX package's
``_compiled_run`` and ``_compiled_block``), cached by shape and never by
the recording's length: the chunk's vision is one step of ``chunk`` frame
sets (the last chunk zero-padded; its dead frame sets are dropped), each
per-frame loop (the body smoother's passes, the body trackers, the sign
alignment) a ``ChunkedScan`` of ``chunk`` frames, and a streamed block one
step with the trackers over its live frames (one for a full block, one
for the partial last block).  The causal bank and the drone smoother's
forward filter stay one kernel launch over T each, and its backward pass
two; on the CPU the forward filter and the backward sweep are
``ChunkedScan``s of their plain chains.  On the card each step is a
CUDA graph captured at its first use, but for a streamed block, which is
built lazy: its first call runs op by op and the capture comes at its
second, so the partial last block that a call runs once costs what it
costs op by op, and is captured by the next recording that ends in a
block of its length.  On the CPU,
and under ``compiled.disable_graphs()``, the same steps run op by op over
their buffers.  A capture that fails raises.
The cached steps' buffers are shared, so one offline call runs at a time
in a process, whatever its device: ``process_recording`` and
``stream_recording`` hold a module lock (``_LOCK``) for their whole call.
"""

from __future__ import annotations

import concurrent.futures
import functools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from low_cost_mocap_tpu_torch.config import EngineConfig, RigConfig
from low_cost_mocap_tpu_torch.control import bindings
from low_cost_mocap_tpu_torch.models import pipeline
from low_cost_mocap_tpu_torch.ops import (body_tracker, correspond, detect,
                                          detect_cuda, kalman, kalman_cuda,
                                          rigid, rigid_general)
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.utils import tree

# the compiled steps of the offline paths by shape, a cache for each kind
# (as JAX keeps an lru_cache(maxsize=16) a compiled function): the chunk
# vision, the streamed block and the chunked loops; _LOCK lets one call
# at a time use them and their buffers, and the staging rings (_Staging)
# by the shapes of the payload they carry
_VISION, _BLOCKS, _SCANS = (compiled.GraphCache() for _ in range(3))
_STAGING = compiled.GraphCache()
_LOCK = threading.RLock()

staged_chunks = 0   # chunks uploaded through a staging ring


def cached_steps() -> list:
    """The compiled steps the caches hold (a loop's, ``ChunkedScan.step``,
    for a loop)."""
    return [getattr(s, "step", s) for c in (_VISION, _BLOCKS, _SCANS)
            for s in c.values()]


def clear_cache() -> None:
    """Drop every cached step and its graph, and the staging rings."""
    with _LOCK:
        for c in (_VISION, _BLOCKS, _SCANS, _STAGING):
            c.clear()


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


def _track_bodies(states, bodies, dts, body_sets, scan=tree.scan):
    """The body trackers frame by frame, one per set over its slot slice.
    Returns (new states, TrackedBodies (T, I, ...)); the states are None
    from a runner that returns no carry (``_graph_scan``)."""
    new, tracks, off = [], [], 0
    for si, (_, max_inst) in enumerate(body_sets):
        sl = slice(off, off + max_inst)
        st, tb = scan(body_tracker.update, states[si], bodies.t[:, sl],
                      bodies.R[:, sl], bodies.rms[:, sl], bodies.valid[:, sl],
                      dts)
        new.append(st)
        tracks.append(tb)
        off += max_inst
    return tuple(new), body_tracker.TrackedBodies(
        *(torch.cat(x, dim=1) for x in zip(*tracks)))


def _fn_key(fn):
    """A hashable key for a step function (a ``functools.partial`` by its
    function and arguments)."""
    if isinstance(fn, functools.partial):
        return (fn.func, fn.args, tuple(sorted(fn.keywords.items())))
    return fn


def _spec(tensors, lead: int = 0) -> tuple:
    """Shapes (without ``lead`` leading dimensions), dtypes and devices."""
    return tuple((tuple(t.shape[lead:]), t.dtype, str(t.device))
                 for t in tensors)


def _graph_scan(chunk: int):
    """A loop runner with ``utils.tree.scan``'s signature that runs the loop
    as a cached ``ChunkedScan`` of ``chunk`` frames: one graph a loop and
    shape, whatever the recording's length.  It returns no carry."""
    def run(step, carry, *xs, reverse=False):
        key = ("scan", _fn_key(step), chunk, reverse,
               _spec(tree.leaves(carry)), _spec(xs, 1))
        name = getattr(getattr(step, "func", step), "__name__", "scan")
        sc = _SCANS.get(key, lambda: compiled.ChunkedScan(
            step, carry, xs, chunk, reverse=reverse, name=name))
        return None, sc.run(carry, *xs)
    return run


def _vision(state, payload, Ps, K, dist, to_world_matrix, Fs, *, kind,
            shape, rig, cfg, body_sets):
    """One chunk of frame sets through the vision stages (a compiled step
    without state, ``()``): detection unless ``kind`` is "blobs", then
    ``_blob_tail`` and the body fits.  Returns ((), ((world points, valid,
    errors, LocatedObjects), LocatedBodies or None))."""
    if kind == "blobs":
        blobs, bvalid = payload
    else:
        if kind == "sparse":
            f = torch.stack([detect.scatter_pixels(i, shape)
                             for i in payload])
        elif kind == "packed":
            f = detect.unpack_bits(payload)
        else:
            f = payload.to(torch.float32) * (1.0 / 255.0)
        L, C = f.shape[:2]
        # one launch for the chunk: its frame sets side by side as L*C
        # cameras, which the detector treats independently
        b, v, _ = detect_cuda.find_blobs(
            f.reshape(L * C, *f.shape[2:]).contiguous(),
            cfg.detect_threshold if kind == "dense" else 0.5, cfg.max_blobs,
            cc_iters=cfg.cc_iters)
        blobs, bvalid = b.view(L, C, -1, 2), v.view(L, C, -1)
    out = _blob_tail(blobs, bvalid, Ps, K, dist, to_world_matrix, Fs,
                     rig, cfg)
    return (), (out, _fit_bodies(out[0], out[1], body_sets)
                if body_sets else None)


def _load(buf, x, lo: int, hi: int) -> None:
    """Frames lo..hi of ``x`` (an array or a tensor) into the first rows of
    ``buf``, zeros after them."""
    part = x[lo:hi]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    n = hi - lo
    buf[:n].copy_(part)
    if n < buf.shape[0]:
        buf[n:].zero_()


class _Staging:
    """How a recording on the host reaches a vision step on the card, a
    chunk at a time: for each leaf of the step's payload two page-locked
    host slots (``compiled.HostRing``) and two landing slots on the card,
    and the copy stream between them (``compiled.copy_stream``).

    ``upload`` writes chunk k into a free host slot and, on the copy
    stream, copies it into landing slot k % 2 once the step has taken
    chunk k - 2 out of that slot; ``run`` makes the current stream wait for
    the upload and calls the step on the landing slot (the step copies it
    into its own buffer, one copy on the card).  So chunk k + 1 goes up
    while chunk k's graph runs, where a copy from pageable memory would
    hold the host and wait for the graph to stop reading the buffer."""

    def __init__(self, payload):
        dev = tree.leaves(payload)[0].device
        self.device = dev
        self.host = [compiled.HostRing(2, t.shape, dev, t.dtype)
                     for t in tree.leaves(payload)]
        self.landing = [tree.tree_map(torch.empty_like, payload)
                        for _ in range(2)]
        for t in tree.leaves(self.landing):
            # written on the copy stream: freed only after what it queued
            t.record_stream(compiled.copy_stream(dev))
        self.uploaded = [torch.cuda.Event() for _ in range(2)]
        self.taken = [torch.cuda.Event() for _ in range(2)]

    def upload(self, k: int, seqs, lo: int, hi: int) -> None:
        """Frames lo..hi of each array of ``seqs`` (chunk k) on their way
        into landing slot k % 2, zeros after them."""
        global staged_chunks
        s = k % 2
        slots = [ring.acquire() for ring in self.host]
        for ring, i, a in zip(self.host, slots, seqs):
            _load(ring.bufs[i], a, lo, hi)
        stream = compiled.copy_stream(self.device)
        with torch.cuda.stream(stream):
            stream.wait_event(self.taken[s])
            for ring, i, dst in zip(self.host, slots,
                                    tree.leaves(self.landing[s])):
                dst.copy_(ring.bufs[i], non_blocking=True)
                ring.fence(i)
            self.uploaded[s].record(stream)
        staged_chunks += 1

    def run(self, step, k: int):
        """``step`` over chunk k once its upload is done; landing slot
        k % 2 is free again after it."""
        s = k % 2
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self.uploaded[s])
        res = step((), self.landing[s], *step.args[1:])
        self.taken[s].record(cur)
        return res


def _into(dst, out, lo: int, n: int) -> None:
    """Copy the first ``n`` rows of each leaf of ``out`` into rows
    lo..lo+n of the like leaf of ``dst``."""
    for d, y in zip(tree.leaves(dst), tree.leaves(out)):
        d[lo:lo + n].copy_(y[:n])


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

    The vision is one compiled step of ``chunk`` frame sets (the last chunk
    zero-padded); on the card a recording on the host (arrays or CPU
    tensors) goes up to it through a staging ring (``_Staging``), chunk
    k + 1 while chunk k runs, and one already on the card is copied into
    its buffer directly.  The smoothers' and the body trackers' loops are
    ``ChunkedScan``s of ``chunk`` frames, all cached by shape
    (``_VISION``, ``_SCANS``): a recording of any length replays them.
    On the card the drone smoother's forward filter is one kernel launch
    (``kalman_cuda.forward_scan``) and its backward pass two
    (``kalman_cuda.backward_scan``) instead of loops.
    One offline call runs at a time in a process (``_LOCK``).
    """
    dev = Ps.device
    body_sets = pipeline._resolve_sets(body_template, max_bodies, body_sets)
    from_blobs = isinstance(frames_seq, tuple)
    T = len(frames_seq[0]) if from_blobs else len(frames_seq)
    dts = (torch.full((T,), 1.0 / cfg.target_fps) if dts is None
           else torch.as_tensor(dts)).to(dtype=torch.float32, device=dev)
    Fs = correspond._pairwise_fundamentals(Ps)
    shape = (rig.num_cameras, *rig.image_hw())
    kind = ("blobs" if from_blobs else "sparse" if sparse
            else "packed" if packed else "dense")
    seqs = frames_seq if from_blobs else (frames_seq,)
    cal = (Ps, K, dist, to_world_matrix, Fs)
    key = ("vision", kind, chunk, _spec(cal),
           tuple((tuple(np.shape(a)[1:]), str(a.dtype)) for a in seqs),
           rig, cfg, body_sets)

    def build():
        bufs = tuple(torch.zeros((chunk,) + tuple(np.shape(a)[1:]),
                                 dtype=torch.as_tensor(a[:1]).dtype,
                                 device=dev) for a in seqs)
        return compiled.CompiledStep(
            functools.partial(_vision, kind=kind, shape=shape, rig=rig,
                              cfg=cfg, body_sets=body_sets), (),
            bufs if from_blobs else bufs[0],
            *(torch.zeros_like(t) for t in cal), name=f"offline {kind}")

    with _LOCK:
        step = _VISION.get(key, build)
        bufs = tree.leaves(step.args[0])
        compiled.assign(step.args[1:], cal)
        ring = None
        if dev.type == "cuda" and not any(
                isinstance(a, torch.Tensor) and a.device.type != "cpu"
                for a in seqs):
            ring = _STAGING.get(_spec(bufs), lambda: _Staging(step.args[0]))
        chunks = [(lo, min(lo + chunk, T)) for lo in range(0, T, chunk)]
        res = None
        for k, (lo, hi) in enumerate(chunks):
            if ring is None:
                for buf, a in zip(bufs, seqs):
                    _load(buf, a, lo, hi)
                _, out = step((), *step.args)
            else:
                if k == 0:
                    ring.upload(0, seqs, lo, hi)
                _, out = ring.run(step, k)
            if res is None:
                res = tree.tree_map(
                    lambda y: y.new_empty((T,) + tuple(y.shape[1:])), out)
            _into(res, out, lo, hi - lo)
            if ring is not None and k + 1 < len(chunks):
                # the host writes chunk k + 1 while the card runs chunk k
                ring.upload(k + 1, seqs, *chunks[k + 1])
        (pts_w, pvalid, perr, loc), bodies = res
        _, tracked = pipeline._bank(
            kalman.init_state(rig.num_objects, device=dev), loc, dts,
            cfg.kalman_report, "auto")
        scan = _graph_scan(chunk)
        smoothed = body_tracks = smoothed_bodies = None
        if smooth:
            smoothed, _ = kalman.smooth_sequence(
                kalman.init_state(rig.num_objects, device=dev), loc.pos,
                loc.heading, loc.index, loc.valid, dts,
                process_noise=cfg.kalman_process_noise,
                meas_noise=cfg.kalman_measurement_noise, scan=scan,
                forward=kalman_cuda.forward_scan,
                backward=kalman_cuda.backward_scan)
        if body_sets:
            _, body_tracks = _track_bodies(
                tuple(body_tracker.init_state(mi, device=dev)
                      for _, mi in body_sets), bodies, dts, body_sets, scan)
            if smooth:
                parts, off = [], 0
                for _, max_inst in body_sets:
                    sl = slice(off, off + max_inst)
                    parts.append(body_tracker.smooth_body_sequence(
                        bodies.t[:, sl], bodies.R[:, sl], bodies.rms[:, sl],
                        bodies.valid[:, sl], dts, max_bodies=max_inst,
                        scan=scan))
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


def _block(state, up, dts, Ps, K, dist, to_world_matrix, Fs, *, n_live,
           rig, cfg, body_sets):
    """One streamed block (a compiled step): the vision over the whole
    (block, C, K, 3) buffer, the trackers over its first ``n_live`` frame
    sets.  Returns (state, (world points, valid, errors, LocatedObjects,
    TrackedObjects[, LocatedBodies, TrackedBodies]) of the live frames)."""
    kstate, bstates = state if body_sets else (state, ())
    out = _blob_tail(up[..., :2], up[..., 2] > 0.5, Ps, K, dist,
                     to_world_matrix, Fs, rig, cfg)
    loc = rigid.LocatedObjects(*(x[:n_live] for x in out[3]))
    d = dts[:n_live]
    # the gate: dead frames are a suffix, so the trackers run over the
    # live prefix only
    kstate, tr = pipeline._bank(kstate, loc, d, cfg.kalman_report, "auto")
    res = tuple(x[:n_live] for x in out[:3]) + (loc, tr)
    if not body_sets:
        return kstate, res
    b = _fit_bodies(out[0], out[1], body_sets)
    b = rigid_general.LocatedBodies(*(x[:n_live] for x in b))
    bstates, tb = _track_bodies(bstates, b, d, body_sets)
    return (kstate, bstates), res + (b, tb)


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
    last block is zero-padded and its trackers run over its live frames
    only, so a dead frame leaves every tracker state untouched.  A block is
    one compiled step (``_block``), cached by shape with the number of
    live frames: one for a full block, one for the partial last block;
    each built lazy (its first call op by op, its capture at the second).
    Returns (SequenceResult trimmed to T, final state, tensors of its
    own); ``stats``, when given, gets a ``StreamStats``.  One offline call
    runs at a time in a process (``_LOCK``).
    """
    t_wall = time.perf_counter()
    dev = Ps.device
    body_sets = pipeline._resolve_sets(body_template, max_bodies, body_sets)
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
    C, KB = rig.num_cameras, cfg.max_blobs
    cutoff = detect.threshold_cutoff(cfg.detect_threshold)
    ring = compiled.HostRing(2, (block, C, KB, 3), dev)
    detect_s = [0.0]
    cal = (Ps, K, dist, to_world_matrix, correspond._pairwise_fundamentals(Ps))
    n_blocks = -(-T // block)

    def host_detect(i):
        """Block i into the next ring slot; returns (slot, its number of
        frames)."""
        t0 = time.perf_counter()
        slot = ring.acquire()
        blk = frames[i * block:(i + 1) * block]
        buf = ring.bufs[slot].numpy()
        bindings.ingest_detect_packed(blk, cutoff, KB, weighted=weighted,
                                      out=buf[:len(blk)])
        buf[len(blk):] = 0.0
        detect_s[0] += time.perf_counter() - t0
        return slot, len(blk)

    def block_step(n_live):
        key = ("block", block, n_live, _spec(tree.leaves(state)),
               _spec(cal), rig, cfg, body_sets)
        return _BLOCKS.get(key, lambda: compiled.CompiledStep(
            functools.partial(_block, n_live=n_live, rig=rig, cfg=cfg,
                              body_sets=body_sets),
            tree.tree_map(torch.clone, state),
            torch.zeros((block, C, KB, 3), device=dev),
            torch.zeros((block,), device=dev),
            *(torch.zeros_like(t) for t in cal), name="stream block",
            lazy=True))

    res = None
    with _LOCK, concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="lcm-offline-detect") as pool:
        nxt = pool.submit(host_detect, 0)
        for i in range(n_blocks):
            slot, n_live = nxt.result()
            step = block_step(n_live)
            if i == 0 or n_live < block:
                compiled.assign(step.args[2:], cal)
            d = np.zeros((block,), np.float32)
            d[:n_live] = dts[i * block:i * block + n_live]
            state, out = step(state, ring.bufs[slot], d, *step.args[2:])
            ring.fence(slot)
            if i + 1 < n_blocks:
                nxt = pool.submit(host_detect, i + 1)
            if res is None:
                res = tree.tree_map(
                    lambda y: y.new_empty((T,) + tuple(y.shape[1:])), out)
            _into(res, out, i * block, n_live)
        # the state is the cached step's buffers: the caller gets a copy
        state = tree.tree_map(torch.clone, state)
    pts_w, pvalid, perr, loc, tracked = res[:5]
    out = SequenceResult(pts_w, pvalid, perr, loc.pos, loc.valid, tracked,
                         *(res[5:] if body_sets else ()))
    if stats is not None:
        stats.append(StreamStats(time.perf_counter() - t_wall, detect_s[0],
                                 n_blocks))
    return out, state
