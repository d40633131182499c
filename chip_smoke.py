"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``), builds both hand-written kernels
from ``low_cost_mocap_tpu_torch/csrc/``, and drives the port's live
tracking step at the configuration the repo serves — the reference's
four-camera PS3-Eye rig: 4 cameras, 320x320 frames, 8 blob slots,
cc_iters 24, 2 candidates per camera, 2 drones, batches of 128:

1. build both kernels and the native host library (nvcc and g++ in
   parallel) and print the card;
2. ``detect_blobs`` against its plain PyTorch version on 4x320x320 frames
   with threshold-edge pixels and a line longer than cc_iters, at cc_iters
   24 and at 150 (three passes of the kernel);
2b. host detection (the native library) against the ``detect_blobs``
   kernel on the same frames, bitwise;
3. ``kalman_bank`` against the plain chain at B=128, M=32, O=2 (dropouts,
   association ties, a gap re-seed) and at B=1, and its device time before
   the process serves or traces anything;
4. per-frame serving with detection on the card: the port's
   ``Engine(host_detect=False).process_frame`` over 200 deterministic
   frames of two drones (sparse ingest) — both kernels launch once per
   frame, the drones are tracked near ground truth;
4b. per-frame serving the default way, host detection: 200 frames at
   readback pipelining depth 0 and at depth 2, bitwise equal, the bank
   kernel once per frame;
4c. batched serving: the Engine at ``dispatch_batch`` 128 over 2 batches,
   inline and with the emit worker, against the per-frame host-detect
   events on the same frames;
4d. the Socket.IO server over the CUDA engine on a localhost port: a
   websocket client starts triangulation and receives object-points;
4e. the same through the launcher, ``python -m
   low_cost_mocap_tpu_torch.serve``, run as a process of its own;
5. the batched tail: ``scan_track_from_blobs`` at B=128 on blobs the
   detection kernel found, against 128 per-frame ``track_from_blobs`` rows;
6. times beside each kernel's bound: the event window (CUDA events around
   the wrapper, median of 20 calls) and the device time (``torch.profiler``,
   every kernel, memset and copy of 20 calls, each launch's record held),
   measured in a process of its own: the profiler keeps fewer of a short
   session's records the older the process is; the bank's forward filter
   at B = 1,500, M = 32 and the smoother's backward pass over its output
   beside them;
7. where a served frame's time goes, for detection on the card and on the
   host: each stage timed alone, then device busy time, kernels and copies
   per frame under ``torch.profiler``, and the idle share of each serving
   path;
8. only with ``--compare-with DIR``: the serving bank's SASS against
   DIR's, instruction for instruction (``check_serving_sass``, also
   callable alone), then phase 6's kernel times, and [4b]'s and [4c]'s
   serving (frames/s, kernels per frame), for the checkout in DIR and for
   this one, in four processes in turns (old, new, new, old) on the same
   card;
9. the calibration workflow through ``Engine.handle`` on the card:
   [9a] ``calculate-camera-pose`` from a 1,500-frame wand capture (0.3 px
   noise, 5% of the observations missing, 3% of the frames with a stray
   blob), held to the truth and to the port on the CPU fed the same RANSAC
   index tables; [9b] ``determine-scale``, ``acquire-floor`` and
   ``set-origin`` on the result, then the orbit tracked with those poses;
   [9c] ``refine-camera-pose`` over 60 served frames from perturbed poses;
   [9d] ``calibrate-intrinsics`` from rendered dot-grid frames; [9e]
   ``run-trajectory`` over ``LoopbackLink``;
10. rigid bodies and the rest of the Engine's events on the card: [10a]
   the body rig (16 blob slots, two templates with I = 3 body slots, the
   bank at M = 64) served per frame and in batches of 128, batched
   payloads bitwise equal to per-frame ones, the body stage against the
   CPU, the bank at M = 64 against its plain chain, fits and tracks
   against the truth, kernels a frame with and without bodies; [10b]
   ``learn-body-template`` with ``apply`` while rows are in flight; [10c]
   ``record-frames`` replayed through ``RecordedSource``; [10d]
   ``capture-profile`` while the capture loop serves; [10e]
   ``Engine(preprocess_frames=True)``: the blur + sharpen conv, then the
   detection kernel; [10d'] two ``capture-profile`` events in a row after
   the process's other profiler sessions, both traces listing the bank;
11. the large rig: 16 cameras (auto mode, the assoc matcher; the bank at
   M = 128) served per frame and in batches of 128, batched payloads
   bitwise equal to per-frame ones, tracked against the truth, the card
   against the CPU, the bank at M = 128 against its plain chain, and
   ``mode="beam"`` on one frame set, the card against the CPU;
12. offline processing of a 10 s recording (1,500 frame sets at 150
   frames/s): ``process_recording`` from frames (the detection kernel
   once a chunk) and from host-detected blobs, ``stream_recording``, and
   ``smooth=True``; the causal tracks bitwise equal across the three, the
   smoothed ATE below the causal one, both kernels against their plain
   versions on the offline inputs, the bank's forward-filter
   instantiation (the smoother's, one launch a call) and the smoother's
   backward kernels (two launches a call) too, with their event ms
   against their plain versions'; body sets streamed against one-shot;
13. ``batched_track_from_blobs`` over 8 rigs with their own calibrations,
   every rig's rows bitwise equal to its own ``track_from_blobs`` run;
14. the ``parallel/`` slice, every shard on the one card: [14a]
   ``Engine(mesh=make_mesh({"cam": d}, ...))`` for d = 2 and 4, per frame
   over [4]'s frames and in 2 batches of 128, rows bitwise equal to a
   single-device device-detect engine's, d detection launches a frame;
   [14b] the 16-camera ring at cam = 4 in 2 batches of 128, rows bitwise
   equal to the single-device engine's; [14c] ``dist_bundle_adjust`` and
   ``schur_bundle_adjust`` on [9a]'s wand observations on 1 and 4 point
   shards, and 4 on the CPU, costs within rtol 1e-3, ms an iteration;
   [14d] [12]'s recording at time = 4: ``process_sequence`` bitwise equal
   to the unsharded call, ``smooth_sharded`` within 1e-4 of
   ``smooth_reference`` away from the edges; [14e] ``run_cluster``: two
   gloo ranks on the card for live-pipeline, batched-sharded and schur,
   equal to each other and to one process, and one NCCL rank (the
   clusters in two waves, side by side within a wave);
15. the compiled steps (CUDA graphs) against the same steps op by op;
16. the camera-sharded steps and offline processing as graphs: [16a] the
   drone rig at cam = 2 and 4 on the one card per frame and batched, [16b]
   the 16-camera ring at cam = 4 batched, each graph engine against the
   same engine op by op on the same frames (rows bitwise equal, frames/s,
   busy ms and idle share, host launches a frame, capture ms and pool MiB
   a graph); [16c] ``process_recording`` (frames; host blobs with
   ``smooth``; body sets with ``smooth``) and ``stream_recording`` on
   [12]'s recordings against ``compiled.disable_graphs()``, then cold
   calls at a fresh length, captures included, not slower than eager
   (each timed call after a full collection, as ``GcPauses`` times).
17. the solvers' compiled programs as graphs, each against the same call
   under ``compiled.disable_graphs()``, outputs bitwise equal: [17a]
   [9a]'s event at a fresh point bucket, cold (no slower than eager,
   each event after a full collection) and warm, and a capture of another size in the bucket, which captures
   nothing; [17b] ``bundle_adjust`` (free and focals frozen),
   ``dist_bundle_adjust`` and ``schur_bundle_adjust`` on 1 shard and on
   4 shards of a mesh of "cuda" and "cuda:0" (the several-card layout),
   ``calibrate_intrinsics``; [17c] ``process_sequence`` and
   ``smooth_sharded`` on [14d]'s recording; [17d] the rts-assoc worker and
   the differential harness's tracking step; ms a call (first, second,
   warm, eager), captures, LM chunks and reads of done; [17e] the first
   and second ``calculate-camera-pose`` of a fresh process broken down
   by stage.

[9b] also sends ``acquire-floor`` with two points and with collinear
points: the installed matrix is finite and the CPU port's.

Every serving path serves with the matcher's observations (``with_obs``).
Before each serving path ([4]-[5], [9c], [9e], [10]-[14d], [17c]) the
kernels' launch counts are set to 0, and after it they are held to what
the path must launch; [14e]'s ranks count their own.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero; without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# tolerances of the kernel checks: both kernels perform the float32
# operations of their plain versions in the same order (no fused
# multiply-adds, integer moments), so they must agree bitwise
DETECT_ATOL = 0.0
BANK_ATOL = 0.0
# batched vs per-frame rows: the same kernels, but the geometry's batched
# float32 products may sum in another order at B=128 than at B=1
ROWS_ATOL = 1e-5
# tracked drone centre vs ground truth (m) after the filter settles: the
# default "pre" report (the predicted state) trails the 0.55 m/s orbit;
# on an H100 these frames gave 10.4 mm mean, 12.4 mm max
TRACK_MEAN_M, TRACK_MAX_M = 0.015, 0.025

# phase [2] also checks detection at this many sweeps, more than one pass
# of the kernel holds (69 with its 32-pixel tile)
LONG_CC_ITERS = 150
N_FRAMES = 200
WARM_FRAMES = 20     # frames left out of the steady-state frames/s
SETTLE_FRAMES = 60   # frames before the tracking error is held to bounds
BATCH = 128
BATCH_ROUNDS = 2     # batches the batched Engine serves in [4c]
SERVER_EVENTS = 100  # object-points events [4d] waits for
DEVICE = "cuda"
TIMING_RUNS = 20
BREAKDOWN_FRAMES = 30
# [9]: a 10 s wand capture at 150 frames/s, 5% of the observations
# missing, 3% of the frames with a stray blob; the other phases' sizes
WAND_FRAMES = 1500
WAND_DROP = 0.05
WAND_OUTLIERS = 0.03
SCALE_FRAMES = 200
FLOOR_POINTS = 60
ORBIT_FRAMES = 180
REFINE_FRAMES = 60
INTRINSICS_VIEWS = 8
TRAJ_SETPOINTS = 30
# the card against the CPU on the same wand capture and index tables: the
# tests' tolerance for the poses (relative rotations, unit translations)
CALIB_ATOL = 1e-3
# a degenerate floor's levelling matrix, card against CPU (cuSOLVER's SVD
# against LAPACK's)
FLOOR_ATOL = 1e-5
# [10]: two rigid-body templates (metres, body frame), the JAX package's
# tests/test_multi_template.py:19-22
BODY_TMPL_A = ((0.0, 0.0, 0.0), (0.12, 0.0, 0.0), (0.0, 0.09, 0.0),
               (0.05, 0.04, 0.07))
BODY_TMPL_B = ((0.0, 0.0, 0.0), (0.2, 0.0, 0.0), (0.1, 0.16, 0.0),
               (0.02, 0.05, 0.11))
BODY_FRAMES = 60       # [10a] per-frame frames; then BODY_BATCHES batches
BODY_BATCHES = 2
BODY_CPU_FRAMES = 10   # [10a] frames whose body stage the CPU repeats
LEARN_FRAMES = 90      # [10b] frames learned from, then tracked
LEARNED_FRAMES = 30
RECORD_FRAMES = 40     # [10c]
PROFILE_MS = 1500      # [10d]
PROFILE_AGAIN_MS = 750  # [10d'], two events
PREPROCESS_FRAMES = 90  # [10e]: SETTLE_FRAMES, then 30 held to [4]'s bounds
# fits and tracks against the truth.  Prop A spans 9-12 cm, about 10 px in
# a camera 2.7 m away, so on most frames some of its blobs come close
# enough to another in one camera to touch at the threshold, and the
# merged centroid moves the marker's point by millimetres (10 mm and 10
# degrees at worst on an H100 and on the CPU alike).  The mean over
# the samples whose markers are all CLEAR_PX apart in every camera is held
# to the JAX test's 5 mm (its atol) and 1 degree; every sample to 15 mm
# and 15 degrees
CLEAR_PX = 4.0
FIT_MEAN_MM, FIT_MEAN_DEG = 5.0, 1.0
FIT_MAX_MM, FIT_MAX_DEG = 15.0, 15.0
# the body stage on the card against the CPU: the tests' tolerance for
# rotation entries (positions agree closer)
BODY_CPU_ATOL = 1e-4
LEARN_ATOL_M = 2e-3       # learned pairwise distances against the template
LEARNED_MARKER_M = 5e-3   # markers of the learned body, tracked, vs truth
CONV_ATOL = 1e-5          # the preprocessing conv, card against CPU
# [11] the large rig: 16 cameras (auto mode: the assoc matcher; the bank at
# M = 128), per frame and in LARGE_BATCHES batches of BATCH
LARGE_CAMERAS = 16
LARGE_FRAMES = 120
LARGE_BATCHES = 2
LARGE_CPU_FRAMES = 6       # frames the CPU port repeats on the same blobs
LARGE_CPU_ATOL = 1e-4      # its floats against the card's
# both drones tracked in this share of the settled frames: a drone's LEDs
# merge into one blob in some of the 16 views, and on about one frame in
# ten the assoc matcher then loses a marker (the port on the CPU, as the
# JAX package's matcher does on the same blobs)
LARGE_SEEN = 0.8
# [12] offline: a 10 s recording at 150 frames/s of the drone rig
OFFLINE_FRAMES = 1500
OFFLINE_FPS = 150.0
OFFLINE_CHUNK = 32
OFFLINE_BLOCK = 64
BODY_STREAM_FRAMES = 300   # [10a]'s body scene, streamed with body sets
# [13] R copies of the drone rig with their own calibrations
MULTIRIG = 8
MULTIRIG_FRAMES = 30
MESH_SHARDS = (2, 4)       # [14a] cam shards of the drone rig, all on the card
MESH_PROFILE_FRAMES = 30   # [14a] frames served under torch.profiler
BA_SHARDS = 4              # [14c] point shards
BA_RTOL = 1e-3             # [14c] costs: 1 vs 4 shards (JAX's own tolerance)
BA_CPU_RTOL = 1e-5         # [14c] costs: 4 shards, the card vs the CPU
BA_ITERS = 15              # [14c] LM steps, every run (ftol 0: no early stop)
SMOOTH_HALO = 32           # [14d]
SMOOTH_EDGE = 40           # [14d] frames at each end not held to SMOOTH_ATOL
SMOOTH_ATOL = 1e-4
TIME_SHARDS = 4            # [14d]
CLUSTER_TIMEOUT_S = 300    # [14e] each run_cluster call
COMPILED_FRAMES = 200      # [15] frames of each per-frame kind, every rig
MESH_GRAPH_FRAMES = 100    # [16a] per-frame frames after the first 20
OFFLINE_COLD = 1487        # [16c] a recording length no call has had
SOLVER_FRESH_N = 1487      # [17a] a second wand capture, [9a]'s bucket
DIFF_FRAMES = 120          # [17d] frame sets through the tracking step
COMPILED_BATCHES = 2       # [15] batches of BATCH, the first one a warm-up
OVERFLOW_EVERY = 10        # [15] every 10th device-detect frame is lit past
#                            the sparse budget: the packed step serves it
OVERFLOW_PX = 60           # [15] ... by a 60x60 lit square in camera 0
CAL_FRAMES = 20            # [15] frames on the true, perturbed, true poses
PIPE_FRAMES = 30           # [15] MocapPipeline.step frames
HOST_LAUNCHES_MAX = 4      # [15] kernel and graph launches a graphed frame
LAUNCH_FRAMES = 10         # [15] graphed frames profiled for them
# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W): device memory
# 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, used for both
# kernels' scalar work (float32 in the bank, int32 min/select in detection)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


class GcPauses:
    """A full collection, then the sum of the collector's pauses (ms)
    inside the block.  The script keeps every run's payloads; without the
    collection first, a full pause over all of them lands in whichever
    timed run happens to cross the collector's threshold."""

    def __enter__(self):
        gc.collect()
        self.ms = 0.0
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, runs=TIMING_RUNS):
    """Median over ``runs`` of one call's device time (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_build():
    from low_cost_mocap_tpu_torch.control import bindings
    from low_cost_mocap_tpu_torch.ops import native

    t0 = time.perf_counter()
    names = ("detect_blobs", "kalman_bank")
    # nvcc for each kernel and g++ for the host library, all at once
    pending = {n: native.start_build(n) for n in names}
    host = bindings.start_build()
    for n in names:
        native.finish_build(n, pending[n])
        native.load(n)
    bindings.finish_build(host)
    bindings.get_lib()
    print(f"[1] built {', '.join(names)} and the host library "
          f"{bindings.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")
    for n in names:
        for line in native.build_log(n).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {n}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def smoke_frames(rig, Rs, ts, cc_iters):
    """4x320x320 float frames: two drones, threshold-edge pixels 50-52/255
    and a lit line longer than cc_iters; camera 3 is dark."""
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    f = src.read_at(0.25).astype(np.float32) * np.float32(1.0 / 255.0)
    u8 = np.float32(1.0 / 255.0)
    for i, v in enumerate((50, 51, 52)):
        f[0, 12, 20 + 5 * i] = np.float32(v) * u8
        f[1, 300, 40 + 5 * i] = np.float32(v) * u8
    f[2, 310, 10:10 + 3 * cc_iters] = 1.0
    f[3] = 0.0
    return f


def phase_detect(cfg, frames_np):
    import torch

    from low_cost_mocap_tpu_torch.ops import detect, detect_cuda

    frames = torch.from_numpy(frames_np).to(DEVICE)
    err = 0.0
    # the main path's cc_iters, then more sweeps than one pass holds
    for cc in (cfg.cc_iters, LONG_CC_ITERS):
        args = (cfg.detect_threshold, cfg.max_blobs, cc)
        c1, v1, s1 = detect_cuda.find_blobs(frames, *args)
        c2, v2, s2 = detect.find_blobs_multi(frames, *args)
        torch.cuda.synchronize()
        check(torch.equal(v1, v2), f"detect_blobs cc_iters={cc}: valid "
              "differs from plain")
        check(torch.equal(s1, s2), f"detect_blobs cc_iters={cc}: size "
              "differs from plain")
        err = max(err, max_err(c1, c2), max_err(s1, s2))
        check(err <= DETECT_ATOL, f"detect_blobs cc_iters={cc}: centroid "
              f"error {err}")
        # at 24 sweeps the 72-pixel line splits into more than 8 blobs
        check((bool(v1[2].all()) or cc != cfg.cc_iters)
              and not bool(v1[3].any()),
              "detect_blobs: long line / dark camera not as expected")
        print(f"[2] detect_blobs == plain on 4x320x320 at cc_iters {cc} "
              f"(valid per camera {v1.sum(1).tolist()}), max_abs_err {err}")
    return err


def phase_host_detect(cfg, frames_np):
    """[2b] The native host detector on phase [2]'s frames (as the uint8
    frames they were made from) against the ``detect_blobs`` kernel.  The
    host finds exact connected components; the kernel's sweeps stop at
    cc_iters, so they agree everywhere at 150 sweeps, and at 24 on every
    camera but the one with the 72-pixel line."""
    import torch

    from low_cost_mocap_tpu_torch.control import bindings
    from low_cost_mocap_tpu_torch.ops import detect, detect_cuda

    u8 = np.rint(frames_np * 255.0).astype(np.uint8)
    check(np.array_equal(u8.astype(np.float32) * np.float32(1.0 / 255.0),
                         frames_np), "smoke frames are not uint8 / 255")
    cutoff = detect.threshold_cutoff(cfg.detect_threshold)
    hc, hv, hs = bindings.ingest_detect(u8, cutoff, cfg.max_blobs)
    packed = bindings.ingest_detect_packed(u8, cutoff, cfg.max_blobs)
    check(np.array_equal(packed[..., :2], hc)
          and np.array_equal(packed[..., 2] > 0.5, hv),
          "ingest_detect_packed differs from ingest_detect")
    frames = torch.from_numpy(frames_np).to(DEVICE)
    for cc, cams in ((LONG_CC_ITERS, [0, 1, 2, 3]),
                     (cfg.cc_iters, [0, 1, 3])):
        kc, kv, ks = (t.cpu().numpy() for t in detect_cuda.find_blobs(
            frames, cfg.detect_threshold, cfg.max_blobs, cc))
        for name, a, b in (("valid", hv, kv), ("centroids", hc, kc),
                           ("sizes", hs, ks)):
            check(np.array_equal(a[cams], b[cams]),
                  f"host detection {name} differs from detect_blobs at "
                  f"cc_iters {cc} on cameras {cams}")
    print(f"[2b] host detection == detect_blobs (centroids, validity, "
          f"sizes bitwise) at cc_iters {LONG_CC_ITERS} on all cameras and "
          f"at {cfg.cc_iters} on cameras 0, 1, 3; valid per camera "
          f"{hv.sum(1).tolist()}")


def bank_case(B, M=32, O=2, seed=0):
    """Random candidates with dropouts, duplicated (tied) candidates and a
    frame gap above gap_reset_s."""
    rng = np.random.default_rng(seed)
    cp = rng.normal(0, 0.4, (B, M, 3)).astype(np.float32)
    cp[:, M // 2:] = cp[:, :M - M // 2]              # association ties
    ch = rng.normal(0, 1, (B, M)).astype(np.float32)
    ci = rng.integers(0, O, (B, M)).astype(np.int32)
    cv = rng.random((B, M)) < 0.3
    cv[B // 4:B // 4 + 8][ci[B // 4:B // 4 + 8] == 0] = False   # dropout
    dts = np.full((B,), 1 / 60, np.float32)
    dts[B // 2] = 0.7                                # trips gap_reset_s
    return cp, ch, ci, cv, dts


def phase_bank():
    import torch

    from low_cost_mocap_tpu_torch.ops import kalman, kalman_cuda

    worst = 0.0
    for B, start in ((BATCH, 0), (1, 0), (1, 40)):
        case = [torch.from_numpy(a).to(DEVICE)
                for a in bank_case(max(B, 64))]
        st = kalman.init_state(2, device=DEVICE)
        if start:   # a mid-track state for the B=1 check
            st, _ = kalman.update_scan(st, *(a[:start] for a in case))
        ins = [a[start:start + B] for a in case]
        st1, tr1 = kalman_cuda.kalman_scan(st, *ins)
        st2, tr2 = kalman.update_scan(st, *ins)
        torch.cuda.synchronize()
        check(torch.equal(tr1.valid, tr2.valid), f"kalman_bank B={B}: valid")
        check(torch.equal(st1.initialized, st2.initialized),
              f"kalman_bank B={B}: initialized")
        err = max(max_err(a, b) for a, b in zip(
            (*tr1[:3], *st1), (*tr2[:3], *st2)))
        check(err <= BANK_ATOL, f"kalman_bank B={B}: max_abs_err {err}")
        worst = max(worst, err)
        print(f"[3] kalman_bank == plain chain at B={B} (from step {start}), "
              f"max_abs_err {err}")
    # device times before the process has served or traced anything: a
    # profiler session later in a long process can lose kernel records
    # ([6], PERF.md)
    case = [torch.from_numpy(a).to(DEVICE) for a in bank_case(BATCH)]
    st = kalman.init_state(2, device=DEVICE)
    dev = [device_ms(lambda: kalman_cuda.kalman_scan(
        st, *(a[:B] for a in case)), "kalman_bank")[0] for B in (BATCH, 1)]
    print(f"[3] kalman_bank device time before any serving "
          f"(torch.profiler, {TIMING_RUNS} calls): B={BATCH} {dev[0]:.4f} "
          f"ms, B=1 {dev[1]:.4f} ms")
    return worst


def phase_serve(rig, cfg, Rs, ts):
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    frames = [src.read_at(i / 60) for i in range(N_FRAMES)]
    eng, payloads = device_detect_engine(rig, cfg, Rs, ts, src)
    with GcPauses():
        outs, stamps = [], [time.perf_counter()]
        for f in frames:   # each call ends in a device->host readback
            outs.append(eng.process_frame(f, 1 / 60))
            stamps.append(time.perf_counter())
    check(len(payloads) == N_FRAMES, "object-points not emitted per frame")

    errs, seen = payload_track_errors(src, payloads)
    n_late = N_FRAMES - SETTLE_FRAMES
    check(seen >= 0.95 * n_late,
          f"both drones tracked in only {seen}/{n_late} settled frames")
    check(errs.mean() < TRACK_MEAN_M and errs.max() < TRACK_MAX_M,
          f"tracking error mean {errs.mean():.4f} max {errs.max():.4f} m")
    check(all(np.isfinite(o.object_points).all() for o in outs),
          "non-finite object points")
    fps = (N_FRAMES - WARM_FRAMES) / (stamps[-1] - stamps[WARM_FRAMES])
    fps_all = N_FRAMES / (stamps[-1] - stamps[0])
    print(f"[4] served {N_FRAMES} frames through Engine(host_detect=False)"
          f".process_frame: "
          f"{fps:.1f} frames/s after the first {WARM_FRAMES} "
          f"({fps_all:.1f} with them); both drones tracked in "
          f"{seen}/{n_late} settled frames, "
          f"error mean {errs.mean() * 1e3:.2f} mm max "
          f"{errs.max() * 1e3:.2f} mm; one launch of each kernel per frame")
    return eng, src, fps


def device_detect_engine(rig, cfg, Rs, ts, src):
    """[4]'s engine: detection on the card (sparse ingest and the
    detect_blobs kernel), tracking, its object-points payloads collected."""
    from low_cost_mocap_tpu_torch.runtime.engine import Engine
    from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink

    eng = Engine(rig, cfg, src, CollectingLink(), host_detect=False,
                 device=DEVICE)
    eng.set_camera_poses(Rs, ts)
    eng.is_capturing_points = True
    eng.is_triangulating_points = True
    eng.is_locating_objects = True
    payloads = []
    eng.on("object-points", payloads.append)
    return eng, payloads


def start_tracking(eng, Rs, ts):
    """The reference client's way in: triangulate-points, locate-objects."""
    from low_cost_mocap_tpu_torch.runtime.engine import \
        camera_poses_to_serializable

    eng.handle("triangulate-points", {
        "startOrStop": "start",
        "cameraPoses": camera_poses_to_serializable(Rs, ts)})
    eng.handle("locate-objects", {"startOrStop": "start"})


def serving_engine(rig, cfg, Rs, ts, src, **kw):
    """A CUDA engine, tracking, with its object-points payloads collected."""
    from low_cost_mocap_tpu_torch.runtime.engine import Engine
    from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink

    eng = Engine(rig, cfg, src, CollectingLink(), **{"device": DEVICE, **kw})
    payloads = []
    eng.on("object-points", payloads.append)
    start_tracking(eng, Rs, ts)
    return eng, payloads


def warm_up_batched(eng, frames, Rs, ts, payloads):
    """Serve one batch through a batched engine (its graphs' capture),
    then start tracking afresh, its payloads dropped: the timed batches
    that follow are steady-state."""
    for f in frames[:BATCH]:
        eng.process_frame(f, 1 / 60)
    eng.handle("triangulate-points", {"startOrStop": "stop"})
    start_tracking(eng, Rs, ts)
    payloads.clear()


def reset_launches():
    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman_cuda
    from low_cost_mocap_tpu_torch.runtime import compiled

    detect_cuda.launches = 0
    kalman_cuda.launches = 0
    compiled.replays = 0
    for k in compiled.warmup_launches:
        compiled.warmup_launches[k] = 0


def read_launches(path, want_detect, want_bank):
    """Hold a path's launches to what it must launch (``want_bank`` None:
    at least one); returns (detect, bank).  A compiled step's replays count
    the launches its graph holds; the launches of its warm-up calls (at its
    capture, on a scratch state) are printed and held apart."""
    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman_cuda
    from low_cost_mocap_tpu_torch.runtime import compiled

    warm = (compiled.warmup_launches[detect_cuda.NAME],
            compiled.warmup_launches[kalman_cuda.NAME])
    got = (detect_cuda.launches - warm[0], kalman_cuda.launches - warm[1])
    ok = got[0] == want_detect and (got[1] >= 1 if want_bank is None
                                    else got[1] == want_bank)
    check(ok, f"{path}: launches (detect_blobs, kalman_bank) = {got}, "
          f"want ({want_detect}, {want_bank or '>= 1'})")
    if any(warm):
        print(f"    {path}: {compiled.replays} graph replays; warm-up "
              f"launches before captures (detect_blobs, kalman_bank) "
              f"{warm}")
    return got


def payload_track_errors(src, payloads):
    """Tracking error (m) of each settled frame's filtered drones against
    the orbit's ground truth, and the frames with both drones tracked."""
    errs, seen = [], 0
    for i, p in enumerate(payloads[SETTLE_FRAMES:], start=SETTLE_FRAMES):
        gt = np.stack([src.drone_pose(d, i / 60)[0] for d in range(2)])
        gt_w = np.stack([-gt[:, 0], gt[:, 2], -gt[:, 1]], axis=1)
        pos = [np.asarray(o["pos"]) for o in p["filtered_objects"]]
        if len(pos) == 2:
            seen += 1
            check(np.linalg.norm(pos[0] - pos[1]) > 0.3,
                  f"frame {i}: both tracks on one drone")
        errs += [np.linalg.norm(gt_w - x, axis=1).min() for x in pos]
    return np.asarray(errs), seen


def compare_payloads(got, want, what):
    """object-points payloads: discrete fields (point counts, drone
    indices) equal, floats within ROWS_ATOL; returns the largest float
    difference."""
    check(len(got) == len(want), f"{what}: {len(got)} events, want "
          f"{len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        check(len(g["object_points"]) == len(w["object_points"])
              and [o["droneIndex"] for o in g["objects"]]
              == [o["droneIndex"] for o in w["objects"]]
              and [o["droneIndex"] for o in g["filtered_objects"]]
              == [o["droneIndex"] for o in w["filtered_objects"]],
              f"{what}: discrete fields differ")
        pairs = [(g["object_points"], w["object_points"]),
                 (g["errors"], w["errors"])]
        for key, fields in (("objects", ("pos", "heading", "error")),
                            ("filtered_objects", ("pos", "vel", "heading"))):
            for a, b in zip(g[key], w[key]):
                pairs += [(a[f], b[f]) for f in fields]
        for a, b in pairs:
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if a.size:
                worst = max(worst, float(np.abs(a - b).max()))
    check(worst <= ROWS_ATOL, f"{what}: max_abs_err {worst}")
    return worst


def stage_means(eng) -> str:
    """The engine's own StageTimer: mean ms of each stage over its window
    (the last 240 samples)."""
    return ", ".join(f"{k} {v['mean_ms']:.3f}"
                     for k, v in eng.timer.summary().items())


def phase_host_serve(rig, cfg, Rs, ts, src):
    """[4b] The default card engine (host detection) over the frames of
    [4], at readback depth 0 and 2 in turns (0, 2, 2, 0): every run's
    payloads bitwise equal, the bank kernel once per frame."""
    import dataclasses

    frames = [src.read_at(i / 60) for i in range(N_FRAMES)]
    runs = []
    for depth in (0, 2, 2, 0):
        eng, payloads = serving_engine(
            rig, dataclasses.replace(cfg, readback_pipeline_depth=depth),
            Rs, ts, src)
        check(eng._host_detect and eng._batch == 1,
              "the default card engine does not detect on the host")
        reset_launches()
        with GcPauses():
            stamps = [time.perf_counter()]
            for f in frames:
                eng.process_frame(f, 1 / 60)
                stamps.append(time.perf_counter())
            eng.flush_batches()
        read_launches(f"[4b] depth {depth}", 0, N_FRAMES)
        fps = (N_FRAMES - WARM_FRAMES) / (stamps[-1] - stamps[WARM_FRAMES])
        runs.append((depth, eng, payloads, fps))
    base = runs[0][2]
    for depth, _, payloads, _ in runs[1:]:
        check(payloads == base, f"[4b] depth {depth} payloads differ from "
              "depth 0")
    errs, seen = payload_track_errors(src, base)
    n_late = N_FRAMES - SETTLE_FRAMES
    check(seen >= 0.95 * n_late,
          f"[4b] both drones tracked in only {seen}/{n_late} frames")
    check(errs.mean() < TRACK_MEAN_M and errs.max() < TRACK_MAX_M,
          f"[4b] tracking error mean {errs.mean():.4f} max "
          f"{errs.max():.4f} m")
    fps = {d: float(np.mean([r[3] for r in runs if r[0] == d]))
           for d in (0, 2)}
    print(f"[4b] served {N_FRAMES} frames with host detection at readback "
          f"depth 0 and 2 (in turns 0, 2, 2, 0): "
          + ", ".join(f"{r[3]:.1f}" for r in runs)
          + f" frames/s after the first {WARM_FRAMES} (mean depth 0 "
          f"{fps[0]:.1f}, depth 2 {fps[2]:.1f}); all four runs' payloads "
          f"bitwise equal; both drones tracked in {seen}/{n_late} settled "
          f"frames, error mean {errs.mean() * 1e3:.2f} mm max "
          f"{errs.max() * 1e3:.2f} mm; kalman_bank once a frame, "
          "detect_blobs never")
    print(f"[4b] engine stages, last depth-0 run (mean ms a frame): "
          f"{stage_means(runs[-1][1])}")
    return runs[-1][1], fps


def phase_batched_engine(rig, cfg, Rs, ts, src):
    """[4c] The Engine at dispatch_batch = BATCH over BATCH_ROUNDS batches,
    inline and with the emit worker, against per-frame host-detect serving
    of the same frames.  Each batched engine first serves one batch to
    warm up, then starts tracking afresh; the timed frames/s covers host
    detection, dispatch, readback, decode and emits."""
    import dataclasses

    from low_cost_mocap_tpu_torch.utils.profiling import StageTimer

    n = BATCH_ROUNDS * BATCH
    frames = [src.read_at((N_FRAMES + BATCH + i) / 60) for i in range(n)]
    ref, ref_payloads = serving_engine(rig, cfg, Rs, ts, src)
    reset_launches()
    with GcPauses():
        t0 = time.perf_counter()
        for f in frames:
            ref.process_frame(f, 1 / 60)
        fps_ref = n / (time.perf_counter() - t0)
    read_launches("[4c] per-frame reference", 0, n)
    runs = {}
    for name, extra in (("inline", {}),
                        ("emit worker", dict(batch_emit_thread=True))):
        bcfg = dataclasses.replace(cfg, dispatch_batch=BATCH, **extra)
        eng, payloads = serving_engine(rig, bcfg, Rs, ts, src)
        warm_up_batched(eng, frames, Rs, ts, payloads)
        eng.timer = StageTimer()     # time the served batches only
        reset_launches()
        with GcPauses() as gcp:
            t0 = time.perf_counter()
            for f in frames:
                eng.process_frame(f, 1 / 60)
            eng.flush_batches()
            fps = n / (time.perf_counter() - t0)
        read_launches(f"[4c] batched {name}", 0, BATCH_ROUNDS)
        runs[name] = (eng, payloads, fps, gcp.ms)
    runs["emit worker"][0].stop()     # retires the worker thread
    check(runs["emit worker"][1] == runs["inline"][1],
          "[4c] emit-worker payloads differ from inline")
    worst = compare_payloads(runs["inline"][1], ref_payloads,
                             "[4c] batched vs per-frame")
    print(f"[4c] Engine(dispatch_batch={BATCH}) over {BATCH_ROUNDS} batches "
          f"({n} frames, host detection included): inline "
          f"{runs['inline'][2]:.1f} frames/s, emit worker "
          f"{runs['emit worker'][2]:.1f} frames/s, bitwise equal to each "
          f"other; against per-frame host-detect serving of the same "
          f"frames ({fps_ref:.1f} frames/s): discrete fields equal, "
          f"max_abs_err {worst}; kalman_bank once a batch")
    for name, run in runs.items():
        print(f"[4c] engine stages, {name} (mean ms; batch-ingest a frame, "
              f"the others a batch): {stage_means(run[0])}; the garbage "
              f"collector's pauses in the run {run[3]:.1f} ms")
    return runs["inline"][0], {k: v[2] for k, v in runs.items()}, fps_ref


class WsClient:
    """A minimal Socket.IO-over-WebSocket client (stdlib and the port's
    wsproto), as the reference console speaks it."""

    def __init__(self, host, port, timeout=10.0):
        import socket

        from low_cost_mocap_tpu_torch.runtime import wsproto

        self.wsproto = wsproto
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.parser = wsproto.FrameParser()
        self.packets = []
        key = "dGhlIHNhbXBsZSBub25jZQ=="
        self.sock.sendall(
            (f"GET /socket.io/?EIO=4&transport=websocket HTTP/1.1\r\n"
             f"Host: {host}:{port}\r\nUpgrade: websocket\r\n"
             f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
             f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += self.sock.recv(4096)
        head, rest = buf.split(b"\r\n\r\n", 1)
        check(b"101" in head.split(b"\r\n")[0], f"no websocket upgrade: "
              f"{head[:200]!r}")
        self._feed(rest)

    def _feed(self, data):
        self.packets += [p.decode() for op, p in self.parser.feed(data)
                         if op == 0x1]

    def pump(self, timeout):
        import socket

        self.sock.settimeout(timeout)
        try:
            data = self.sock.recv(1 << 20)
        except socket.timeout:
            return
        check(bool(data), "the server closed the websocket")
        self._feed(data)

    def wait_packet(self, pred, timeout=10.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for p in self.packets:
                if pred(p):
                    return p
            self.pump(max(deadline - time.time(), 0.05))
        fail(f"no matching packet; last: {self.packets[-3:]}")

    def send_text(self, text):
        self.sock.sendall(self.wsproto.encode_frame(text.encode(),
                                                    mask=True))

    def emit(self, event, data):
        self.send_text(self.wsproto.sio_event(event, data))

    def close(self):
        self.sock.close()


def phase_server(rig, cfg, Rs, ts):
    """[4d] MocapServer on a free localhost port over the default CUDA
    engine and its capture loop: a websocket client connects, starts
    triangulation and locating, and counts object-points events that carry
    filtered_objects."""
    from low_cost_mocap_tpu_torch.runtime.engine import (
        Engine, camera_poses_to_serializable)
    from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
    from low_cost_mocap_tpu_torch.runtime.server import MocapServer
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    eng = Engine(rig, cfg, src, CollectingLink(), device=DEVICE)
    srv = MocapServer(eng, port=0)
    errors = []
    eng.on("engine-error", errors.append)
    reset_launches()
    srv.start()
    client = None
    try:
        eng.start()
        client = WsClient("127.0.0.1", srv.port)
        client.wait_packet(lambda p: p.startswith("0{"))
        client.send_text("40")
        client.wait_packet(lambda p: p.startswith("40{"))
        client.emit("triangulate-points", {
            "startOrStop": "start",
            "cameraPoses": camera_poses_to_serializable(Rs, ts),
            "toWorldCoordsMatrix": np.eye(4).tolist()})
        client.emit("locate-objects", {"startOrStop": "start"})
        deadline = time.time() + 120
        tracked, first = 0, None
        while tracked < SERVER_EVENTS and time.time() < deadline:
            client.pump(1.0)
            while client.packets:
                evt = client.wsproto.parse_sio_event(client.packets.pop(0))
                if (evt is not None and evt[0] == "object-points"
                        and evt[1][0]["filtered_objects"]):
                    tracked += 1
                    first = first or time.perf_counter()
        rate = (tracked - 1) / max(time.perf_counter() - first, 1e-9) \
            if first else 0.0
    finally:
        eng.stop()
        srv.stop()
        if client is not None:
            client.close()
    check(not errors, f"[4d] engine errors: {errors[:3]}")
    check(tracked >= SERVER_EVENTS, f"[4d] only {tracked} object-points "
          f"events with filtered_objects (want {SERVER_EVENTS})")
    launches = read_launches("[4d] server", 0, None)
    print(f"[4d] MocapServer on 127.0.0.1:{srv.port} over the CUDA engine: "
          f"a websocket client received {tracked} object-points events "
          f"with filtered_objects at {rate:.1f} events/s (capture loop "
          f"target {cfg.target_fps:.0f} frames/s); kalman_bank "
          f"{launches[1]} launches, detect_blobs 0")
    return launches


def phase_launcher(Rs, ts):
    """[4e] ``python -m low_cost_mocap_tpu_torch.serve`` as a user starts
    it (its defaults: the card, host detection, a synthetic drone, the
    loopback link), on a free localhost port: a websocket client starts
    tracking and counts object-points events; the process is stopped."""
    import socket
    import tempfile

    from low_cost_mocap_tpu_torch.runtime.engine import \
        camera_poses_to_serializable

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "serve.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "low_cost_mocap_tpu_torch.serve",
                 "--port", str(port), "--artifacts-dir", tmp],
                cwd=here, stdout=log, stderr=subprocess.STDOUT)
        client = None
        try:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 120:
                check(proc.poll() is None, "the launcher exited:\n"
                      + open(log_path).read()[-3000:])
                try:
                    client = WsClient("127.0.0.1", port)
                    break
                except OSError:
                    time.sleep(0.5)
            check(client is not None, "the launcher never listened")
            t_up = time.perf_counter() - t0
            client.wait_packet(lambda p: p.startswith("0{"))
            client.send_text("40")
            client.wait_packet(lambda p: p.startswith("40{"))
            client.emit("triangulate-points", {
                "startOrStop": "start",
                "cameraPoses": camera_poses_to_serializable(Rs, ts)})
            client.emit("locate-objects", {"startOrStop": "start"})
            deadline = time.time() + 120
            tracked = 0
            while tracked < SERVER_EVENTS and time.time() < deadline:
                client.pump(1.0)
                while client.packets:
                    evt = client.wsproto.parse_sio_event(
                        client.packets.pop(0))
                    tracked += bool(evt is not None
                                    and evt[0] == "object-points"
                                    and evt[1][0]["filtered_objects"])
        finally:
            if client is not None:
                client.close()
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        out = open(log_path).read()
    check(tracked >= SERVER_EVENTS, f"[4e] only {tracked} object-points "
          f"events from the launcher:\n{out[-3000:]}")
    check("device=cuda" in out, f"[4e] the launcher did not run on the "
          f"card:\n{out[-3000:]}")
    print(f"[4e] python -m low_cost_mocap_tpu_torch.serve listened after "
          f"{t_up:.1f} s ({out.strip().splitlines()[0]}); a websocket "
          f"client received {tracked} object-points events with "
          "filtered_objects; the process was stopped")


def phase_batched(rig, cfg, Rs, ts, src):
    import torch

    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import camera, correspond, detect_cuda
    from low_cost_mocap_tpu_torch.ops import kalman

    dev = torch.device(DEVICE)
    K = torch.as_tensor(rig.K_stack(), device=dev)
    dist = torch.as_tensor(rig.dist_stack(), device=dev)
    Ps = camera.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                  torch.as_tensor(ts, device=dev))
    Fs = correspond._pairwise_fundamentals(Ps)
    M = torch.eye(4, device=dev)
    cal = (Ps, K, dist, M, Fs)
    tail = dict(gate_px=cfg.epipolar_gate_px,
                max_candidates=cfg.max_candidates_per_cam,
                marker_dist1=rig.marker_dist_short,
                marker_dist2=rig.marker_dist_long,
                marker_tol=rig.marker_dist_tol,
                marker_side_min=rig.marker_side_min, with_obs=True)
    blobs, valid = [], []
    for i in range(BATCH):
        f = torch.from_numpy(src.read_at((N_FRAMES + i) / 60)).to(dev)
        b, v, _ = detect_cuda.find_blobs(
            f.to(torch.float32) * (1.0 / 255.0), cfg.detect_threshold,
            cfg.max_blobs, cfg.cc_iters)
        blobs.append(b)
        valid.append(v)
    blobs, valid = torch.stack(blobs), torch.stack(valid)
    dts = torch.full((BATCH,), 1 / 60, device=dev)

    st0 = kalman.init_state(rig.num_objects, device=dev)
    _, rows = pipeline.scan_track_from_blobs(st0, blobs, valid, dts, *cal,
                                             **tail)
    rows_np = rows.cpu().numpy()
    st = st0
    per = []
    for i in range(BATCH):
        st, out = pipeline.track_from_blobs(st, blobs[i], valid[i], dts[i],
                                            *cal, **tail)
        per.append(pipeline.pack_outputs(out).cpu().numpy())

    C, Kb, O = rig.num_cameras, cfg.max_blobs, rig.num_objects
    worst = 0.0
    layout = (C, Kb, O, True)
    for g, w in zip(pipeline.unpack_outputs_batch(rows_np, *layout),
                    pipeline.unpack_outputs_batch(np.stack(per), *layout)):
        for a, b in ((g.blob_valid, w.blob_valid),
                     (g.point_valid, w.point_valid),
                     (g.point_obs_mask, w.point_obs_mask),
                     (g.point_obs, w.point_obs),
                     (g.objects.valid, w.objects.valid),
                     (g.objects.index, w.objects.index),
                     (g.tracked.valid, w.tracked.valid)):
            check(np.array_equal(a, b), "batched vs per-frame: discrete "
                  "fields differ")
        for a, b in ((g.blob_px, w.blob_px),
                     (g.object_points, w.object_points),
                     (g.point_errors, w.point_errors),
                     *zip(g.objects, w.objects), *zip(g.tracked, w.tracked)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            fin = np.isfinite(a) | np.isfinite(b)
            check(np.array_equal(np.isfinite(a), np.isfinite(b)),
                  "batched vs per-frame: finiteness differs")
            if fin.any():
                worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
    check(worst <= ROWS_ATOL, f"batched vs per-frame max_abs_err {worst}")
    check(bool(np.stack([o.tracked.valid for o in
                         pipeline.unpack_outputs_batch(rows_np, *layout)])
               [BATCH // 2:].all()), "batched tail lost a drone")
    print(f"[5] scan_track_from_blobs B={BATCH} == {BATCH} per-frame "
          f"track_from_blobs rows (observations bitwise), max_abs_err "
          f"{worst}")
    return blobs, valid, dts, cal, tail


def wall_median(fn, runs=5):
    """Median host wall time (s) of ``fn``, which ends in a readback."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def detect_bound(frames, cfg):
    """Least time for these frames: each lit pixel takes a 9-way min and a
    select for every sweep that still changes some label of its camera (the
    kernel skips dark tiles and stops at the fixed point), against reading
    the float32 frames once and writing the outputs (bytes).  Returns
    (ms, "operations" or "bytes", sweeps needed per camera)."""
    import torch

    from low_cost_mocap_tpu_torch.ops import detect

    C, H, W = frames.shape
    mask = frames > cfg.detect_threshold
    big = H * W
    idx = torch.arange(big, dtype=torch.int32, device=frames.device)
    big_t = torch.tensor(big, dtype=torch.int32, device=frames.device)
    labels = torch.where(mask, idx.reshape(H, W), big_t)
    sweeps = torch.zeros(C, dtype=torch.int64, device=frames.device)
    for _ in range(cfg.cc_iters):
        nxt = torch.where(mask, detect._min_label_step(labels, big), big_t)
        sweeps += (nxt != labels).flatten(1).any(1)
        labels = nxt
    sweeps = sweeps.cpu()
    lit = mask.flatten(1).sum(1).cpu()
    ops = int((lit * sweeps).sum()) * 9
    nbytes = C * H * W * 4 + C * cfg.max_blobs * (2 * 4 + 1 + 4)
    t_ops, t_bytes = ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", sweeps.tolist())


def bank_bound(case_valid, case_index, B, M, O):
    """Least time of B bank steps: each object-step with a detection does
    ~1,900 float32 operations (predict 0.4k, six scalar updates 1.1k,
    filters, velocity), plus 8 per (object, candidate) for the
    association; bytes are the candidates, dts, state in/out and outputs
    once."""
    import torch

    ids = torch.arange(O, device=case_index.device)
    mine = case_valid[:, None, :] & (case_index[:, None, :] == ids[:, None])
    n_upd = int(mine.any(-1).sum())
    ops = n_upd * 1900 + B * O * M * 8
    nbytes = (B * M * (3 * 4 + 4 + 4 + 1) + B * 4 + 2 * 6 * 4
              + 2 * O * (9 + 81 + 1 + 3 + 5 + 15 + 1) * 4
              + B * O * (3 + 3 + 1) * 4 + B * O)
    t_ops, t_bytes = ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def backward_bound(T, O):
    """Least time of the smoother's backward pass over T frames of O
    objects: bytes are the filtered means and covariances and dts read
    once and the smoothed ones written once (the gains' scratch is the
    kernels' own); each object-step does ~5,000 float32 operations (the
    9x9 LU and nine solves ~2,000, the sweep's two 9x9 products ~3,000)."""
    nbytes = 2 * T * O * (9 + 81) * 4 + T * 4
    t_ops, t_bytes = (T - 1) * O * 5000 / PEAK_OPS_S, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def device_ms(fn, kernel, runs=TIMING_RUNS):
    """Device time of one call of ``fn`` under ``torch.profiler``: every
    kernel, memset and copy it puts on the card, summed over ``runs``
    calls and divided by ``runs``.  Returns (ms, {name: ms per call}).

    ``fn`` launches the kernel whose name holds ``kernel`` once a call: a
    session without a record of each of those launches fails.  The
    profiler keeps fewer of a short session's kernel records the older the
    process is, threads or no threads (an idle process keeps none after
    about 80 s), so ``kernel_times`` runs in a process of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    got = sum(e.count for e in dev if kernel in e.key)
    check(got == runs, f"torch.profiler recorded {got} of the {runs} "
          f"launches of {kernel}: the session lost kernel records")
    per = {e.key[:60]: e.self_device_time_total / 1e3 / runs for e in dev}
    return sum(per.values()), per


def kernel_times(frames, args, cands, num_objects):
    """Event-window ms (``cuda_ms``) and device ms (``device_ms``) of the
    two kernels' wrappers at the main path's shapes: detection on
    ``frames``, the bank on ``cands`` at B = len(cands[0]) and at B = 1,
    and, in a checkout that has them, the bank's forward filter over
    ``bank_case(OFFLINE_FRAMES)`` (M = 32) and the backward pass over its
    output, as the smoother runs them on a recording.  The profiler
    sessions come first, while the process is young."""
    import torch

    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman, kalman_cuda

    st = kalman.init_state(num_objects, device=DEVICE)
    one = tuple(c[:1] for c in cands)
    calls = {"detect_blobs": (lambda: detect_cuda.find_blobs(frames, *args),
                              "propagate_kernel"),
             f"kalman_bank B={len(cands[0])}": (
                 lambda: kalman_cuda.kalman_scan(st, *cands), "kalman_bank"),
             "kalman_bank B=1": (lambda: kalman_cuda.kalman_scan(st, *one),
                                 "kalman_bank")}
    if hasattr(kalman_cuda, "forward_scan"):
        rec = [torch.from_numpy(a).to(DEVICE)
               for a in bank_case(OFFLINE_FRAMES)]
        st2 = kalman.init_state(2, device=DEVICE)
        calls[f"kalman_bank forward B={OFFLINE_FRAMES}"] = (
            lambda: kalman_cuda.forward_scan(st2, *rec), "kalman_bank")
    if hasattr(kalman_cuda, "backward_scan"):
        _, ((_, xs, Ps), _) = kalman_cuda.forward_scan(st2, *rec)
        calls[f"kalman_bank backward T={OFFLINE_FRAMES}"] = (
            lambda: kalman_cuda.backward_scan(xs, Ps, rec[4]),
            "kalman_bank_rts_sweep")
    dev = {name: device_ms(fn, kernel)
           for name, (fn, kernel) in calls.items()}
    return {name: {"ms": cuda_ms(fn), "device_ms": dev[name][0],
                   "device": dev[name][1]}
            for name, (fn, _) in calls.items()}


def timing_process(root, frames, args, cands, num_objects, rates=False):
    """``kernel_times`` (and with ``rates`` ``serve_rates``) of the checkout
    at ``root`` in a process of its own, on these inputs: the parsed
    ``TIMES`` line."""
    import tempfile

    import torch

    script = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save({"frames": frames.cpu(), "args": list(args),
                    "cands": [c.cpu() for c in cands], "O": num_objects,
                    "rates": rates}, path)
        code = (f"import runpy, sys; sys.argv = [{script!r}, "
                f"'--time-kernels', {path!r}]; "
                f"runpy.run_path({script!r}, run_name='__main__')")
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0,
          f"timing run in {root} failed:\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("TIMES ")][-1]
    res = json.loads(line[len("TIMES "):])
    check(res["package"].startswith(os.path.abspath(root)),
          f"timing run in {root} imported {res['package']}")
    return res


def print_kernel_times(tag, times):
    for name, t in times.items():
        print(f"{tag} {name}: {t['ms']:.4f} ms event window, "
              f"{t['device_ms']:.4f} ms on the device ("
              + ", ".join(f"{k} {v:.4f}" for k, v in t["device"].items())
              + ")")


def phase_times(rig, cfg, frames_np, batch, launches, errs):
    import torch

    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import detect, kalman

    frames = torch.from_numpy(frames_np).to(DEVICE)
    args = (cfg.detect_threshold, cfg.max_blobs, cfg.cc_iters)
    det_plain = cuda_ms(lambda: detect.find_blobs_multi(frames, *args))
    det_bound, det_by, sweeps = detect_bound(frames, cfg)

    # the bank on the main path's batch: candidates the geometry located
    blobs, valid, dts, cal, tail = batch
    geo = pipeline._locate_frame(blobs, valid, *cal, **tail)
    loc = geo[3]
    st = kalman.init_state(rig.num_objects, device=DEVICE)
    cands = (loc.pos, loc.heading, loc.index, loc.valid, dts)
    # in a young process: this one's profiler loses short sessions' records
    # (with no thread but this one alive: the engines have stopped theirs)
    print(f"[6] threads alive: {sorted(t.name for t in threading.enumerate())}")
    t0 = time.perf_counter()
    times = timing_process(os.path.dirname(os.path.abspath(__file__)),
                           frames, args, cands, rig.num_objects)["times"]
    print(f"[6] kernel times in a process of their own "
          f"({time.perf_counter() - t0:.1f} s)")
    B, M = loc.valid.shape
    det_ms = times["detect_blobs"]["ms"]
    bank_ms = times[f"kalman_bank B={B}"]["ms"]
    bank1_ms = times["kalman_bank B=1"]["ms"]
    bank_plain = cuda_ms(lambda: kalman.update_scan(st, *cands))
    one = tuple(c[:1] for c in cands)
    bank1_plain = cuda_ms(lambda: kalman.update_scan(st, *one))
    bank_b, bank_by = bank_bound(loc.valid, loc.index, B, M,
                                 rig.num_objects)
    bank1_b, bank1_by = bank_bound(loc.valid[:1], loc.index[:1], 1, M,
                                   rig.num_objects)
    # the batched tail end to end (geometry + bank + packing + readback)
    # against the same frames served one track_from_blobs call at a time
    def tail_batched():
        pipeline.scan_track_from_blobs(st, blobs, valid, dts, *cal,
                                       **tail)[1].cpu()

    def tail_per_frame():
        s = st
        for i in range(B):
            s, out = pipeline.track_from_blobs(s, blobs[i], valid[i], dts[i],
                                               *cal, **tail)
            pipeline.pack_outputs(out).cpu()

    fps_b = B / wall_median(tail_batched)
    fps_p = B / wall_median(tail_per_frame, runs=1)
    print(f"[6] batched tail (blobs on the device) {fps_b:.1f} frames/s at "
          f"B={B}; per-frame track_from_blobs {fps_p:.1f} frames/s")
    print_kernel_times("[6]", times)
    print(f"[6] detect_blobs {det_ms:.4f} ms (plain {det_plain:.4f} ms, "
          f"bound {det_bound:.6f} ms by {det_by}; sweeps that change a "
          f"label, per camera: {sweeps}); kalman_bank B={B} {bank_ms:.4f} "
          f"ms (plain {bank_plain:.4f} ms, bound {bank_b:.3e} ms by "
          f"{bank_by}), B=1 {bank1_ms:.4f} ms (plain {bank1_plain:.4f} ms, "
          f"bound {bank1_b:.3e} ms by {bank1_by})")
    return frames, args, cands, {"kernels": [
        {"name": "detect_blobs", "route": "cuda",
         "source": "low_cost_mocap_tpu_torch/csrc/detect_blobs.cu",
         "replaces": "low_cost_mocap_tpu/ops/detect_pallas.py:112",
         "launches": launches[0], "max_abs_err": errs[0], "ms": det_ms,
         "plain_ms": det_plain, "bound_ms": det_bound, "bound_by": det_by,
         "library_ms": None},
        {"name": "kalman_bank", "route": "cuda",
         "source": "low_cost_mocap_tpu_torch/csrc/kalman_bank.cu",
         "replaces": "low_cost_mocap_tpu/ops/kalman_pallas.py:239",
         "launches": launches[1], "max_abs_err": errs[1], "ms": bank_ms,
         "plain_ms": bank_plain, "bound_ms": bank_b, "bound_by": bank_by,
         "library_ms": None},
    ]}


# the host's launch calls, as the profiler names them
KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCH_APIS = ("cudaGraphLaunch", "cuGraphLaunch")


def profile_frames(run, n):
    """Device work of ``run`` (which serves ``n`` frames) under
    ``torch.profiler``: (busy ms, kernels, host<->device copies) per frame,
    the device events, and the host's kernel launches and graph launches
    per frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_ev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_ev) / 1e3 / n
    kernels = sum(e.count for e in dev_ev if "emcpy" not in e.key
                  and "emset" not in e.key) / n
    copies = sum(e.count for e in dev_ev if "emcpy" in e.key) / n
    host = tuple(sum(e.count for e in events if e.key in apis) / n
                 for apis in (KERNEL_LAUNCH_APIS, GRAPH_LAUNCH_APIS))
    return busy_ms, kernels, copies, dev_ev, host


def print_profile(tag, prof, wall_ms, n, top=8):
    busy_ms, kernels, copies, dev_ev, host = prof
    idle = 1 - busy_ms / wall_ms
    print(f"{tag} device busy {busy_ms:.3f} ms per frame against "
          f"{wall_ms:.3f} ms per frame unprofiled (idle share {idle:.3f}); "
          f"{kernels:.1f} kernels and {copies:.1f} host<->device copies per "
          f"frame; the host launched {host[0]:.1f} kernels and {host[1]:.1f} "
          "graphs per frame")
    for e in sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/frame "
              f"{e.count / n:6.1f}x  {e.key[:90]}")
    return idle


def phase_breakdown(eng, src, fps, eng_hd, fps_hd, eng_b, fps_b):
    """Where a served frame's time goes, on frames after the main path's.

    For detection on the card (the [4] engine, sparse ingest) and on the
    host (the [4b] engine): each stage on the host clock with a
    synchronise after it (median over BREAKDOWN_FRAMES).  Then the same
    frames through ``process_frame`` under ``torch.profiler``: device busy
    time, kernels and host<->device copies per frame, and the busiest
    kernels; and one batch of the [4c] batched engine.  Each idle share is
    taken against that path's unprofiled time per frame."""
    import torch

    from low_cost_mocap_tpu_torch.control import bindings
    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import (camera, correspond, detect,
                                              detect_cuda, rigid, world)

    dev, cfg, rig, kw = eng.device, eng.cfg, eng.rig, eng._step_kw
    C, K, O = rig.num_cameras, cfg.max_blobs, rig.num_objects
    shape = (C, *rig.image_hw())
    frames = [src.read_at((N_FRAMES + BATCH + i) / 60)
              for i in range(BREAKDOWN_FRAMES)]
    times: dict[str, list] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def report(tag):
        med = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
        print(f"{tag} per-frame stages, synchronised, median of "
              f"{BREAKDOWN_FRAMES} frames (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
              + f"; sum {sum(med.values()):.3f}")
        times.clear()

    state = eng._kalman_state
    dts = torch.full((1,), 1 / 60, device=dev)
    for f in frames:
        idx, _, _ = timed("host sparse ingest", lambda: detect.sparse_ingest(
            f, cfg.detect_threshold, cfg.sparse_budget))
        up = timed("upload", lambda: torch.from_numpy(idx).to(dev))
        blobs, bv, _ = timed("detect (scatter + kernel)",
                             lambda: detect_cuda.find_blobs(
                                 detect.scatter_pixels(up, shape), 0.5,
                                 kw["max_blobs"], kw["cc_iters"]))
        blobs, bv = blobs[None], bv[None]
        bu = timed("undistort", lambda: torch.where(
            bv[..., None], camera.undistort_points(
                blobs, eng._K[:, None], eng._dist[:, None]), 0.0))
        m = timed("match + triangulate", lambda: correspond.match_points(
            bu, bv, eng._Ps, gate_px=kw["gate_px"],
            max_candidates=kw["max_candidates"], Fs=eng._F, with_obs=True))
        pts = timed("world", lambda: torch.where(
            m["valid"][..., None], world.to_world(m["object_points"], eng._M),
            0.0))
        loc = timed("rigid", lambda: rigid.locate_objects(
            pts, m["errors"], m["valid"], dist1=kw["marker_dist1"],
            dist2=kw["marker_dist2"], tol=kw["marker_tol"],
            side_min=kw["marker_side_min"], ax_h1=0, ax_h2=2))
        state, tracked = timed("bank (kernel)", lambda: pipeline._bank(
            state, loc, dts, cfg.kalman_report, "auto"))
        timed("pack + readback + decode", lambda: pipeline.unpack_outputs(
            pipeline.pack_outputs(pipeline._batch_outputs(
                bu, bv, m, pts, loc, tracked))[0].cpu().numpy(),
            *eng._layout))
    report("[7] detection on the card:")

    # host detection: the [4b] engine's per-frame stages
    pinned = torch.zeros((C, K, 3), pin_memory=dev.type == "cuda")
    cutoff = detect.threshold_cutoff(cfg.detect_threshold)
    state = eng_hd._kalman_state
    cal = (eng_hd._Ps, eng_hd._K, eng_hd._dist, eng_hd._M, eng_hd._F)
    for f in frames:
        timed("host ingest (detect into pinned)",
              lambda: bindings.ingest_detect_packed(
                  f, cutoff, K, out=pinned.numpy()))
        up = timed("upload", lambda: pinned.to(dev, non_blocking=True))
        state, out = timed("tail (track_from_blobs)",
                           lambda: pipeline.track_from_blobs(
                               state, up[..., :2], up[..., 2] > 0.5,
                               np.float32(1 / 60), *cal, **eng_hd._tail_kw))
        timed("pack + readback + decode", lambda: pipeline.unpack_outputs(
            pipeline.pack_outputs(out).cpu().numpy(), *eng_hd._layout))
    report("[7] detection on the host:")

    n = len(frames)
    idle = {}
    idle["device detect"] = print_profile(
        "[7] profiled process_frame, detection on the card:",
        profile_frames(serve_all(eng, frames, flush=False), n), 1e3 / fps,
        n)
    idle["host detect"] = print_profile(
        "[7] profiled process_frame, detection on the host (depth 0):",
        profile_frames(serve_all(eng_hd, frames, flush=False), n),
        1e3 / fps_hd, n)
    batch = [src.read_at((N_FRAMES + i) / 60) for i in range(BATCH)]
    idle["batched"] = print_profile(
        f"[7] profiled process_frame, one batch of {BATCH} (inline):",
        profile_frames(serve_all(eng_b, batch, flush=False), BATCH),
        1e3 / fps_b, BATCH)
    return idle


def serve_rates():
    """Per-frame host-detect serving ([4b]'s frames, depth 0) and the
    batched Engine ([4c]'s frames, inline) of whichever package this
    process imports: frames/s, and kernels per frame under
    ``torch.profiler``."""
    import dataclasses

    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = syn.ring_rig(num_cameras=4, image_size=320)
    cfg = EngineConfig()
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    frames = [src.read_at(i / 60) for i in range(N_FRAMES)]
    eng, _ = serving_engine(rig, cfg, Rs, ts, src)
    with GcPauses():
        stamps = [time.perf_counter()]
        for f in frames:
            eng.process_frame(f, 1 / 60)
            stamps.append(time.perf_counter())
    per_frame = (N_FRAMES - WARM_FRAMES) / (stamps[-1] - stamps[WARM_FRAMES])

    kernels = profile_frames(serve_all(eng, frames[:BREAKDOWN_FRAMES],
                                       flush=False), BREAKDOWN_FRAMES)[1]
    n = BATCH_ROUNDS * BATCH
    bframes = [src.read_at((N_FRAMES + BATCH + i) / 60) for i in range(n)]
    eng_b, _ = serving_engine(
        rig, dataclasses.replace(cfg, dispatch_batch=BATCH), Rs, ts, src)
    for f in bframes[:BATCH]:       # one batch to warm up
        eng_b.process_frame(f, 1 / 60)
    with GcPauses():
        t0 = time.perf_counter()
        for f in bframes:
            eng_b.process_frame(f, 1 / 60)
        eng_b.flush_batches()
        batched = n / (time.perf_counter() - t0)
    return {"per_frame": per_frame, "batched": batched,
            "kernels_per_frame": kernels}


def kernel_sass(root, *parts):
    """{part: SASS instructions} of the kernels whose mangled names hold
    ``parts`` in the checkout at ``root``: its ``csrc/kalman_bank.cu``
    built with the port's nvcc flags into a temporary directory, then
    ``cuobjdump -sass``, without addresses and encodings."""
    import re
    import tempfile

    from low_cost_mocap_tpu_torch.ops import native

    src = os.path.join(root, "low_cost_mocap_tpu_torch", "csrc",
                       "kalman_bank.cu")
    nvcc = native.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "lib.so")
        subprocess.run([nvcc, *native.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True, timeout=600)
        dump = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
            check=True, capture_output=True, text=True, timeout=600).stdout
    out = {}
    for part in parts:
        blocks = [b for b in dump.split("Function : ")[1:]
                  if part in b.split("\n", 1)[0]]
        check(len(blocks) == 1,
              f"{len(blocks)} kernels named *{part}* in {src}")
        out[part] = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;",
                               blocks[0])
    return out


def check_serving_sass(old_root):
    """[8] The serving bank's instantiation (``kalman_bank_kernel<false>``)
    compiles to the same SASS here as in the checkout at ``old_root``,
    instruction for instruction; with the instruction counts of the
    file's other kernels."""
    here = os.path.dirname(os.path.abspath(__file__))
    serving = "kalman_bank_kernelILb0E"
    old = kernel_sass(old_root, serving)[serving]
    sass = kernel_sass(here, serving, "kalman_bank_kernelILb1E",
                       "kalman_bank_rts_gains", "kalman_bank_rts_sweep")
    new = sass.pop(serving)
    diff = next((i for i, (a, b) in enumerate(zip(old, new)) if a != b),
                None if len(old) == len(new) else min(len(old), len(new)))
    check(diff is None, f"[8] the serving bank's SASS differs from "
          f"{old_root}'s at instruction {diff} of {len(new)} ({len(old)})")
    print(f"[8] the serving bank's SASS equals {old_root}'s, instruction "
          f"for instruction ({len(new)}); instructions of the other kernels "
          + ", ".join(f"{k} {len(v)}" for k, v in sass.items()))


def phase_compare(old_root, frames, args, cands, num_objects):
    """[8] The kernels of another checkout (``old_root``, a directory that
    holds its ``low_cost_mocap_tpu_torch``) against this one's, on the same
    card and the same inputs: four processes in turns, old, new, new, old,
    each building its own kernels, running ``kernel_times`` and serving
    with ``serve_rates``; first ``check_serving_sass``."""
    check_serving_sass(old_root)
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, root in (("old", old_root), ("new", here), ("new", here),
                        ("old", old_root)):
        res = timing_process(root, frames, args, cands, num_objects,
                             rates=True)
        runs.append((label, res))
        print_kernel_times(f"[8] {label} ({root})", res["times"])
        r = res["rates"]
        print(f"[8] {label} ({root}) serving: per frame "
              f"{r['per_frame']:.1f} frames/s, batched B={BATCH} "
              f"{r['batched']:.1f} frames/s, "
              f"{r['kernels_per_frame']:.1f} kernels a per-frame frame")
    for name in runs[0][1]["times"]:
        row = {}
        for label in ("old", "new"):
            ts = [r["times"][name] for lb, r in runs if lb == label]
            row[label] = tuple(float(np.mean([t[k] for t in ts]))
                               for k in ("ms", "device_ms"))
        print(f"[8] {name}: event window {row['old'][0]:.4f} -> "
              f"{row['new'][0]:.4f} ms, device {row['old'][1]:.4f} -> "
              f"{row['new'][1]:.4f} ms (old = {old_root}, mean of two runs "
              "each)")
    for key in ("per_frame", "batched", "kernels_per_frame"):
        mean = {label: float(np.mean([r["rates"][key] for lb, r in runs
                                      if lb == label]))
                for label in ("old", "new")}
        print(f"[8] serving {key}: {mean['old']:.1f} -> {mean['new']:.1f} "
              f"({(mean['new'] / mean['old'] - 1) * 100:+.1f}%, mean of two "
              "runs each)")


def time_kernels_main(path):
    """``--time-kernels``: ``kernel_times`` on saved inputs and, when asked,
    ``serve_rates``, printed as one ``TIMES {...}`` line (a process of
    ``timing_process``)."""
    import torch

    from low_cost_mocap_tpu_torch.ops import native

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    d = torch.load(path)
    times = kernel_times(d["frames"].to(DEVICE), tuple(d["args"]),
                         tuple(c.to(DEVICE) for c in d["cands"]), d["O"])
    print("TIMES " + json.dumps({
        "package": os.path.abspath(native.__file__), "times": times,
        "rates": serve_rates() if d["rates"] else None}))


def wand_capture(rig, Rs, ts, n, seed=0):
    """A wand capture: one marker over ``n`` frames through the volume,
    0.3 px noise, about 5% of the observations dropped per camera and 3% of
    the frames with one camera's detection replaced by a stray blob.
    Returns (points, mask, outlier frames)."""
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(seed)
    X = syn.random_points(rng, n)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=0.3, rng=rng)
    mask &= rng.random(mask.shape) >= WAND_DROP
    out = rng.random(n) < WAND_OUTLIERS
    cams = rng.integers(0, rig.num_cameras, n)
    pts[out, cams[out]] = rng.random((int(out.sum()), 2)) * 320
    return pts, mask, out


def wire_points(pts, mask):
    """The ``cameraPoints`` wire shape: [x, y] or [None, None]."""
    return [[pts[f, c].tolist() if mask[f, c] else [None, None]
             for c in range(pts.shape[1])] for f in range(len(pts))]


def rel_angles_deg(Rs_a, Rs_b):
    """Angle (deg) between each camera's rotation relative to camera 0."""
    ra = np.einsum("cij,kj->cik", Rs_a, Rs_a[0])
    rb = np.einsum("cij,kj->cik", Rs_b, Rs_b[0])
    cos = (np.einsum("cij,cij->c", ra, rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def unit_ts(ts):
    ts = np.asarray(ts, np.float64)
    return ts / np.linalg.norm(ts) * np.sign(ts[1, 0])


def triangulated(rig, X, Rs_true, ts_true, Rs, ts, M, seed):
    """World points, as the console collects them: ``X`` observed through
    the true rig with 0.3 px noise, triangulated with the calibrated poses
    and put into the engine's world frame under ``M``."""
    import torch

    from low_cost_mocap_tpu_torch.ops import camera, triangulate, world
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(seed)
    pts, mask = syn.observe(X, Rs_true, ts_true, rig, noise_px=0.3, rng=rng)
    dev = torch.device(DEVICE)
    Ps = camera.projection_matrix(
        torch.as_tensor(rig.K_stack(), device=dev),
        torch.as_tensor(np.asarray(Rs, np.float32), device=dev),
        torch.as_tensor(np.asarray(ts, np.float32), device=dev))
    Xc, _ = triangulate.triangulate_points(
        torch.as_tensor(pts, device=dev), Ps, torch.as_tensor(mask,
                                                              device=dev))
    return world.to_world(Xc, torch.as_tensor(M, device=dev)).cpu().numpy()


def procrustes_errors(a, b):
    """Distances between points ``a`` and the best rigid image of ``b``
    (rotation, reflection allowed, and translation)."""
    ca, cb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((b - cb).T @ (a - ca))
    return np.linalg.norm((b - cb) @ (U @ Vt) + ca - a, axis=1)


def phase_calibration(rig, cfg, Rs, ts):
    """[9] The calibration workflow and trajectory execution through
    ``Engine.handle`` on the CUDA engine.  Returns (bank launches of the
    served frames, the printed timings)."""
    import torch

    from low_cost_mocap_tpu_torch.models import calibrator
    from low_cost_mocap_tpu_torch.ops import ba, ransac, triangulate
    from low_cost_mocap_tpu_torch.runtime import compiled
    from low_cost_mocap_tpu_torch.runtime.engine import (
        Engine, camera_poses_to_serializable)
    from low_cost_mocap_tpu_torch.runtime.serial_link import (CollectingLink,
                                                              LoopbackLink)
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    C = rig.num_cameras
    dev = torch.device(DEVICE)
    t_all = time.perf_counter()
    # [9a] calculate-camera-pose from a wand capture
    pts, mask, outl = wand_capture(rig, Rs, ts, WAND_FRAMES)
    eng = Engine(rig, cfg, None, CollectingLink(), device=DEVICE)
    events = []
    eng.on("camera-pose", events.append)
    event_ms, finals = [], []
    # the first event in a process also loads the linear-algebra libraries;
    # the second is the steady cost
    for _ in range(2):
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.handle("calculate-camera-pose",
                   {"cameraPoints": wire_points(pts, mask)})
        torch.cuda.synchronize()
        event_ms.append((time.perf_counter() - t0) * 1e3)
        finals.append(np.asarray([p["R"] for p in
                                  events[-1]["camera_poses"]]))
    d_again = float(np.abs(finals[0] - finals[1]).max())
    check(d_again < CALIB_ATOL, f"[9a] the second event's rotations differ "
          f"from the first's by {d_again}")
    iters = [e.get("ba_iters") for e in events]
    want = list(range(8, cfg.ba_max_iters + 1, 8)) + [None]
    check(iters == want, f"[9a] progress events {iters}, want {want}")
    Rs_c, ts_c = eng.camera_poses
    ang = rel_angles_deg(Rs_c, Rs)
    check(ang.max() < 0.5, f"[9a] relative rotations off by {ang} deg")
    # the error of the frames without a stray blob (the event's own error
    # averages the strays' in too)
    keep = ~outl
    Ps = torch.as_tensor(rig.K_stack(), device=dev) @ torch.cat(
        [torch.as_tensor(Rs_c, device=dev),
         torch.as_tensor(ts_c, device=dev)[..., None]], -1)
    p_in = torch.as_tensor(pts[keep], device=dev)
    m_in = torch.as_tensor(mask[keep], device=dev)
    X_in, _ = triangulate.triangulate_points(p_in, Ps, m_in)
    e_in = triangulate.reprojection_errors(p_in, X_in, Ps, m_in).cpu().numpy()
    err_in = float(e_in[np.isfinite(e_in)].mean())
    check(err_in < 0.5, f"[9a] mean error {err_in} px^2 on the clean frames")
    # the same inputs and index tables through the port on the CPU
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    mask_d = torch.as_tensor(mask, device=dev)
    tables = [ransac.draw_samples(mask_d[:, i] & mask_d[:, i + 1],
                                  cfg.ransac_iters, gen)
              for i in range(C - 1)]
    cpu_res = calibrator.calibrate(
        torch.as_tensor(pts), torch.as_tensor(mask),
        torch.as_tensor(rig.K_stack()), ransac_iters=cfg.ransac_iters,
        threshold_px=cfg.ransac_threshold_px, ba_iters=cfg.ba_max_iters,
        progress_cb=lambda *a: None, index_tables=[t.cpu() for t in tables])
    d_rot = float(np.abs(np.einsum("cij,kj->cik", Rs_c, Rs_c[0])
                         - np.einsum("cij,kj->cik", cpu_res.Rs.numpy(),
                                     cpu_res.Rs.numpy()[0])).max())
    d_t = float(np.abs(unit_ts(ts_c) - unit_ts(cpu_res.ts.numpy())).max())
    d_err = abs(events[-1]["error"] - float(cpu_res.mean_error))
    check(d_rot < CALIB_ATOL and d_t < CALIB_ATOL
          and d_err < CALIB_ATOL * max(1.0, events[-1]["error"]),
          f"[9a] card vs CPU: rotations {d_rot}, translations {d_t}, error "
          f"{d_err}")
    # RANSAC and BA alone on the card, on the same tables
    Kd = torch.as_tensor(rig.K_stack(), device=dev)
    pts_d = torch.as_tensor(pts, device=dev)
    ransac_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Rs0, ts0 = calibrator.bootstrap_poses(
            pts_d, mask_d, Kd, cfg.ransac_iters, cfg.ransac_threshold_px,
            index_tables=tables)
        torch.cuda.synchronize()
        ransac_ms.append((time.perf_counter() - t0) * 1e3)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ba.bundle_adjust(pts_d, mask_d, Kd, Rs0, ts0, num_cameras=C,
                     max_iters=cfg.ba_max_iters, stats=stats)
    torch.cuda.synchronize()
    ba_ms = (time.perf_counter() - t0) * 1e3
    timings = {"event_ms": event_ms[1], "first_event_ms": event_ms[0],
               "ransac_ms": float(np.median(ransac_ms)),
               "ba_ms": ba_ms, "ba_iters": stats["iterations"]}
    print(f"[9a] calculate-camera-pose on {WAND_FRAMES} wand frames "
          f"({int(outl.sum())} with a stray blob, "
          f"{int((~mask).sum())} observations missing): {len(events)} "
          f"camera-pose events, ba_iters {iters[:-1]}; event error "
          f"{events[-1]['error']:.4f} px^2, {err_in:.4f} on the clean "
          f"frames; relative rotations off the truth by "
          f"{', '.join(f'{a:.4f}' for a in ang[1:])} deg; against the CPU "
          f"on the same index tables: rotations {d_rot:.2e}, unit "
          f"translations {d_t:.2e}, error {d_err:.2e}; the two events' "
          f"rotations {d_again:.1e} apart; on the card: the "
          f"event {event_ms[1]:.1f} ms ({event_ms[0]:.1f} ms the first time "
          f"in the process), RANSAC (3 pairs x "
          f"{cfg.ransac_iters} trials) {timings['ransac_ms']:.1f} ms, one "
          f"BA solve {ba_ms:.1f} ms over {stats['iterations']} iterations "
          f"({ba_ms / max(stats['iterations'], 1):.2f} ms each; "
          f"{stats['chunks']} chunks of {ba.CHUNK} replayed, "
          f"{stats['reads']} reads of done)")

    # [9b] determine-scale, acquire-floor, set-origin on the result
    rng = np.random.default_rng(1)
    centre = syn.random_points(rng, SCALE_FRAMES)
    u = rng.normal(size=(SCALE_FRAMES, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    half = (u * rig.wand_length / 2).astype(np.float32)
    ends = np.concatenate([centre - half, centre + half])
    M0 = np.eye(4, dtype=np.float32)
    W = triangulated(rig, ends, Rs, ts, Rs_c, ts_c, M0, seed=2)
    pairs = np.stack([W[:SCALE_FRAMES], W[SCALE_FRAMES:]], 1)
    eng.handle("determine-scale", {
        "objectPoints": pairs.tolist(),
        "cameraPoses": camera_poses_to_serializable(Rs_c, ts_c)})
    Rs_s, ts_s = eng.camera_poses
    scale_err = baseline(Rs_s, ts_s) / baseline(Rs, ts) - 1.0
    check(abs(scale_err) < 0.02, f"[9b] baseline off by {scale_err:.4f}")
    floor = np.concatenate([rng.uniform(-0.6, 0.6, (FLOOR_POINTS, 2)),
                            np.zeros((FLOOR_POINTS, 1))], 1).astype(np.float32)
    mats = []
    eng.on("to-world-coords-matrix", mats.append)
    eng.handle("acquire-floor", {"objectPoints": [triangulated(
        rig, floor, Rs, ts, Rs_s, ts_s, eng.to_world_matrix, 3).tolist()]})
    level = triangulated(rig, floor, Rs, ts, Rs_s, ts_s,
                         eng.to_world_matrix, 4)
    origin = triangulated(rig, np.zeros((1, 3), np.float32), Rs, ts, Rs_s,
                          ts_s, eng.to_world_matrix, 5)[0]
    eng.handle("set-origin", {"objectPoint": origin.tolist(),
                              "toWorldCoordsMatrix":
                                  eng.to_world_matrix.tolist()})
    check(len(mats) == 2, "[9b] to-world-coords-matrix events")
    floor_std = float(level[:, 1].std())
    check(floor_std < 3e-3, f"[9b] the floor is not level: height std "
          f"{floor_std} m")
    # track the orbit with the calibrated, scaled, levelled poses.  The
    # locator tells a drone's third LED by its offset along the world's z
    # axis, so the drones fly with that LED along the calibrated frame's z
    # (whose yaw camera 0 set)
    probe = syn.random_points(rng, 50)
    W = triangulated(rig, probe, Rs, ts, Rs_s, ts_s, eng.to_world_matrix, 6)
    U, _, Vt = np.linalg.svd((probe - probe.mean(0)).T @ (W - W.mean(0)))
    z_dir = (U @ Vt)[:2, 2]
    psi = float(np.arctan2(-z_dir[0], z_dir[1]))
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(psi,
                                                                psi + np.pi))
    trk, payloads = serving_engine(rig, cfg, Rs_s, ts_s, src)
    trk.handle("triangulate-points", {
        "startOrStop": "start",
        "cameraPoses": camera_poses_to_serializable(Rs_s, ts_s),
        "toWorldCoordsMatrix": eng.to_world_matrix.tolist()})
    payloads.clear()
    for i in range(ORBIT_FRAMES):
        trk.process_frame(src.read_at(i / 60), 1 / 60)
    got, truth = [], []
    for i, p in enumerate(payloads[SETTLE_FRAMES:], start=SETTLE_FRAMES):
        if len(p["filtered_objects"]) != 2:
            continue
        truth.append([src.drone_pose(d, i / 60)[0] for d in range(2)])
        got.append([o["pos"] for o in p["filtered_objects"]])
    check(len(got) >= 0.9 * (ORBIT_FRAMES - SETTLE_FRAMES),
          f"[9b] both drones tracked in {len(got)} frames")
    got = np.asarray(got, np.float64).reshape(-1, 3)
    truth = np.asarray(truth, np.float64).reshape(-1, 3)
    # the drones' identities may swap under the calibrated frame's yaw:
    # align with either pairing and keep the better one
    errs = min((procrustes_errors(got, t) for t in
                (truth, truth.reshape(-1, 2, 3)[:, ::-1].reshape(-1, 3))),
               key=lambda e: e.mean())
    check(errs.mean() < 0.02 and errs.max() < 0.05,
          f"[9b] tracking error mean {errs.mean():.4f} max "
          f"{errs.max():.4f} m")
    print(f"[9b] determine-scale from {SCALE_FRAMES} wand pairs (baseline "
          f"scale error {scale_err * 100:.3f}%), acquire-floor from "
          f"{FLOOR_POINTS} floor points (height std after {floor_std * 1e3:.2f}"
          f" mm), set-origin; the orbit tracked with the calibrated poses "
          f"over {ORBIT_FRAMES} frames: error after a rigid alignment mean "
          f"{errs.mean() * 1e3:.2f} mm, max {errs.max() * 1e3:.2f} mm")
    phase_degenerate_floor(rig, cfg)

    # [9c] refine-camera-pose over served frames from perturbed poses
    reset_launches()
    Rs_p, ts_p = perturbed_poses(Rs, ts)
    ref, pl = serving_engine(rig, cfg, Rs_p, ts_p, src)
    poses = []
    ref.on("camera-pose", poses.append)
    ref.handle("refine-camera-pose", {"startOrStop": "start"})
    for i in range(REFINE_FRAMES):
        ref.process_frame(sweep_frame(i, rig, Rs, ts), 1 / 60)
    before = float(np.median([e for p in pl for e in p["errors"]]))
    # the stop's BA, its arguments and stats kept (the Engine calls
    # ops.ba.bundle_adjust through the module)
    seen = {}
    real_ba = ba.bundle_adjust

    def keep_ba(*a, **kw):
        seen.update(args=a, kw=kw)
        return real_ba(*a, stats=seen.setdefault("stats", {}), **kw)

    ba.bundle_adjust = keep_ba
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref.handle("refine-camera-pose", {"startOrStop": "stop"})
        refine_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ba.bundle_adjust = real_ba
    # the same solve with the points padded by hand to other lengths, op
    # by op: the iteration at which its convergence test fires
    pad_iters = []
    p0, m0 = seen["args"][0], seen["args"][1]
    for extra in (0, 100, 400):
        pts_x, mask_x = ba.pad_points(p0, m0, p0.shape[0] + extra)
        st = {}
        with compiled.disable_graphs():
            real_ba(pts_x, mask_x, *seen["args"][2:], stats=st,
                    **seen["kw"])
        pad_iters.append((ba.bucket(p0.shape[0] + extra), st["iterations"]))
    pl.clear()
    for i in range(REFINE_FRAMES, REFINE_FRAMES + 20):
        ref.process_frame(sweep_frame(i, rig, Rs, ts), 1 / 60)
    after = float(np.median([e for p in pl for e in p["errors"]]))
    launches = read_launches("[9c]", 0, REFINE_FRAMES + 20)
    check(len(poses) == 1 and poses[0].get("refined_from_points", 0) >= 60,
          f"[9c] refine events {poses}")
    check(after <= 0.5 * before, f"[9c] median error {before} -> {after}")
    timings["refine_ms"] = refine_ms
    print(f"[9c] refine-camera-pose over {REFINE_FRAMES} served frames "
          f"({poses[0]['refined_from_points']} points): median error "
          f"{before:.4f} -> {after:.4f} px^2 on the next 20 frames; the "
          f"stop (BA with focals pinned) took {refine_ms:.1f} ms, its BA "
          f"{seen['stats']['iterations']} LM iterations in "
          f"{seen['stats']['chunks']} chunk(s), the first call at its "
          f"bucket op by op; the same solve at buckets (bucket, "
          f"iterations) {pad_iters}; kalman_bank {launches[1]} launches")

    # [9d] calibrate-intrinsics on camera 0 from rendered dot grids
    K_t, views = intrinsics_views(rig)
    got_v = {"views": 0, "result": None}
    eng.on("intrinsics-views", lambda d: got_v.__setitem__("views",
                                                           d["views"]))
    eng.on("camera-intrinsics", lambda d: got_v.__setitem__("result", d))
    eng.handle("calibrate-intrinsics", {"startOrStop": "start",
                                        "cameraIndex": 0, "rows": 4,
                                        "cols": 5, "spacing": 0.05})
    for f in views:
        eng.process_frame(f, 1 / 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.handle("calibrate-intrinsics", {"startOrStop": "stop"})
    intr_ms = (time.perf_counter() - t0) * 1e3
    res = got_v["result"]
    check(res is not None and res["error"] is None,
          f"[9d] calibrate-intrinsics: {res}")
    K = np.asarray(res["K"])
    rel = np.abs(np.diag(K)[:2] / np.diag(K_t)[:2] - 1.0)
    check(rel.max() < 0.03, f"[9d] fx, fy off by {rel}")
    timings["intrinsics_ms"] = intr_ms
    print(f"[9d] calibrate-intrinsics on camera 0 from {res['views']} "
          f"rendered 320x320 dot-grid views: fx {K[0, 0]:.2f} (true "
          f"{K_t[0, 0]:.2f}), fy {K[1, 1]:.2f} (true {K_t[1, 1]:.2f}), rms "
          f"{res['rms_px']:.4f} px; the stop took {intr_ms:.1f} ms")

    # [9e] run-trajectory over the loopback link
    class RecordingLoopback(LoopbackLink):
        def __init__(self, n):
            super().__init__(n)
            self.sent = []

        def send(self, drone_index, payload):
            self.sent.append((drone_index, payload))
            super().send(drone_index, payload)

    reset_launches()
    static = SyntheticSource(rig, Rs, ts, num_drones=2,
                             headings=(0.0, np.pi), orbit_hz=0.0)
    link = RecordingLoopback(rig.num_objects)
    fly = Engine(rig, cfg, static, link, device=DEVICE)
    start_tracking(fly, Rs, ts)
    statuses = []
    fly.on("trajectory-status", statuses.append)
    frame = static.read_at(0.0)
    for _ in range(5):
        out = fly.process_frame(frame, 1 / 60)
    check(bool(out.tracked.valid.all()), "[9e] drones not tracked")
    fw = [[float(p[0]), float(p[2]), float(p[1])] for p in out.tracked.pos]
    plan = [[fw[0][0] + 0.002 * k, fw[0][1], fw[0][2],
             fw[1][0], fw[1][1] + 0.002 * k, fw[1][2]]
            for k in range(TRAJ_SETPOINTS)]
    link.sent.clear()
    fly.handle("run-trajectory", {"setpoints": plan, "timestep": 1 / 60,
                                  "arrivalTol": 0.05})
    n_served = 5
    while (not statuses or statuses[-1]["phase"] not in ("done", "aborted")) \
            and n_served < 5 + TRAJ_SETPOINTS + 30:
        fly.process_frame(frame, 1 / 60)
        link.tick(1 / 60)
        n_served += 1
    phases = [s["phase"] for s in statuses]
    check(phases == ["fly-to-start", "executing", "done"],
          f"[9e] trajectory phases {phases}")
    sent = [(d, p["setpoint"]) for d, p in link.sent if "setpoint" in p]
    want_sent = [(d, plan[0][3 * d:3 * d + 3]) for d in range(2)] + [
        (d, row[3 * d:3 * d + 3]) for row in plan[1:] for d in range(2)]
    check(sent == want_sent, "[9e] setpoints not sent in order")
    launches_e = read_launches("[9e]", 0, n_served)
    print(f"[9e] run-trajectory over the loopback link: phases {phases}, "
          f"{len(sent)} setpoints sent in plan order over {n_served} served "
          f"frames; kalman_bank {launches_e[1]} launches")
    print(f"[9] calibration phases took {time.perf_counter() - t_all:.1f} s")
    return launches[1] + launches_e[1], timings


def phase_degenerate_floor(rig, cfg):
    """[9b] acquire-floor on clouds that leave the plane underdetermined
    (two points; collinear points), each on a fresh CUDA engine: the
    installed matrix is finite and the port's on the CPU within
    FLOOR_ATOL (the SVD minimum-norm plane, the JAX package's)."""
    import torch

    from low_cost_mocap_tpu_torch.ops import world
    from low_cost_mocap_tpu_torch.runtime.engine import Engine
    from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink

    clouds = {"2 points": [[0.1, 0.02, 0.3], [-0.4, 0.05, 0.2]],
              "12 collinear points": [[t, 0.01 + 0.02 * t, 0.5 - t] for t in
                                      np.linspace(-0.5, 0.5, 12)]}
    worst = 0.0
    for name, pts in clouds.items():
        eng = Engine(rig, cfg, None, CollectingLink(), device=DEVICE)
        M0 = eng.to_world_matrix.copy()
        eng.handle("acquire-floor", {"objectPoints": [pts]})
        want = world.fit_floor(torch.tensor(pts, dtype=torch.float32),
                               torch.from_numpy(M0)).numpy()
        got = eng.to_world_matrix
        check(np.isfinite(got).all(), f"[9b] acquire-floor on {name} "
              f"installed a non-finite matrix {got}")
        worst = max(worst, float(np.abs(got - want).max()))
    check(worst <= FLOOR_ATOL, f"[9b] degenerate floor card vs CPU {worst}")
    print(f"[9b] acquire-floor on {' and on '.join(clouds)}: finite "
          f"matrices installed, within {worst:.1e} of the port on the CPU "
          "(the SVD minimum-norm plane)")


def baseline(Rs, ts):
    """Distance between the centres of cameras 0 and 1."""
    c = -np.einsum("cji,cj->ci", Rs, ts)
    return float(np.linalg.norm(c[1] - c[0]))


def perturbed_poses(Rs, ts, seed=7):
    """Poses about 0.01 rad and 1 cm off the truth."""
    import torch

    from low_cost_mocap_tpu_torch.ops import rotations

    rng = np.random.default_rng(seed)
    dR = rotations.rotvec_to_matrix(torch.as_tensor(
        rng.normal(scale=0.01, size=(len(Rs), 3)).astype(np.float32))).numpy()
    return (np.einsum("cij,cjk->cik", dR, Rs).astype(np.float32),
            (ts + rng.normal(scale=0.01, size=ts.shape)).astype(np.float32))


def sweep_frame(i, rig, Rs, ts):
    """One drone swept through the volume on a script."""
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    phase = 2 * np.pi * i / 40.0
    pos = np.array([0.35 * np.cos(phase), 0.35 * np.sin(phase),
                    0.6 + 0.15 * np.sin(2 * phase)], np.float32)
    pts, mask = syn.observe(syn.drone_markers(pos, 0.0, rig), Rs, ts, rig)
    return (syn.render_frames(pts, mask, rig.image_size, sigma=0.8)
            * 255).astype(np.uint8)


def intrinsics_views(rig, n=INTRINSICS_VIEWS, seed=9):
    """Rendered frames of a 4x5 dot grid (5 cm pitch) in front of camera 0
    at varied tilts, through a pinhole K; the other cameras dark."""
    import torch

    from low_cost_mocap_tpu_torch.ops import rotations
    from low_cost_mocap_tpu_torch.ops.intrinsics import make_grid
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    S = 320
    K_t = np.array([[0.8 * S, 0.0, S / 2 + 3.0], [0.0, 0.79 * S, S / 2 - 4.0],
                    [0.0, 0.0, 1.0]])
    board = make_grid(4, 5, 0.05).astype(np.float64)
    obj3 = np.concatenate([board, np.zeros((len(board), 1))], axis=-1)
    rng = np.random.default_rng(seed)
    frames = []
    while len(frames) < n:
        rvec = np.deg2rad(rng.uniform(-25, 25, size=3) * [1, 1, 0.7])
        R = rotations.rotvec_to_matrix(torch.as_tensor(rvec)).numpy()
        t = np.array([-0.10 + rng.uniform(-0.02, 0.02),
                      -0.08 + rng.uniform(-0.02, 0.02),
                      rng.uniform(0.5, 0.7)])
        Xc = obj3 @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * [K_t[0, 0], K_t[1, 1]] + K_t[:2, 2]
        if not ((uv > 4).all() and (uv < S - 5).all()):
            continue
        f0 = syn.render_frames(uv[:, None, :].astype(np.float32),
                               np.ones((len(uv), 1), bool), S, sigma=1.2)
        f = np.zeros((rig.num_cameras, S, S), np.uint8)
        f[0] = (f0[0] * 255).astype(np.uint8)
        frames.append(f)
    return K_t, frames


def rot_up(a):
    """A turn about the display world's up axis."""
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def pair_distances(m):
    """A marker set's sorted pairwise distances."""
    return np.sort(np.linalg.norm(m[:, None] - m[None], axis=-1), axis=None)


def rot_angle_deg(Ra, Rb):
    cos = (np.trace(np.asarray(Ra, np.float64).T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


class BodyScene:
    """The body rig's scene: the script's two drones on their orbit and
    props A and B, each circling 8 cm at 0.2 Hz while its yaw swings
    0.4 rad either way, tilted so that no two of a prop's markers merge in
    a camera.  Props are posed in the display world frame ([x, up, z], the
    frame the fits come out in) and mapped back to the triangulation frame
    to be rendered."""

    PROPS = {"A": (BODY_TMPL_A, (-0.3, 0.25, 0.1), 0.4, 0.6, 0.0),
             "B": (BODY_TMPL_B, (0.3, 0.25, -0.1), 2.15, 0.3, 1.0)}

    def __init__(self, rig, Rs, ts, props=("A", "B"), drones=True):
        from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

        self.rig, self.Rs, self.ts = rig, Rs, ts
        self.props, self.drones = props, drones
        self.src = SyntheticSource(rig, Rs, ts, num_drones=2,
                                   headings=(0.0, np.pi))

    def pose(self, name, t):
        """(R, t) of a prop at time ``t`` (s), display world frame."""
        _, centre, yaw, tilt, phase0 = self.PROPS[name]
        ph = 2 * np.pi * 0.2 * t + phase0
        return (rot_up(yaw + 0.4 * np.sin(ph)) @ rot_x(tilt),
                np.asarray(centre, np.float32)
                + np.float32(0.08) * np.array([np.cos(ph), 0.0, np.sin(ph)],
                                              np.float32))

    def markers(self, name, t):
        R, p = self.pose(name, t)
        return np.asarray(self.PROPS[name][0], np.float32) @ R.T + p

    def _observed(self, t):
        """Every marker's pixels (N, C, 2), visibility, and its owner (a
        prop's name, or "drone")."""
        from low_cost_mocap_tpu_torch.utils import synthetic as syn

        parts, owner = [], []
        for n in self.props:
            Xw = self.markers(n, t)
            parts.append(Xw[:, [0, 2, 1]] * np.array([-1.0, -1.0, 1.0],
                                                      np.float32))
            owner += [n] * len(Xw)
        if self.drones:
            parts += [syn.drone_markers(*self.src.drone_pose(d, t), self.rig)
                      for d in range(2)]
            owner += ["drone"] * 6
        pts, mask = syn.observe(np.concatenate(parts), self.Rs, self.ts,
                                self.rig)
        return pts, mask, np.asarray(owner)

    def read_at(self, t):
        from low_cost_mocap_tpu_torch.utils import synthetic as syn

        pts, mask, _ = self._observed(t)
        return (syn.render_frames(pts, mask, self.rig.image_size, sigma=0.8)
                * 255).astype(np.uint8)

    def clear(self, name, t):
        """Whether every marker of a prop is at least CLEAR_PX from every
        other marker in every camera at time ``t`` (blobs at the threshold
        are about 3 px wide; closer ones touch or merge, and the merged
        centroid moves the marker's point by millimetres)."""
        pts, _, owner = self._observed(t)
        d = np.linalg.norm(pts[owner == name][:, None] - pts[None], axis=-1)
        d[d == 0.0] = np.inf        # each marker against itself
        return bool(d.min() >= CLEAR_PX)


def body_errors(scene, payloads, start=0):
    """Each prop's error in every payload from ``start`` on: for its
    template, the fit nearest the truth (the A set has a spare slot, which
    may fit a drone's LEDs) and the nearest track.  Returns ({"fit",
    "track"}: (mm, deg, clear) arrays, ``clear`` from ``scene.clear``),
    frames with both props fit, and the spare fits."""
    errs = {"fit": ([], [], []), "track": ([], [], [])}
    both, spare = 0, 0
    for i, p in enumerate(payloads[start:], start=start):
        t = i / 60
        fitted = 0
        for k, name in enumerate(scene.props):
            R, pos = scene.pose(name, t)
            clear = scene.clear(name, t)
            for key, field, where in (("fit", "bodies", "t"),
                                      ("track", "tracked_bodies", "pos")):
                cands = [b for b in p[field] if b["templateIndex"] == k]
                if not cands:
                    continue
                d = [np.linalg.norm(np.asarray(b[where]) - pos)
                     for b in cands]
                j = int(np.argmin(d))
                errs[key][0].append(d[j] * 1e3)
                errs[key][1].append(rot_angle_deg(cands[j]["R"], R))
                errs[key][2].append(clear)
                if key == "fit":
                    fitted += 1
                    spare += len(cands) - 1
        both += fitted == len(scene.props)
    return ({k: tuple(np.asarray(x) for x in v) for k, v in errs.items()},
            both, spare)


def body_rows(rig, cfg, Rs, ts, frames, device):
    """Host-detected blobs of ``frames`` through ``track_from_blobs`` with
    the rig's body sets on ``device``: the packed rows."""
    import torch

    from low_cost_mocap_tpu_torch.control import bindings
    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import camera, correspond, detect

    dev = torch.device(device)
    K = torch.as_tensor(rig.K_stack(), device=dev)
    Ps = camera.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                  torch.as_tensor(ts, device=dev))
    cal = (Ps, K, torch.as_tensor(rig.dist_stack(), device=dev),
           torch.eye(4, device=dev), correspond._pairwise_fundamentals(Ps))
    kw = dict(gate_px=cfg.epipolar_gate_px,
              max_candidates=cfg.max_candidates_per_cam,
              marker_dist1=rig.marker_dist_short,
              marker_dist2=rig.marker_dist_long,
              marker_tol=rig.marker_dist_tol,
              marker_side_min=rig.marker_side_min, with_obs=True,
              body_sets=rig.body_sets_resolved())
    cutoff = detect.threshold_cutoff(cfg.detect_threshold)
    st, rows = pipeline.make_init_state(rig, device=dev), []
    for f in frames:
        b = torch.from_numpy(bindings.ingest_detect_packed(
            f, cutoff, cfg.max_blobs)).to(dev)
        st, out = pipeline.track_from_blobs(st, b[..., :2], b[..., 2] > 0.5,
                                            np.float32(1 / 60), *cal, **kw)
        rows.append(pipeline.pack_outputs(out).cpu().numpy())
    return np.stack(rows)


def phase_bodies(rig, cfg, Rs, ts):
    """[10a] The body rig (16 blob slots; TMPL_A with two instances and
    TMPL_B with one: I = 3 body slots, M = 64 bank candidates) served
    through ``Engine`` on the card: BODY_FRAMES frames per frame, then
    BODY_BATCHES batches of BATCH after a warm-up batch (the graphs'
    capture), batched payloads bitwise equal to the
    per-frame ones; the card's body stage against the CPU's; the bank
    kernel at M = 64 against its plain chain; fits and tracks against the
    truth; rates, idle share and kernels a frame with and without bodies.
    Returns (launches {path: (detect, bank)}, bank max_abs_err, numbers)."""
    import dataclasses

    import torch

    from low_cost_mocap_tpu_torch.control import bindings
    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import (camera, correspond, detect,
                                              kalman, kalman_cuda)

    t_all = time.perf_counter()
    brig = dataclasses.replace(rig, body_markers=BODY_TMPL_A, max_bodies=2,
                               body_sets=((BODY_TMPL_B, 1),))
    bcfg = dataclasses.replace(cfg, max_blobs=16)
    scene = BodyScene(brig, Rs, ts)
    n_b = BODY_BATCHES * BATCH
    frames = [scene.read_at(i / 60) for i in range(n_b)]
    launches = {}

    per, pl = serving_engine(brig, bcfg, Rs, ts, None)
    check(per._layout[4] == 3, f"[10a] body slots {per._layout}")
    reset_launches()
    with GcPauses():
        stamps = [time.perf_counter()]
        for f in frames[:BODY_FRAMES]:
            per.process_frame(f, 1 / 60)
            stamps.append(time.perf_counter())
    launches["[10a] per-frame, bodies"] = read_launches(
        "[10a] per-frame", 0, BODY_FRAMES)
    fps = (BODY_FRAMES - WARM_FRAMES) / (stamps[-1] - stamps[WARM_FRAMES])

    bat, bpl = serving_engine(brig, dataclasses.replace(
        bcfg, dispatch_batch=BATCH), Rs, ts, None)
    warm_up_batched(bat, frames, Rs, ts, bpl)
    reset_launches()
    with GcPauses():
        t0 = time.perf_counter()
        for f in frames:
            bat.process_frame(f, 1 / 60)
        bat.flush_batches()
        fps_b = n_b / (time.perf_counter() - t0)
    launches["[10a] batched, bodies"] = read_launches(
        "[10a] batched", 0, BODY_BATCHES)
    check(len(pl) == BODY_FRAMES and len(bpl) == n_b,
          f"[10a] events {len(pl)}, {len(bpl)}")
    check(bpl[:BODY_FRAMES] == pl, "[10a] batched payloads differ from "
          "per-frame payloads")

    # fits and tracks against the truth, after the trackers settle
    errs, both, spare = body_errors(scene, bpl, start=WARM_FRAMES)
    n_set = n_b - WARM_FRAMES
    check(both >= 0.95 * n_set, f"[10a] both props fit in {both}/{n_set}")
    summary = {}
    for key in ("fit", "track"):
        mm, deg, clear = errs[key]
        check(clear.sum() >= 0.2 * len(clear), f"[10a] {key}: only "
              f"{clear.sum()}/{len(clear)} samples with clear markers")
        check(mm[clear].mean() < FIT_MEAN_MM
              and deg[clear].mean() < FIT_MEAN_DEG,
              f"[10a] {key} error with clear markers: mean "
              f"{mm[clear].mean():.2f} mm {deg[clear].mean():.3f} deg")
        check(mm.max() < FIT_MAX_MM and deg.max() < FIT_MAX_DEG,
              f"[10a] {key} error max {mm.max():.2f} mm "
              f"{deg.max():.3f} deg")
        summary[key] = (f"{key}s, {int(clear.sum())} samples with clear "
                        f"markers: mean {mm[clear].mean():.2f} mm "
                        f"{deg[clear].mean():.3f} deg, max "
                        f"{mm[clear].max():.2f} mm {deg[clear].max():.3f} "
                        f"deg; all {len(mm)}: mean {mm.mean():.2f} mm "
                        f"{deg.mean():.3f} deg, max {mm.max():.2f} mm "
                        f"{deg.max():.3f} deg")

    # the card's body stage against the port on the CPU, on the same blobs
    layout = (4, bcfg.max_blobs, rig.num_objects, True, 3)
    rows = {d: body_rows(brig, bcfg, Rs, ts, frames[:BODY_CPU_FRAMES], d)
            for d in ("cpu", DEVICE)}
    worst = 0.0
    for g, w in zip(pipeline.unpack_outputs_batch(rows[DEVICE], *layout),
                    pipeline.unpack_outputs_batch(rows["cpu"], *layout)):
        check(np.array_equal(g.bodies.valid, w.bodies.valid)
              and np.array_equal(g.tracked_bodies.valid,
                                 w.tracked_bodies.valid),
              "[10a] body validity differs between the card and the CPU")
        for a, b in zip((*g.bodies, *g.tracked_bodies),
                        (*w.bodies, *w.tracked_bodies)):
            worst = max(worst, float(np.abs(np.asarray(a, np.float64)
                                            - b).max()))
    check(worst <= BODY_CPU_ATOL, f"[10a] body stage card vs CPU {worst}")

    # the bank kernel at M = 64: the served batch's located candidates, and
    # the random case of phase [3]
    bank_err = 0.0
    dev = torch.device(DEVICE)
    Kd = torch.as_tensor(brig.K_stack(), device=dev)
    cutoff = detect.threshold_cutoff(bcfg.detect_threshold)
    blobs = torch.from_numpy(np.stack([bindings.ingest_detect_packed(
        f, cutoff, bcfg.max_blobs) for f in frames[:BATCH]])).to(dev)
    Ps = camera.projection_matrix(Kd, torch.as_tensor(Rs, device=dev),
                                  torch.as_tensor(ts, device=dev))
    geo = pipeline._locate_frame(
        blobs[..., :2], blobs[..., 2] > 0.5, Ps, Kd,
        torch.as_tensor(brig.dist_stack(), device=dev),
        torch.eye(4, device=dev), correspond._pairwise_fundamentals(Ps),
        gate_px=bcfg.epipolar_gate_px,
        max_candidates=bcfg.max_candidates_per_cam,
        marker_dist1=brig.marker_dist_short,
        marker_dist2=brig.marker_dist_long, marker_tol=brig.marker_dist_tol,
        marker_side_min=brig.marker_side_min)
    loc = geo[3]
    check(loc.valid.shape[-1] == 64, f"[10a] bank width {loc.valid.shape}")
    dts = torch.full((BATCH,), 1 / 60, device=dev)
    cases = [(loc.pos, loc.heading, loc.index, loc.valid, dts)]
    cases += [[torch.from_numpy(a).to(dev) for a in bank_case(B, M=64)]
              for B in (BATCH, 1)]
    for case in cases:
        st = kalman.init_state(rig.num_objects, device=dev)
        st1, tr1 = kalman_cuda.kalman_scan(st, *case)
        st2, tr2 = kalman.update_scan(st, *case)
        torch.cuda.synchronize()
        check(torch.equal(tr1.valid, tr2.valid)
              and torch.equal(st1.initialized, st2.initialized),
              "[10a] kalman_bank M=64: validity")
        bank_err = max(bank_err, max(max_err(a, b) for a, b in zip(
            (*tr1[:3], *st1), (*tr2[:3], *st2))))
    check(bank_err <= BANK_ATOL, f"[10a] kalman_bank M=64 max_abs_err "
          f"{bank_err}")
    st0 = kalman.init_state(rig.num_objects, device=dev)
    bank64_ms = cuda_ms(lambda: kalman_cuda.kalman_scan(st0, *cases[0]))
    bank64_plain = cuda_ms(lambda: kalman.update_scan(st0, *cases[0]),
                           runs=3)
    bank64_bound, bank64_by = bank_bound(loc.valid, loc.index, BATCH, 64,
                                         rig.num_objects)

    # kernels a frame and idle share, with bodies and without
    plain, _ = serving_engine(rig, bcfg, Rs, ts, None)
    with GcPauses():
        t0 = time.perf_counter()
        for f in frames[:BODY_FRAMES]:
            plain.process_frame(f, 1 / 60)
        fps_plain = BODY_FRAMES / (time.perf_counter() - t0)
    n_prof = 2
    t_prof = time.perf_counter()
    prof = profile_frames(serve_all(per, frames[BODY_FRAMES:BODY_FRAMES
                                                + n_prof], flush=False),
                          n_prof)
    prof_plain = profile_frames(serve_all(
        plain, frames[BODY_FRAMES:BODY_FRAMES + n_prof], flush=False),
        n_prof)
    t_prof = time.perf_counter() - t_prof
    idle = print_profile("[10a] profiled process_frame, body rig (host "
                         "detection, per frame):", prof, 1e3 / fps, n_prof)
    idle_plain = print_profile("[10a] profiled process_frame, the same rig "
                               "without templates:", prof_plain,
                               1e3 / fps_plain, n_prof)
    print(f"[10a] body rig (16 slots, I=3 body slots, M=64): per frame "
          f"{fps:.1f} frames/s after the first {WARM_FRAMES} (idle share "
          f"{idle:.3f}, {prof[1]:.1f} kernels a frame), without templates "
          f"{fps_plain:.1f} frames/s (idle {idle_plain:.3f}, "
          f"{prof_plain[1]:.1f} kernels a frame); batched B={BATCH} "
          f"{fps_b:.1f} frames/s over {BODY_BATCHES} batches, its first "
          f"{BODY_FRAMES} payloads bitwise equal to per-frame serving")
    print(f"[10a] against the truth over {n_set} frames: both props fit in "
          f"{both}; {summary['fit']}; {summary['track']}; {spare} spare-"
          f"slot fits of A on other markers; card vs CPU body stage over "
          f"{BODY_CPU_FRAMES} frames: validity equal, max_abs_err "
          f"{worst:.2e}; kalman_bank at M=64 (served candidates, B={BATCH} "
          f"and B=1 random) max_abs_err {bank_err}, on the served "
          f"candidates {bank64_ms:.4f} ms (plain {bank64_plain:.4f} ms, "
          f"bound {bank64_bound:.3e} ms by {bank64_by})")
    print(f"[10a] engine stages, per frame (mean ms): {stage_means(per)}")
    print(f"[10a] took {time.perf_counter() - t_all:.1f} s (the two "
          f"profiles {t_prof:.1f} s of it)")
    return launches, bank_err, {"fps": fps, "fps_plain": fps_plain,
                                "fps_batched": fps_b,
                                "kernels": prof[1],
                                "kernels_plain": prof_plain[1]}


def phase_learn(rig, cfg, Rs, ts):
    """[10b] learn-body-template on the card: LEARN_FRAMES frames of prop A
    alone (per-frame serving, readback depth 2, so rows are in flight when
    the template is applied), stop with ``apply``, then LEARNED_FRAMES
    frames tracked with the learned template."""
    import dataclasses

    bcfg = dataclasses.replace(cfg, max_blobs=16, readback_pipeline_depth=2)
    scene = BodyScene(rig, Rs, ts, props=("A",), drones=False)
    eng, pl = serving_engine(rig, bcfg, Rs, ts, None)
    got, errors = [], []
    eng.on("body-template", got.append)
    eng.on("engine-error", errors.append)
    reset_launches()
    eng.handle("learn-body-template", {"startOrStop": "start"})
    for i in range(LEARN_FRAMES):
        eng.process_frame(scene.read_at(i / 60), 1 / 60)
    t0 = time.perf_counter()
    eng.handle("learn-body-template", {"startOrStop": "stop", "apply": True,
                                       "maxBodies": 1})
    learn_ms = (time.perf_counter() - t0) * 1e3
    n_before = len(pl)
    n = LEARN_FRAMES + LEARNED_FRAMES
    for i in range(LEARN_FRAMES, n):
        eng.process_frame(scene.read_at(i / 60), 1 / 60)
    eng.flush_batches()
    launches = read_launches("[10b]", 0, n)
    check(not errors, f"[10b] engine errors {errors[:3]}")
    check(len(got) == 1 and got[0]["error"] is None and got[0]["applied"],
          f"[10b] body-template events {got}")
    learned = np.asarray(got[0]["markers"], np.float32)
    d_err = float(np.abs(pair_distances(learned) - pair_distances(
        np.asarray(BODY_TMPL_A, np.float32))).max())
    check(learned.shape == (4, 3) and d_err < LEARN_ATOL_M,
          f"[10b] learned distances off by {d_err} m")
    after = pl[n_before:]
    check(all("bodies" not in p for p in pl[:n_before])
          and len(after) == LEARNED_FRAMES
          and all("bodies" in p for p in after),
          "[10b] the row layout did not switch cleanly")
    worst = 0.0
    for i, p in enumerate(after, start=n - LEARNED_FRAMES):
        tb = p["tracked_bodies"]
        check(len(tb) == 1, f"[10b] tracked bodies {tb}")
        mk = learned @ np.asarray(tb[0]["R"]).T + np.asarray(tb[0]["pos"])
        truth = scene.markers("A", i / 60)
        worst = max(worst, float(np.linalg.norm(
            mk[:, None] - truth[None], axis=-1).min(1).max()))
    check(worst < LEARNED_MARKER_M, f"[10b] tracked markers off by {worst}")
    print(f"[10b] learn-body-template over {LEARN_FRAMES} served frames of "
          f"prop A (readback depth 2): {len(learned)} markers from "
          f"{got[0]['frames_used']} frames, pairwise distances within "
          f"{d_err * 1e3:.2f} mm of the template; learn and apply took "
          f"{learn_ms:.1f} ms; the next {LEARNED_FRAMES} frames track it "
          f"with every marker within {worst * 1e3:.2f} mm of the truth; "
          f"kalman_bank {launches[1]} launches")
    return launches


def phase_record(rig, cfg, Rs, ts):
    """[10c] record-frames on the card, replayed through ``RecordedSource``
    into a fresh engine: blobs and object points equal the live run's."""
    import tempfile

    from low_cost_mocap_tpu_torch.runtime.sources import (RecordedSource,
                                                          SyntheticSource)

    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    with tempfile.TemporaryDirectory() as tmp:
        eng, live = serving_engine(rig, cfg, Rs, ts, src, artifacts_dir=tmp)
        recs = []
        eng.on("recording", recs.append)
        reset_launches()
        eng.handle("record-frames", {"startOrStop": "start",
                                     "maxFrames": RECORD_FRAMES})
        outs = [eng.process_frame(src.read_at(i / 60), 1 / 60)
                for i in range(RECORD_FRAMES + 5)]
        eng.handle("record-frames", {"startOrStop": "stop"})
        check(len(recs) == 1 and recs[0]["error"] is None
              and recs[0]["frames"] == RECORD_FRAMES,
              f"[10c] recording events {recs}")
        replay, got = serving_engine(rig, cfg, Rs, ts,
                                     RecordedSource(recs[0]["path"]))
        routs = [replay.process_frame(replay.source.read(), 1 / 60)
                 for _ in range(RECORD_FRAMES)]
        launches = read_launches("[10c]", 0, 2 * RECORD_FRAMES + 5)
        size = os.path.getsize(recs[0]["path"])
    for a, b in zip(routs, outs):
        check(np.array_equal(a.blob_px, b.blob_px)
              and np.array_equal(a.blob_valid, b.blob_valid),
              "[10c] replayed blobs differ")
    check(got == live[:RECORD_FRAMES], "[10c] replayed object points differ")
    print(f"[10c] record-frames: {RECORD_FRAMES} frames recorded "
          f"({size / 1e6:.2f} MB .npz), replayed through RecordedSource into "
          f"a fresh engine: blobs and object-points payloads equal the live "
          f"run's; kalman_bank {launches[1]} launches")
    return launches


def phase_profile(rig, cfg, Rs, ts, events=1, tag="[10d]", ms=PROFILE_MS):
    """[10d] capture-profile while the capture loop serves on the card:
    ``events`` requests one after another on one engine; each ``profile``
    event arrives and its trace lists the bank kernel's launches, made on
    the capture thread.  [10d'] is two such events after the other
    profiler sessions of the process."""
    import tempfile
    import threading

    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    seen = []
    with tempfile.TemporaryDirectory() as tmp:
        eng, pl = serving_engine(rig, cfg, Rs, ts, src)
        got, done = [], threading.Event()
        eng.on("profile", lambda d: (got.append(d), done.set()))
        reset_launches()
        eng.start()
        try:
            time.sleep(1.0)
            for k in range(events):
                done.clear()
                n0 = len(pl)
                eng.handle("capture-profile", {
                    "durationMs": ms, "path": os.path.join(tmp, f"p{k}")})
                check(done.wait(60), f"{tag} no profile event")
                check(got[-1].get("error") is None,
                      f"{tag} profile {k}: {got[-1]}")
                with open(got[-1]["path"]) as f:
                    trace = json.load(f)
                size = os.path.getsize(got[-1]["path"])
                served = len(pl) - n0
                tev = trace.get("traceEvents", [])
                kernels = [e for e in tev if e.get("cat") == "kernel"]
                bank = sum("kalman_bank" in str(e.get("name", ""))
                           for e in kernels)
                span = ((max(e["ts"] + e.get("dur", 0) for e in kernels)
                         - min(e["ts"] for e in kernels)) / 1e3
                        if kernels else 0.0)
                cats = {}
                for e in tev:
                    cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
                seen.append(
                    f"a {size / 1e6:.2f} MB Chrome trace of {len(kernels)} "
                    f"kernels over {span:.1f} ms, {bank} of them "
                    "kalman_bank; "
                    f"events by category {cats}; {served} frames served "
                    "between the request and the event")
                check(bank >= 1, f"{tag} trace {k} lists no kalman_bank "
                      f"launch: {seen[-1]}")
        finally:
            eng.stop()
        launches = read_launches(tag, 0, None)
    print(f"{tag} {events} capture-profile event(s) ({ms} ms each) "
          f"while the capture loop served (the bank kernel launched by the "
          f"capture thread): " + "; then ".join(seen)
          + f"; kalman_bank {launches[1]} launches in the phase")
    return launches


def phase_preprocess(rig, cfg, Rs, ts):
    """[10e] Engine(preprocess_frames=True) on the card: dense frames
    blurred and sharpened (one conv), then the detect_blobs kernel; the
    conv against the CPU port, detection on preprocessed frames against its
    plain version, and the drones tracked within [4]'s bounds."""
    import torch

    from low_cost_mocap_tpu_torch.ops import detect, detect_cuda
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    eng, pl = serving_engine(rig, cfg, Rs, ts, src, preprocess_frames=True)
    check(not eng._fast and not eng._host_detect,
          "[10e] preprocess_frames does not ingest dense frames")
    reset_launches()
    t0 = time.perf_counter()
    for i in range(PREPROCESS_FRAMES):
        eng.process_frame(src.read_at(i / 60), 1 / 60)
    fps = PREPROCESS_FRAMES / (time.perf_counter() - t0)
    launches = read_launches("[10e]", PREPROCESS_FRAMES, PREPROCESS_FRAMES)
    errs, seen = payload_track_errors(src, pl)
    n_late = PREPROCESS_FRAMES - SETTLE_FRAMES
    check(seen >= 0.95 * n_late, f"[10e] both drones tracked in {seen}/"
          f"{n_late} settled frames")
    check(errs.mean() < TRACK_MEAN_M and errs.max() < TRACK_MAX_M,
          f"[10e] tracking error mean {errs.mean():.4f} max "
          f"{errs.max():.4f} m")
    f = torch.from_numpy(src.read_at(0.5)).to(torch.float32) / 255.0
    pre = detect.preprocess(f.to(DEVICE))
    conv_err = max_err(pre.cpu(), detect.preprocess(f))
    check(conv_err <= CONV_ATOL, f"[10e] conv card vs CPU {conv_err}")
    conv_ms = cuda_ms(lambda: detect.preprocess(pre))
    args = (cfg.detect_threshold, cfg.max_blobs, cfg.cc_iters)
    c1, v1, s1 = detect_cuda.find_blobs(pre, *args)
    c2, v2, s2 = detect.find_blobs_multi(pre, *args)
    det_err = max(max_err(c1, c2), max_err(s1, s2))
    check(torch.equal(v1, v2) and det_err <= DETECT_ATOL,
          f"[10e] detect_blobs on preprocessed frames: {det_err}")
    print(f"[10e] Engine(preprocess_frames=True) served {PREPROCESS_FRAMES} "
          f"dense frames at {fps:.1f} frames/s: drones tracked in "
          f"{seen}/{n_late} settled frames, error mean "
          f"{errs.mean() * 1e3:.2f} mm max {errs.max() * 1e3:.2f} mm; the "
          f"13x13 conv {conv_ms:.4f} ms on 4x320x320, {conv_err:.1e} from "
          f"the CPU; detect_blobs on the preprocessed frames == plain "
          f"(valid per camera {v1.sum(1).tolist()}); one launch of each "
          f"kernel a frame")
    return launches, det_err


def calibration(rig, Rs, ts, device):
    """(Ps, K, dist, to-world matrix, Fs) of a rig on ``device``."""
    import torch

    from low_cost_mocap_tpu_torch.ops import camera, correspond

    dev = torch.device(device)
    K = torch.as_tensor(rig.K_stack(), device=dev)
    Ps = camera.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                  torch.as_tensor(ts, device=dev))
    return (Ps, K, torch.as_tensor(rig.dist_stack(), device=dev),
            torch.eye(4, device=dev), correspond._pairwise_fundamentals(Ps))


def tail_kw(rig, cfg, **kw):
    return dict(gate_px=cfg.epipolar_gate_px,
                max_candidates=cfg.max_candidates_per_cam,
                marker_dist1=rig.marker_dist_short,
                marker_dist2=rig.marker_dist_long,
                marker_tol=rig.marker_dist_tol,
                marker_side_min=rig.marker_side_min, **kw)


def host_blobs(frames, cfg):
    """Native host detection of (..., C, H, W) uint8 frames: (..., C, K, 3)
    float32 [x, y, valid]."""
    from low_cost_mocap_tpu_torch.control import bindings
    from low_cost_mocap_tpu_torch.ops import detect

    return bindings.ingest_detect_packed(
        np.asarray(frames), detect.threshold_cutoff(cfg.detect_threshold),
        cfg.max_blobs)


def phase_large_rig(cfg):
    """[11] The 16-camera ring (``EngineConfig`` defaults: K = 8, auto mode,
    which is the assoc matcher; the bank sees M = 128 candidates), two
    drones on the script's orbit: the Engine per frame with host detection
    and batched at B = BATCH (after a warm-up batch), batched payloads
    bitwise equal to per-frame
    ones and tracked against the truth; the card's rows against the port
    on the CPU on the same blobs; the bank at M = 128 against its plain
    chain; ``mode="beam"`` on one frame set, the card against the CPU.
    Returns ({path: (detect, bank) launches}, bank max_abs_err, the
    frames)."""
    import dataclasses

    import torch

    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import camera, correspond, kalman
    from low_cost_mocap_tpu_torch.ops import kalman_cuda
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    t_all = time.perf_counter()
    Rs, ts, rig = syn.ring_rig(num_cameras=LARGE_CAMERAS, image_size=320)
    C, K, O = LARGE_CAMERAS, cfg.max_blobs, rig.num_objects
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    n_b = LARGE_BATCHES * BATCH
    frames = [src.read_at(i / 60) for i in range(n_b)]
    launches = {}

    per, pl = serving_engine(rig, cfg, Rs, ts, src)
    reset_launches()
    with GcPauses():
        stamps = [time.perf_counter()]
        for f in frames[:LARGE_FRAMES]:
            per.process_frame(f, 1 / 60)
            stamps.append(time.perf_counter())
    launches["[11] 16 cameras, per frame"] = read_launches(
        "[11] per frame", 0, LARGE_FRAMES)
    fps = (LARGE_FRAMES - WARM_FRAMES) / (stamps[-1] - stamps[WARM_FRAMES])
    bat, bpl = serving_engine(rig, dataclasses.replace(
        cfg, dispatch_batch=BATCH), Rs, ts, src)
    warm_up_batched(bat, frames, Rs, ts, bpl)
    reset_launches()
    with GcPauses():
        t0 = time.perf_counter()
        for f in frames:
            bat.process_frame(f, 1 / 60)
        bat.flush_batches()
        fps_b = n_b / (time.perf_counter() - t0)
    launches["[11] 16 cameras, batched"] = read_launches(
        "[11] batched", 0, LARGE_BATCHES)
    check(len(pl) == LARGE_FRAMES and len(bpl) == n_b,
          f"[11] events {len(pl)}, {len(bpl)}")
    bitwise = bpl[:LARGE_FRAMES] == pl
    rows_err = compare_payloads(bpl[:LARGE_FRAMES], pl,
                                "[11] batched vs per-frame")
    errs, seen = payload_track_errors(src, bpl)
    n_late = n_b - SETTLE_FRAMES
    check(seen >= LARGE_SEEN * n_late, f"[11] both drones tracked in "
          f"{seen}/{n_late} settled frames")
    check(errs.mean() < TRACK_MEAN_M and errs.max() < TRACK_MAX_M,
          f"[11] tracking error mean {errs.mean():.4f} max "
          f"{errs.max():.4f} m")

    # the card against the port on the CPU, on the same host-detected blobs
    hb = host_blobs(np.stack(frames[:BATCH]), cfg)
    layout = (C, K, O, True)
    rows = {}
    for d in ("cpu", DEVICE):
        cal = calibration(rig, Rs, ts, d)
        st, out = kalman.init_state(O, device=d), []
        b = torch.from_numpy(hb[:LARGE_CPU_FRAMES]).to(d)
        for i in range(LARGE_CPU_FRAMES):
            st, o = pipeline.track_from_blobs(
                st, b[i, ..., :2], b[i, ..., 2] > 0.5, np.float32(1 / 60),
                *cal, **tail_kw(rig, cfg, with_obs=True))
            out.append(pipeline.pack_outputs(o).cpu().numpy())
        rows[d] = np.stack(out)
    worst = 0.0
    for g, w in zip(pipeline.unpack_outputs_batch(rows[DEVICE], *layout),
                    pipeline.unpack_outputs_batch(rows["cpu"], *layout)):
        for a, b in ((g.point_valid, w.point_valid),
                     (g.point_obs_mask, w.point_obs_mask),
                     (g.objects.valid, w.objects.valid),
                     (g.objects.index, w.objects.index),
                     (g.tracked.valid, w.tracked.valid)):
            check(np.array_equal(a, b), "[11] card vs CPU: validity or "
                  "slots differ")
        for a, b in ((g.object_points, w.object_points),
                     (g.point_obs, w.point_obs), *zip(g.tracked, w.tracked)):
            worst = max(worst, float(np.abs(np.asarray(a, np.float64)
                                            - b).max()))
    check(worst <= LARGE_CPU_ATOL, f"[11] card vs CPU max_abs_err {worst}")

    # the bank at M = C * K = 128: the served batch's candidates, and random
    cal = calibration(rig, Rs, ts, DEVICE)
    b = torch.from_numpy(hb).to(DEVICE)
    geo = pipeline._locate_frame(b[..., :2], b[..., 2] > 0.5, *cal,
                                 **tail_kw(rig, cfg))
    loc = geo[3]
    check(loc.valid.shape[-1] == C * K, f"[11] bank width {loc.valid.shape}")
    dts = torch.full((BATCH,), 1 / 60, device=DEVICE)
    cases = [(loc.pos, loc.heading, loc.index, loc.valid, dts)]
    cases += [[torch.from_numpy(a).to(DEVICE) for a in bank_case(B, M=C * K)]
              for B in (BATCH, 1)]
    bank_err = 0.0
    for case in cases:
        st = kalman.init_state(O, device=DEVICE)
        st1, tr1 = kalman_cuda.kalman_scan(st, *case)
        st2, tr2 = kalman.update_scan(st, *case)
        torch.cuda.synchronize()
        check(torch.equal(tr1.valid, tr2.valid)
              and torch.equal(st1.initialized, st2.initialized),
              "[11] kalman_bank M=128: validity")
        bank_err = max(bank_err, max(max_err(a, b) for a, b in zip(
            (*tr1[:3], *st1), (*tr2[:3], *st2))))
    check(bank_err <= BANK_ATOL, f"[11] kalman_bank M=128 max_abs_err "
          f"{bank_err}")
    st0 = kalman.init_state(O, device=DEVICE)
    bank128_ms = cuda_ms(lambda: kalman_cuda.kalman_scan(st0, *cases[0]))
    bank128_plain = cuda_ms(lambda: kalman.update_scan(st0, *cases[0]),
                            runs=3)
    bank128_bound, bank128_by = bank_bound(loc.valid, loc.index, BATCH,
                                           C * K, O)

    # beam mode on one frame set, the card against the CPU
    beam = {}
    for d in ("cpu", DEVICE):
        cal_d = calibration(rig, Rs, ts, d)
        bd = torch.from_numpy(hb[LARGE_CPU_FRAMES]).to(d)
        v = bd[..., 2] > 0.5
        bu = torch.where(v[..., None], camera.undistort_points(
            bd[..., :2], cal_d[1][:, None], cal_d[2][:, None]), 0.0)
        run = lambda: correspond.match_points(   # noqa: E731
            bu, v, cal_d[0], Fs=cal_d[4], mode="beam", with_obs=True)
        beam[d] = {k: x.cpu() for k, x in run().items()}
        if d == DEVICE:
            beam_ms = cuda_ms(run, runs=3)
    check(all(torch.equal(beam["cpu"][k], beam[DEVICE][k])
              for k in ("valid", "obs_mask")), "[11] beam: validity differs "
          "between the card and the CPU")
    beam_err = max(max_err(beam["cpu"][k], beam[DEVICE][k])
                   for k in ("object_points", "obs"))
    check(beam_err <= LARGE_CPU_ATOL, f"[11] beam card vs CPU {beam_err}")

    n_prof = 10
    prof = profile_frames(serve_all(per, frames[LARGE_FRAMES:LARGE_FRAMES
                                                + n_prof]), n_prof)
    prof_b = profile_frames(serve_all(bat, frames[:BATCH]), BATCH)
    idle = print_profile(f"[11] profiled process_frame, {C} cameras, per "
                         "frame:", prof, 1e3 / fps, n_prof)
    idle_b = print_profile(f"[11] profiled process_frame, {C} cameras, one "
                           f"batch of {BATCH}:", prof_b, 1e3 / fps_b, BATCH)
    print(f"[11] {C}-camera rig (K={K}, auto mode = assoc, bank M={C * K}): "
          f"per frame {fps:.1f} frames/s after the first {WARM_FRAMES} "
          f"(idle share {idle:.3f}, {prof[1]:.1f} kernels a frame), batched "
          f"B={BATCH} {fps_b:.1f} frames/s over {LARGE_BATCHES} batches "
          f"(idle {idle_b:.3f}, {prof_b[1]:.1f} kernels a frame), its first "
          f"{LARGE_FRAMES} payloads against per-frame serving: discrete "
          f"fields equal, bitwise {bitwise}, max_abs_err {rows_err}; "
          f"both drones tracked in {seen}/{n_late} settled frames, error "
          f"mean {errs.mean() * 1e3:.2f} mm max {errs.max() * 1e3:.2f} mm")
    print(f"[11] card vs CPU over {LARGE_CPU_FRAMES} frames: validity and "
          f"slots equal, max_abs_err {worst:.2e}; kalman_bank at M={C * K} "
          f"(served candidates B={BATCH}, random B={BATCH} and 1) "
          f"max_abs_err {bank_err}, on the served candidates "
          f"{bank128_ms:.4f} ms (plain {bank128_plain:.2f} ms, bound "
          f"{bank128_bound:.3e} ms by {bank128_by}); beam mode on one frame "
          f"set: "
          f"{int(beam[DEVICE]['valid'].sum())} points, card vs CPU "
          f"validity equal, max_abs_err {beam_err:.2e}, {beam_ms:.1f} ms")
    print(f"[11] engine stages, per frame (mean ms): {stage_means(per)}")
    print(f"[11] took {time.perf_counter() - t_all:.1f} s")
    return launches, bank_err, frames


def drone_truth_world(src, t):
    """The drones' centres at time ``t`` in the world frame of the identity
    to-world matrix ((x, y, z) -> (-x, z, -y)), (2, 3)."""
    gt = np.stack([src.drone_pose(d, t)[0] for d in range(2)])
    return np.stack([-gt[:, 0], gt[:, 2], -gt[:, 1]], axis=1)


def track_ate(tracked, truth, start):
    """ATE (``utils/metrics.ate``) of every valid track from frame
    ``start`` on against the nearest drone's truth."""
    from low_cost_mocap_tpu_torch.utils import metrics

    pos, valid = tracked.pos.cpu().numpy(), tracked.valid.cpu().numpy()
    est, ref = [], []
    for t in range(start, len(truth)):
        for o in np.where(valid[t])[0]:
            j = np.argmin(np.linalg.norm(truth[t] - pos[t, o], axis=1))
            est.append(pos[t, o])
            ref.append(truth[t][j])
    return metrics.ate(np.asarray(est), np.asarray(ref))


def phase_offline(rig, cfg, Rs, ts):
    """[12] Offline processing of a 10 s recording (OFFLINE_FRAMES frame
    sets at 150 frames/s of the drone rig, rendered): ``process_recording``
    from frames (the detection kernel, one launch a chunk; the bank once),
    from host-detected blobs, ``stream_recording`` in blocks of
    OFFLINE_BLOCK (native host detection overlapped), and with
    ``smooth=True``.  The three causal runs' tracks are bitwise equal; the
    smoothed ATE is below the causal one; each kernel against its plain
    version on the path's inputs.  Then ``stream_recording`` with body
    sets over BODY_STREAM_FRAMES frames of [10a]'s scene, bitwise equal to
    the one-shot run at chunks of the block's length.  Returns ({path:
    launches}, (detect err, bank err), the recordings for [16c])."""
    import dataclasses

    import torch

    from low_cost_mocap_tpu_torch.models import offline
    from low_cost_mocap_tpu_torch.ops import detect, detect_cuda, kalman
    from low_cost_mocap_tpu_torch.ops import kalman_cuda
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    t_all = time.perf_counter()
    T = OFFLINE_FRAMES
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    frames = np.stack([src.read_at(i / OFFLINE_FPS) for i in range(T)])
    truth = np.stack([drone_truth_world(src, i / OFFLINE_FPS)
                      for i in range(T)])
    dts = np.full((T,), 1.0 / OFFLINE_FPS, np.float32)
    cal = calibration(rig, Rs, ts, DEVICE)[:4]
    launches, fps, runs = {}, {}, {}

    def timed(name, fn, want_detect, want_bank):
        reset_launches()
        with GcPauses():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            fps[name] = T / (time.perf_counter() - t0)
        launches[f"[12] {name}"] = read_launches(f"[12] {name}", want_detect,
                                                 want_bank)
        runs[name] = out
        return out

    n_chunks = -(-T // OFFLINE_CHUNK)
    timed("process_recording, frames", lambda: offline.process_recording(
        frames, *cal, rig, cfg, dts=dts, chunk=OFFLINE_CHUNK), n_chunks, 1)
    t0 = time.perf_counter()
    blobs, valid = offline.detect_recording_host(frames, cfg.detect_threshold,
                                                 cfg.max_blobs)
    host_s = time.perf_counter() - t0
    timed("process_recording, host blobs", lambda: offline.process_recording(
        (blobs, valid), *cal, rig, cfg, dts=dts, chunk=OFFLINE_CHUNK), 0, 1)
    stats = []
    timed("stream_recording", lambda: offline.stream_recording(
        frames, *cal, rig, cfg, dts=dts, block=OFFLINE_BLOCK,
        stats=stats)[0], 0, -(-T // OFFLINE_BLOCK))
    f0, b0 = kalman_cuda.forward_launches, kalman_cuda.backward_launches
    # the causal bank and the smoother's forward filter, one launch each,
    # and its backward pass, two
    timed("process_recording, smooth", lambda: offline.process_recording(
        (blobs, valid), *cal, rig, cfg, dts=dts, chunk=OFFLINE_CHUNK,
        smooth=True), 0, 4)
    fb = (kalman_cuda.forward_launches - f0,
          kalman_cuda.backward_launches - b0)
    check(fb == (1, 2), "[12] process_recording, smooth: (forward, "
          f"backward) launches {fb}, want (1, 2)")
    ref = runs["process_recording, host blobs"].tracked
    for name, res in runs.items():
        check(all(torch.equal(a, b) for a, b in zip(res.tracked, ref)),
              f"[12] {name}: drone tracks differ from the host-blob run's")
    ate_c = track_ate(ref, truth, SETTLE_FRAMES)
    ate_s = track_ate(runs["process_recording, smooth"].smoothed, truth,
                      SETTLE_FRAMES)
    check(ate_s["mean"] < ate_c["mean"], f"[12] smoothed ATE {ate_s} not "
          f"below the causal {ate_c}")

    # each kernel against its plain version on the paths' inputs
    f = torch.from_numpy(frames[:OFFLINE_CHUNK]).to(DEVICE)
    f = (f.to(torch.float32) * (1.0 / 255.0)).reshape(-1, *f.shape[2:])
    args = (cfg.detect_threshold, cfg.max_blobs, cfg.cc_iters)
    k_out = detect_cuda.find_blobs(f, *args)
    p_out = detect.find_blobs_multi(f, *args)
    torch.cuda.synchronize()
    check(torch.equal(k_out[1], p_out[1]), "[12] detect_blobs validity on "
          "a chunk")
    det_err = max(max_err(a, b) for a, b in zip(k_out, p_out))
    b = torch.from_numpy(blobs).to(DEVICE)
    v = torch.from_numpy(valid).to(DEVICE)
    loc = offline._blob_tail(b, v, *cal, calibration(rig, Rs, ts, DEVICE)[4],
                             rig, cfg)[3]
    d = torch.from_numpy(dts).to(DEVICE)
    st = kalman.init_state(rig.num_objects, device=DEVICE)
    case = (loc.pos, loc.heading, loc.index, loc.valid, d)
    st1, tr1 = kalman_cuda.kalman_scan(st, *case)
    # the plain chain's time: this comparison call, in CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    st2, tr2 = kalman.update_scan(st, *case)
    ev[1].record()
    torch.cuda.synchronize()
    bank_long_plain = ev[0].elapsed_time(ev[1])
    bank_long_bound, bank_long_by = bank_bound(
        loc.valid, loc.index, T, loc.valid.shape[-1], rig.num_objects)
    check(torch.equal(tr1.valid, tr2.valid), "[12] kalman_bank B=1500 "
          "validity")
    bank_err = max(max_err(a, b) for a, b in zip((*tr1[:3], *st1),
                                                  (*tr2[:3], *st2)))
    check(det_err <= DETECT_ATOL and bank_err <= BANK_ATOL,
          f"[12] kernels vs plain: detect {det_err}, bank {bank_err}")
    check(all(torch.equal(a, b) for a, b in zip(tr1, ref)),
          "[12] the long-sequence bank differs from the offline tracks")
    bank_long_ms = cuda_ms(lambda: kalman_cuda.kalman_scan(st, *case),
                           runs=3)
    # the smoother's forward filter on the same inputs: one launch against
    # its plain chain, op by op
    noise = dict(process_noise=cfg.kalman_process_noise,
                 meas_noise=cfg.kalman_measurement_noise)
    f0 = kalman_cuda.forward_launches
    fwd1 = kalman_cuda.forward_scan(st, *case, **noise)
    check(kalman_cuda.forward_launches - f0 == 1, "[12] forward filter: "
          f"{kalman_cuda.forward_launches - f0} launches for one call")
    ev[0].record()
    fwd2 = kalman.forward_filter(st, *case, **noise)
    ev[1].record()
    torch.cuda.synchronize()
    fwd_plain = ev[0].elapsed_time(ev[1])
    check(same_results(fwd1, fwd2), f"[12] kalman_bank forward B={T}: "
          "outputs differ from the plain chain's")
    fwd_ms = cuda_ms(lambda: kalman_cuda.forward_scan(st, *case, **noise),
                     runs=3)
    # its backward pass on the forward filter's output: two launches
    # against its plain version (the gains batched, the sweep op by op)
    _, ((_, xs, Ps), _) = fwd1
    q = dict(process_noise=cfg.kalman_process_noise)
    b0 = kalman_cuda.backward_launches
    bwd1 = kalman_cuda.backward_scan(xs, Ps, d, **q)
    check(kalman_cuda.backward_launches - b0 == 2, "[12] backward pass: "
          f"{kalman_cuda.backward_launches - b0} launches for one call")
    ev[0].record()
    bwd2 = kalman.rts_smooth(xs, Ps, d, **q)
    ev[1].record()
    torch.cuda.synchronize()
    bwd_plain = ev[0].elapsed_time(ev[1])
    check(same_results(bwd1, bwd2), f"[12] backward kernels T={T}: outputs "
          "differ from the plain version's")
    bwd_ms = cuda_ms(lambda: kalman_cuda.backward_scan(xs, Ps, d, **q),
                     runs=3)
    bwd_bound, bwd_by = backward_bound(T, rig.num_objects)

    # body sets, streamed against one-shot, on [10a]'s scene
    brig = dataclasses.replace(rig, body_markers=BODY_TMPL_A, max_bodies=2,
                               body_sets=((BODY_TMPL_B, 1),))
    bcfg = dataclasses.replace(cfg, max_blobs=16)
    scene = BodyScene(brig, Rs, ts)
    bframes = np.stack([scene.read_at(i / 60)
                        for i in range(BODY_STREAM_FRAMES)])
    bd = np.full((BODY_STREAM_FRAMES,), 1 / 60, np.float32)
    sets = brig.body_sets_resolved()
    reset_launches()
    t0 = time.perf_counter()
    b_blobs = offline.detect_recording_host(bframes, bcfg.detect_threshold,
                                            bcfg.max_blobs)
    # chunks as long as the blocks: the body fits' small matmuls are
    # batched over a chunk's frames, so equal batches give equal bits
    one = offline.process_recording(b_blobs, *cal, brig, bcfg, dts=bd,
                                    body_sets=sets, chunk=OFFLINE_BLOCK)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    streamed, _ = offline.stream_recording(bframes, *cal, brig, bcfg, dts=bd,
                                           block=OFFLINE_BLOCK,
                                           body_sets=sets)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    launches["[12] body sets, one-shot + streamed"] = read_launches(
        "[12] body sets", 0, 1 + -(-BODY_STREAM_FRAMES // OFFLINE_BLOCK))
    for name in ("tracked", "bodies", "body_tracks"):
        check(all(torch.equal(a, b) for a, b in zip(
            getattr(streamed, name), getattr(one, name))),
            f"[12] streamed body sets: {name} differ from one-shot")
    check(bool(one.bodies.valid.any(1).float().mean() > 0.9),
          "[12] the body scene's props were not fit")

    st_ = stats[0]
    print(f"[12] offline, {T} frame sets at {OFFLINE_FPS:.0f} frames/s "
          f"(4x320x320 uint8): process_recording from frames "
          f"{fps['process_recording, frames']:.1f} frames/s (detection "
          f"kernel once a chunk of {OFFLINE_CHUNK}); native host detection "
          f"of the recording {T / host_s:.1f} frames/s, then "
          f"process_recording from its blobs "
          f"{fps['process_recording, host blobs']:.1f} frames/s; "
          f"stream_recording (block {OFFLINE_BLOCK}, host detection "
          f"included) {fps['stream_recording']:.1f} frames/s, its host "
          f"detection busy {st_.detect_s:.2f} s of {st_.wall_s:.2f} s wall "
          f"over {st_.blocks} blocks; with smooth=True "
          f"{fps['process_recording, smooth']:.1f} frames/s")
    print(f"[12] the three causal runs' drone tracks bitwise equal; ATE "
          f"after frame {SETTLE_FRAMES}: causal mean "
          f"{ate_c['mean'] * 1e3:.2f} mm (rmse {ate_c['rmse'] * 1e3:.2f}, "
          f"n {ate_c['n']}), smoothed mean {ate_s['mean'] * 1e3:.2f} mm "
          f"(rmse {ate_s['rmse'] * 1e3:.2f}, n {ate_s['n']}); detect_blobs "
          f"on a chunk ({OFFLINE_CHUNK * 4} cameras) == plain, max_abs_err "
          f"{det_err}; kalman_bank B={T} == plain chain, max_abs_err "
          f"{bank_err}, {bank_long_ms:.4f} ms (plain chain "
          f"{bank_long_plain:.1f} ms, one call; bound {bank_long_bound:.3e} "
          f"ms by {bank_long_by}); its forward filter (the smoother's) "
          f"bitwise equal to the plain chain, {fwd_ms:.4f} ms (plain chain "
          f"{fwd_plain:.1f} ms, one call); its backward pass T={T}, "
          f"O={rig.num_objects} bitwise equal to the plain version, "
          f"{bwd_ms:.4f} ms (plain {bwd_plain:.1f} ms, one call; bound "
          f"{bwd_bound:.3e} ms by {bwd_by})")
    print(f"[12] body sets (I=3) over {BODY_STREAM_FRAMES} frames of the "
          f"body scene: one-shot (host detection included) {t_one:.2f} s, "
          f"stream_recording {t_stream:.2f} s, tracks, fits and body "
          f"tracks bitwise equal")
    print(f"[12] took {time.perf_counter() - t_all:.1f} s")
    data = dict(rig=rig, cfg=cfg, frames=frames, blobs=(blobs, valid),
                dts=dts, cal=cal, body=(b_blobs, bd, brig, bcfg, sets))
    return launches, (det_err, bank_err), data


def phase_multirig(cfg):
    """[13] ``batched_track_from_blobs`` over MULTIRIG copies of the drone
    rig, each on a ring of its own radius (its own calibration) with its
    own drones: MULTIRIG_FRAMES steps, every rig's rows bitwise equal to
    its own ``track_from_blobs`` run.  Returns the launches."""
    import torch

    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import kalman
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn
    from low_cost_mocap_tpu_torch.utils import tree

    R, n = MULTIRIG, MULTIRIG_FRAMES
    rigs = [syn.ring_rig(num_cameras=4, image_size=320,
                         radius=2.5 - 0.05 * r) for r in range(R)]
    rig = rigs[0][2]
    blobs = torch.from_numpy(np.stack([host_blobs(np.stack([
        SyntheticSource(rg, Rs, ts, num_drones=2, headings=(0.0, np.pi))
        .read_at(i / 60) for i in range(n)]), cfg) for Rs, ts, rg in rigs]
    )).to(DEVICE)                                         # (R, n, C, K, 3)
    cals = [calibration(rg, Rs, ts, DEVICE) for Rs, ts, rg in rigs]
    stacked = [torch.stack(x) for x in zip(*cals)]
    kw = tail_kw(rig, cfg, with_obs=True)
    dts = torch.full((R,), 1 / 60, device=DEVICE)
    states = tree.stack([kalman.init_state(rig.num_objects, device=DEVICE)
                         for _ in range(R)])
    reset_launches()
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        states, out = pipeline.batched_track_from_blobs(
            states, blobs[:, i, ..., :2], blobs[:, i, ..., 2] > 0.5, dts,
            *stacked, **kw)
        rows.append(pipeline.pack_outputs(out).cpu())
    rate = R * n / (time.perf_counter() - t0)
    launches = read_launches("[13]", 0, R * n)
    for r in range(R):
        st = kalman.init_state(rig.num_objects, device=DEVICE)
        for i in range(n):
            st, out = pipeline.track_from_blobs(
                st, blobs[r, i, ..., :2], blobs[r, i, ..., 2] > 0.5,
                dts[r], *cals[r], **kw)
            check(torch.equal(pipeline.pack_outputs(out).cpu(), rows[i][r]),
                  f"[13] rig {r} frame {i}: batched row differs")
    tracked = torch.stack([row for row in rows])
    print(f"[13] batched_track_from_blobs over {R} rigs (ring radii "
          f"2.50-{2.5 - 0.05 * (R - 1):.2f} m) x {n} frames: "
          f"{rate:.1f} rig-frames/s, every row bitwise equal to the rig's "
          f"own track_from_blobs run; kalman_bank once per rig a frame "
          f"({launches[1]} launches); rows {tuple(tracked.shape)}")
    return launches


def served_rows(eng, frames):
    """Every packed row ``eng`` decodes while it serves ``frames`` (pending
    batches flushed), as (n, L)."""
    rows = capture_rows(eng)
    serve_all(eng, frames)()
    return np.concatenate(rows)


def capture_rows(eng):
    """Every packed row ``eng`` decodes, in order: a list that grows as the
    engine serves (concatenate it for the (n, L) rows)."""
    rows = []
    decode = eng._decode

    def capture(rb):
        outs = decode(rb)
        buf = rb.ring.bufs[rb.slot]
        rows.append(buf.numpy().reshape(-1, buf.shape[-1]).copy())
        return outs

    eng._decode = capture
    return rows


def serve_all(e, fs, flush=True):
    """A function serving ``fs`` through ``e``, pending batches flushed
    unless ``flush`` is False."""
    def run():
        for f in fs:
            e.process_frame(f, 1 / 60)
        if flush:
            e.flush_batches()
    return run


def timed_serve(eng, frames, warm=0):
    """Frames/s of ``eng`` over ``frames`` (after the first ``warm``),
    pending batches flushed."""
    with GcPauses():
        stamps = [time.perf_counter()]
        for f in frames:
            eng.process_frame(f, 1 / 60)
            stamps.append(time.perf_counter())
        eng.flush_batches()
        stamps[-1] = time.perf_counter()
    return (len(frames) - warm) / (stamps[-1] - stamps[warm])


def check_mesh_kernels(tag, frames_b, rig, cfg, Rs, ts, d):
    """The two kernels on a shard's inputs against their plain versions:
    detection on shard 0's cameras of one frame set and of a whole batch,
    the bank on the batch's located candidates.  Returns (detect err, bank
    err)."""
    import torch

    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import detect, detect_cuda, kalman
    from low_cost_mocap_tpu_torch.ops import kalman_cuda

    C = rig.num_cameras
    packed = torch.from_numpy(np.stack([
        detect.pack_frames(f, cfg.detect_threshold) for f in frames_b]))
    args = (0.5, cfg.max_blobs, cfg.cc_iters)
    det_err = 0.0
    for f in (packed[0, :C // d], packed[:, :C // d]):
        x = detect.unpack_bits(f.to(DEVICE)).reshape(-1, *f.shape[-2:-1],
                                                     f.shape[-1] * 8)
        k, p = detect_cuda.find_blobs(x, *args), detect.find_blobs_multi(
            x, *args)
        torch.cuda.synchronize()
        check(torch.equal(k[1], p[1]), f"{tag} detect_blobs validity on a "
              "shard")
        det_err = max(det_err, *(max_err(a, b) for a, b in zip(k, p)))
    hb = torch.from_numpy(host_blobs(np.stack(frames_b), cfg)).to(DEVICE)
    loc = pipeline._locate_frame(hb[..., :2], hb[..., 2] > 0.5,
                                 *calibration(rig, Rs, ts, DEVICE),
                                 **tail_kw(rig, cfg))[3]
    dts = torch.full((len(frames_b),), 1 / 60, device=DEVICE)
    case = (loc.pos, loc.heading, loc.index, loc.valid, dts)
    st = kalman.init_state(rig.num_objects, device=DEVICE)
    st1, tr1 = kalman_cuda.kalman_scan(st, *case)
    st2, tr2 = kalman.update_scan(st, *case)
    torch.cuda.synchronize()
    check(torch.equal(tr1.valid, tr2.valid), f"{tag} kalman_bank validity")
    bank_err = max(max_err(a, b) for a, b in zip((*tr1[:3], *st1),
                                                  (*tr2[:3], *st2)))
    check(det_err <= DETECT_ATOL and bank_err <= BANK_ATOL,
          f"{tag} kernels vs plain: detect {det_err}, bank {bank_err}")
    return det_err, bank_err


def phase_mesh(rig, cfg, Rs, ts, frames16):
    """[14a] The drone rig served camera-sharded through
    ``Engine(mesh=make_mesh({"cam": d}, devices=[card] * d))`` for each d
    of MESH_SHARDS: per frame over [4]'s N_FRAMES frames and batched over
    BATCH_ROUNDS batches of BATCH, the packed rows bitwise equal to those
    of [4]'s single-device device-detect engine on the same frames, d
    detection launches a frame (d a batch batched).  [14b] the 16-camera
    ring at cam = 4, batched over [11]'s frames (``frames16``), its rows
    bitwise equal to those of [11]'s single-device host-detect batched
    engine.  The references serve outside every timed window.  Returns
    ({path: launches}, (detect err, bank err), {path: (frames/s, idle
    share, kernels a frame)})."""
    import dataclasses

    import torch

    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    t_all = time.perf_counter()
    card = torch.device(DEVICE)
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    n_b = BATCH_ROUNDS * BATCH
    frames = [src.read_at(i / 60) for i in range(max(N_FRAMES, n_b))]
    bcfg = dataclasses.replace(cfg, dispatch_batch=BATCH)
    # the single-device references, served untimed
    ref_rows = served_rows(device_detect_engine(rig, cfg, Rs, ts, src)[0],
                           frames)
    launches, rates, errs = {}, {}, [(0.0, 0.0)]
    for d in MESH_SHARDS:
        mesh = mesh_lib.make_mesh({"cam": d}, devices=[card] * d)
        tag = f"[14a] cam={d}"
        eng, _ = serving_engine(rig, cfg, Rs, ts, src, mesh=mesh)
        check(eng.device == card and not eng._host_detect,
              f"{tag}: the mesh engine is not on the card's shards")
        rows = capture_rows(eng)
        reset_launches()
        fps = timed_serve(eng, frames[:N_FRAMES], WARM_FRAMES)
        launches[f"{tag}, per frame"] = read_launches(
            f"{tag} per frame", d * N_FRAMES, N_FRAMES)
        check(np.array_equal(np.concatenate(rows), ref_rows[:N_FRAMES]),
              f"{tag}: per-frame rows differ from the single-device rows")
        warm, _ = serving_engine(rig, bcfg, Rs, ts, src, mesh=mesh)
        serve_all(warm, frames[:BATCH])()
        beng, _ = serving_engine(rig, bcfg, Rs, ts, src, mesh=mesh)
        brows = capture_rows(beng)
        reset_launches()
        fps_b = timed_serve(beng, frames[:n_b])
        launches[f"{tag}, batched"] = read_launches(
            f"{tag} batched", d * BATCH_ROUNDS, BATCH_ROUNDS)
        check(np.array_equal(np.concatenate(brows), ref_rows[:n_b]),
              f"{tag}: batched rows differ from the single-device rows")
        n = MESH_PROFILE_FRAMES
        prof = profile_frames(serve_all(eng, frames[:n]), n)
        prof_b = profile_frames(serve_all(beng, frames[:BATCH]), BATCH)
        idle = print_profile(f"{tag} profiled process_frame, per frame:",
                             prof, 1e3 / fps, n)
        idle_b = print_profile(f"{tag} profiled process_frame, one batch "
                               f"of {BATCH}:", prof_b, 1e3 / fps_b, BATCH)
        rates[f"{tag} per frame"] = (fps, idle, prof[1])
        rates[f"{tag} batched"] = (fps_b, idle_b, prof_b[1])
        errs.append(check_mesh_kernels(tag, frames[:BATCH], rig, cfg, Rs,
                                       ts, d))
        print(f"{tag}: per frame {fps:.1f} frames/s after the first "
              f"{WARM_FRAMES} (idle {idle:.3f}, {prof[1]:.1f} kernels a "
              f"frame), batched B={BATCH} {fps_b:.1f} frames/s over "
              f"{BATCH_ROUNDS} batches (idle {idle_b:.3f}, {prof_b[1]:.1f} "
              f"kernels a frame); rows bitwise equal to the single-device "
              f"device-detect engine's ({len(ref_rows)} frames); "
              f"detect_blobs {d} launches a frame ({d} a batch); kernels "
              f"on a shard's inputs == plain")
        print(f"{tag} engine stages, per frame (mean ms): "
              f"{stage_means(eng)}")

    # [14b] the 16-camera ring at cam = 4, batched, on [11]'s frames
    Rs16, ts16, rig16 = syn.ring_rig(num_cameras=LARGE_CAMERAS,
                                     image_size=320)
    src16 = SyntheticSource(rig16, Rs16, ts16, num_drones=2,
                            headings=(0.0, np.pi))
    ref16_rows = served_rows(serving_engine(rig16, bcfg, Rs16, ts16,
                                            src16)[0], frames16)
    mesh = mesh_lib.make_mesh({"cam": 4}, devices=[card] * 4)
    warm, _ = serving_engine(rig16, bcfg, Rs16, ts16, src16, mesh=mesh)
    serve_all(warm, frames16[:BATCH])()
    eng16, pl16 = serving_engine(rig16, bcfg, Rs16, ts16, src16, mesh=mesh)
    rows16 = capture_rows(eng16)
    reset_launches()
    fps16 = timed_serve(eng16, frames16)
    launches["[14b] 16 cameras, cam=4, batched"] = read_launches(
        "[14b]", 4 * BATCH_ROUNDS, BATCH_ROUNDS)
    check(np.array_equal(np.concatenate(rows16), ref16_rows),
          "[14b] sharded rows differ from the single-device rows")
    errs_t, seen = payload_track_errors(src16, pl16)
    check(seen >= LARGE_SEEN * (n_b - SETTLE_FRAMES)
          and errs_t.mean() < TRACK_MEAN_M,
          f"[14b] tracked in {seen} frames, error mean {errs_t.mean():.4f}")
    prof = profile_frames(serve_all(eng16, frames16[:BATCH]), BATCH)
    idle16 = print_profile(f"[14b] profiled process_frame, one batch of "
                           f"{BATCH}:", prof, 1e3 / fps16, BATCH)
    rates["[14b] 16 cameras, cam=4, batched"] = (fps16, idle16, prof[1])
    errs.append(check_mesh_kernels("[14b]", frames16[:BATCH], rig16, cfg,
                                   Rs16, ts16, 4))
    print(f"[14b] {LARGE_CAMERAS}-camera ring at cam=4, batched B={BATCH}: "
          f"{fps16:.1f} frames/s over {BATCH_ROUNDS} batches (idle "
          f"{idle16:.3f}, {prof[1]:.1f} kernels a frame); rows bitwise "
          f"equal to the single-device host-detect engine's; both drones "
          f"tracked in {seen} settled frames, error mean "
          f"{errs_t.mean() * 1e3:.2f} mm")
    print(f"[14a]-[14b] took {time.perf_counter() - t_all:.1f} s")
    return launches, tuple(max(e[i] for e in errs) for i in (0, 1)), rates


def phase_dist_ba(rig, Rs, ts):
    """[14c] ``dist_bundle_adjust`` and ``schur_bundle_adjust`` on [9a]'s
    wand observations from poses 0.02 rad / 3 cm off, on a ``point`` mesh
    of 1 and of BA_SHARDS shards on the card, and of BA_SHARDS on the
    CPU, each BA_ITERS steps (no early stop, so every run's cost is taken
    at the same step): the card's 4-shard cost within BA_RTOL of its
    one-shard cost, the CPU's 4-shard cost within BA_CPU_RTOL of the
    card's, ms per LM iteration (the LM chunks' graphs on the card since
    [17]'s slice; two chunks of ``ba.CHUNK``, one read of done between)."""
    import torch

    from low_cost_mocap_tpu_torch.ops import rotations as rot
    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
    from low_cost_mocap_tpu_torch.parallel.dist_ba import dist_bundle_adjust
    from low_cost_mocap_tpu_torch.parallel.schur_ba import \
        schur_bundle_adjust

    t_all = time.perf_counter()
    card = torch.device(DEVICE)
    pts, mask, _ = wand_capture(rig, Rs, ts, WAND_FRAMES)
    rng = np.random.default_rng(4)
    R0, t0 = Rs[0].copy(), ts[0].copy()
    Rs_g = np.einsum("cij,jk->cik", Rs, R0.T).astype(np.float32)
    ts_g = (ts - np.einsum("cij,j->ci", Rs_g, t0)).astype(np.float32)
    dR = rot.rotvec_to_matrix(torch.as_tensor(rng.normal(
        scale=0.02, size=(rig.num_cameras, 3)).astype(np.float32))).numpy()
    Rs_p = np.einsum("cij,cjk->cik", dR, Rs_g).astype(np.float32)
    ts_p = (ts_g + rng.normal(scale=0.03, size=ts_g.shape)).astype(
        np.float32)
    Rs_p[0], ts_p[0] = np.eye(3, dtype=np.float32), 0
    args = [torch.as_tensor(a) for a in (pts, mask, rig.K_stack(), Rs_p,
                                         ts_p)]
    out = {}
    for name, solver in (("dist", dist_bundle_adjust),
                         ("schur", schur_bundle_adjust)):
        for where, n in (("card", 1), ("card", BA_SHARDS),
                         ("cpu", BA_SHARDS)):
            dev = card if where == "card" else torch.device("cpu")
            mesh = mesh_lib.make_mesh({"point": n}, devices=[dev] * n)
            if where == "card":
                solver(mesh, *args, max_iters=2)       # warm
                torch.cuda.synchronize()
            stats = {}
            t0 = time.perf_counter()
            res = solver(mesh, *args, max_iters=BA_ITERS, ftol=0.0,
                         stats=stats)
            cost = float(res.cost)
            wall = time.perf_counter() - t0
            check(np.isfinite(cost), f"[14c] {name} cost {cost}")
            out[name, where, n] = (cost, wall / stats["iterations"] * 1e3,
                                   stats["iterations"])
        c1 = out[name, "card", 1][0]
        c4 = out[name, "card", BA_SHARDS][0]
        c4_cpu = out[name, "cpu", BA_SHARDS][0]
        gaps = (abs(c4 - c1) / abs(c1), abs(c4_cpu - c4) / abs(c4))
        check(gaps[0] <= BA_RTOL, f"[14c] {name}: cost {c4} on "
              f"{BA_SHARDS} shards vs {c1} on one")
        check(gaps[1] <= BA_CPU_RTOL, f"[14c] {name}: cost {c4_cpu} on the "
              f"CPU vs {c4} on the card, {BA_SHARDS} shards")
        print(f"[14c] {name}_bundle_adjust on {WAND_FRAMES} wand frames: "
              + "; ".join(f"{w} {n} shard{'s' * (n > 1)} cost {c:.4f}, "
                          f"{ms:.2f} ms an iteration over {it}"
                          for (nm, w, n), (c, ms, it) in out.items()
                          if nm == name)
              + f"; relative cost gaps: {BA_SHARDS} vs 1 shard "
              f"{gaps[0]:.2e} (limit {BA_RTOL}), the CPU vs the card "
              f"{gaps[1]:.2e} (limit {BA_CPU_RTOL})")
    print(f"[14c] took {time.perf_counter() - t_all:.1f} s")
    return out


def phase_temporal(rig, cfg, Rs, ts):
    """[14d] [12]'s recording at ``time`` = TIME_SHARDS on the card:
    ``process_sequence`` (detection, one launch a shard, and the geometry
    over each block) bitwise equal to the unsharded call, and
    ``smooth_sharded`` of the causal drone tracks (halo SMOOTH_HALO)
    within SMOOTH_ATOL of ``smooth_reference`` away from the sequence's
    edges.  Returns ({path: launches}, times)."""
    import torch

    from low_cost_mocap_tpu_torch.models import offline, pipeline
    from low_cost_mocap_tpu_torch.ops import detect_cuda
    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
    from low_cost_mocap_tpu_torch.parallel import temporal
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    t_all = time.perf_counter()
    card = torch.device(DEVICE)
    T = OFFLINE_FRAMES
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    frames = np.stack([src.read_at(i / OFFLINE_FPS) for i in range(T)])
    cal = calibration(rig, Rs, ts, DEVICE)
    mesh = mesh_lib.make_mesh({"time": TIME_SHARDS},
                              devices=[card] * TIME_SHARDS)

    def per_frame(block):            # (T', C, H, W) uint8 on the card
        f = block.to(torch.float32) * (1.0 / 255.0)
        c, v, _ = detect_cuda.find_blobs(
            f.reshape(-1, *f.shape[2:]), cfg.detect_threshold,
            cfg.max_blobs, cfg.cc_iters)
        lead = block.shape[:2]
        c, v = c.reshape(*lead, *c.shape[1:]), v.reshape(*lead, -1)
        _, match, pts, loc = pipeline._locate_frame(c, v, *cal,
                                                    **tail_kw(rig, cfg))
        return c, v, pts, match["valid"], loc.pos, loc.valid

    seq = torch.from_numpy(frames)
    per_frame(seq[:8].to(card))                # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = temporal.process_sequence(mesh, seq, per_frame)
    torch.cuda.synchronize()
    ms_seq = (time.perf_counter() - t0) * 1e3
    launches = {"[14d] process_sequence, time=4": read_launches(
        "[14d] process_sequence", TIME_SHARDS, 0)}
    want = per_frame(seq.to(card))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "[14d] process_sequence differs from the unsharded call")

    blobs, valid = offline.detect_recording_host(frames, cfg.detect_threshold,
                                                 cfg.max_blobs)
    tracks = offline.process_recording(
        (blobs, valid), *cal[:4], rig, cfg,
        dts=np.full((T,), 1 / OFFLINE_FPS, np.float32)).tracked.pos
    x = tracks.reshape(T, -1)
    temporal.smooth_sharded(mesh, x[:4 * SMOOTH_HALO], halo=SMOOTH_HALO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm = temporal.smooth_sharded(mesh, x, halo=SMOOTH_HALO)
    torch.cuda.synchronize()
    ms_sharded = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = temporal.smooth_reference(x)
    torch.cuda.synchronize()
    ms_ref = (time.perf_counter() - t0) * 1e3
    err = max_err(sm[SMOOTH_EDGE:-SMOOTH_EDGE], ref[SMOOTH_EDGE:-SMOOTH_EDGE])
    check(err < SMOOTH_ATOL, f"[14d] smooth_sharded vs reference {err}")
    print(f"[14d] process_sequence over {T} frame sets at time="
          f"{TIME_SHARDS} (detection + geometry a block, "
          f"{T // TIME_SHARDS} frame sets = {T // TIME_SHARDS * 4} cameras "
          f"a launch): {ms_seq:.1f} ms, bitwise equal to the unsharded "
          f"call; smooth_sharded (halo {SMOOTH_HALO}) of the {T}x"
          f"{x.shape[1]} causal tracks {ms_sharded:.1f} ms against "
          f"smooth_reference {ms_ref:.1f} ms, max_abs_err {err:.2e} away "
          f"from the first and last {SMOOTH_EDGE} frames")
    print(f"[14d] took {time.perf_counter() - t_all:.1f} s")
    return launches, (mesh, seq, per_frame, x)


def phase_cluster():
    """[14e] ``run_cluster`` on the card: two gloo ranks, both on the card,
    2 local shards each, for live-pipeline, batched-sharded and schur —
    the ranks' results equal each other and a one-process run (for schur,
    one process of the same 4 shards; the detection and bank kernels
    launch in every rank); and one NCCL rank for live-pipeline.  The
    clusters run in two waves, the clusters of a wave side by side (a
    cluster's time is mostly its processes starting).  Two processes on
    one card need its Default compute mode."""
    from concurrent.futures import ThreadPoolExecutor

    from low_cost_mocap_tpu_torch.parallel.multiprocess import run_cluster

    t_all = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    check(mode.splitlines()[:1] == ["Default"], f"[14e] compute mode {mode!r}"
          ": two processes cannot share the card")
    walls = {}

    def cluster(name, n, local, **kw):
        t0 = time.perf_counter()
        res = run_cluster(n, local, device=DEVICE,
                          timeout_s=CLUSTER_TIMEOUT_S, **kw)
        walls[name] = (time.perf_counter() - t0,
                       max(r["wall_s"] for r in res))
        return res

    def wave(specs):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(specs)) as ex:
            futs = {name: ex.submit(cluster, name, *spec[:2], **spec[2])
                    for name, spec in specs.items()}
            out = {name: f.result() for name, f in futs.items()}
        walls[f"wave of {len(specs)}"] = (time.perf_counter() - t0, 0.0)
        return out

    gloo = dict(backend="gloo")
    res = wave({
        "live-pipeline nccl 1x1": (1, 1, dict(solver="live-pipeline",
                                               backend="nccl")),
        "live-pipeline gloo 2x2": (2, 2, dict(solver="live-pipeline",
                                               **gloo)),
        "batched-sharded gloo 1x1": (1, 1, dict(solver="batched-sharded",
                                                 **gloo)),
        "batched-sharded gloo 2x2": (2, 2, dict(solver="batched-sharded",
                                                 **gloo))})
    nccl1 = res["live-pipeline nccl 1x1"][0]
    live = res["live-pipeline gloo 2x2"]
    bat1 = res["batched-sharded gloo 1x1"][0]
    bat = res["batched-sharded gloo 2x2"]
    check(live[0]["global_devices"] == 4
          and live[0]["rows_sha"] == live[1]["rows_sha"]
          == nccl1["rows_sha"], "[14e] live-pipeline: ranks' rows differ "
          "from each other or from the one-process NCCL run")
    check(any(nccl1["tracked_valid"]), "[14e] live-pipeline tracked nothing")
    check(bat[0]["rows_sha"] == bat[1]["rows_sha"] == bat1["rows_sha"]
          and bat[0]["frames_tracked"] >= 7,
          "[14e] batched-sharded: ranks' rows differ")
    for r in (*live, nccl1, *bat, bat1):
        want = ((3 * r["local_devices"], 3) if r["solver"] == "live-pipeline"
                else (r["local_devices"], 1))
        got = (r["launches"]["detect_blobs"], r["launches"]["kalman_bank"])
        check(got == want, f"[14e] {r['solver']} rank {r['process_id']} of "
              f"{r['num_processes']}: launches {got}, want {want}")
    res = wave({"schur gloo 1x4": (1, 4, dict(solver="schur", **gloo)),
                "schur gloo 2x2": (2, 2, dict(solver="schur", **gloo))})
    schur4 = res["schur gloo 1x4"][0]
    schur = res["schur gloo 2x2"]
    check(schur[0]["cost"] == schur[1]["cost"] == schur4["cost"]
          and schur[0]["ts"] == schur[1]["ts"] == schur4["ts"],
          "[14e] schur: ranks' results differ from each other or from one "
          "process of the same 4 shards")
    print(f"[14e] run_cluster on the card ({mode}): live-pipeline 2 gloo "
          f"ranks x 2 shards rows == one NCCL rank's; batched-sharded 2 "
          f"gloo ranks == one process ({bat[0]['frames_tracked']} of 8 "
          f"frames tracked); schur 2 gloo ranks == one process of 4 shards "
          f"(cost {schur4['cost']:.4f}, {schur[0]['ms_per_iter']:.2f} ms an "
          f"iteration); detect_blobs and kalman_bank launched in every "
          f"rank")
    print("[14e] wall s, the clusters of a wave side by side (launch to "
          "results; the workers' own timed part): "
          + "; ".join(f"{k} {a:.1f} ({b:.3f})" for k, (a, b) in
                      walls.items()))
    print(f"[14e] took {time.perf_counter() - t_all:.1f} s")
    return walls


def bits_equal(a, b) -> bool:
    """Float32 rows equal bit for bit (NaN and inf included)."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def op_by_op(name: str):
    """For the "eager" side of a graph-against-eager comparison,
    ``compiled.disable_graphs()`` (the steps called on this thread run op
    by op over their buffers); for the "graph" side, nothing."""
    import contextlib

    from low_cost_mocap_tpu_torch.runtime import compiled

    return (compiled.disable_graphs() if name == "eager"
            else contextlib.nullcontext())


def graph_steps(eng):
    """The compiled steps of ``eng`` that were captured."""
    out = []
    for st in eng._steps.values():
        out += list(getattr(st, "steps", (st,)))
    return [s for s in out if getattr(s, "graph", None) is not None]


def graph_vs_eager(tag, make, frames, want_detect, want_bank, restart=None):
    """Serve ``frames`` through a graph engine and an eager one (``make``
    builds a tracking engine), graph first: rows bitwise equal, the graph
    run's launches held to (``want_detect``, ``want_bank``).  Per frame the
    first WARM_FRAMES are left out of the rate; a batched engine
    (``restart`` given) serves one batch first (the graph's capture, the
    eager step's first allocations), then restarts tracking.  Returns
    ({"graph", "eager"}: frames/s, the graph engine, its launches).  The
    eager engine serves inside ``compiled.disable_graphs()``: its steps run
    op by op over the same buffers."""
    fps, rows, launches = {}, {}, None
    for name in ("graph", "eager"):
        eng = make()
        with op_by_op(name):
            if restart is not None:
                serve_all(eng, frames[:BATCH])()
                restart(eng)
            got = capture_rows(eng)
            reset_launches()
            fps[name] = timed_serve(eng, frames, 0 if restart is not None
                                    else WARM_FRAMES)
        if name == "graph":
            launches = read_launches(f"{tag} graph", want_detect, want_bank)
            g = eng
        rows[name] = np.concatenate(got)
    check(len(rows["graph"]) == len(frames)
          and bits_equal(rows["graph"], rows["eager"]),
          f"{tag}: the graph's rows differ from the eager step's")
    return fps, g, launches


def compiled_calibration(rig, cfg, Rs, ts, src):
    """set_camera_poses between frames (the true poses, [9c]'s perturbed
    ones, the true again): the graph's rows bitwise equal to
    ``track_from_blobs`` called with the same poses' calibration."""
    import torch

    from low_cost_mocap_tpu_torch.models import pipeline

    n = 3 * CAL_FRAMES
    frames = [src.read_at(i / 60) for i in range(n)]
    poses = [(Rs, ts), perturbed_poses(Rs, ts), (Rs, ts)]
    eng, _ = serving_engine(rig, cfg, Rs, ts, src)
    rows = capture_rows(eng)
    for k, (R, t) in enumerate(poses):
        if k:
            eng.set_camera_poses(R, t)
        serve_all(eng, frames[k * CAL_FRAMES:(k + 1) * CAL_FRAMES])()
    blobs = host_blobs(np.stack(frames), cfg)

    def eager_rows(pose_of_frame):
        st, out_rows = pipeline.make_init_state(rig, device=DEVICE), []
        for i, b in enumerate(blobs):
            cal = calibration(rig, *pose_of_frame(i), DEVICE)
            b = torch.from_numpy(b).to(DEVICE)
            st, out = pipeline.track_from_blobs(
                st, b[..., :2], b[..., 2] > 0.5, np.float32(1 / 60), *cal,
                **eng._tail_kw)
            out_rows.append(pipeline.pack_outputs(out).cpu().numpy())
        return np.stack(out_rows)

    got = np.concatenate(rows)
    want = eager_rows(lambda i: poses[i // CAL_FRAMES])
    check(bits_equal(got, want), "[15] calibration: the graph's rows differ "
          "from the eager step's with the same poses")
    mid = slice(CAL_FRAMES, 2 * CAL_FRAMES)
    check(not bits_equal(eager_rows(lambda i: (Rs, ts))[mid], got[mid]),
          "[15] calibration: the perturbed poses changed no row")
    return eng


def compiled_rebuild(rig, cfg, Rs, ts):
    """[10b]'s learn-body-template with apply while rows are in flight
    (readback depth 2), graph and eager: the same template, and after the
    recapture the rows bitwise equal."""
    import dataclasses

    bcfg = dataclasses.replace(cfg, max_blobs=16, readback_pipeline_depth=2)
    scene = BodyScene(rig, Rs, ts, props=("A",), drones=False)
    frames = [scene.read_at(i / 60)
              for i in range(LEARN_FRAMES + LEARNED_FRAMES)]
    res = {}
    for name in ("graph", "eager"):
        eng, _ = serving_engine(rig, bcfg, Rs, ts, None)
        got = []
        eng.on("body-template", got.append)
        rows = capture_rows(eng)
        with op_by_op(name):
            eng.handle("learn-body-template", {"startOrStop": "start"})
            serve_all(eng, frames[:LEARN_FRAMES], flush=False)()
            before = graph_steps(eng)
            eng.handle("learn-body-template", {"startOrStop": "stop",
                                               "apply": True,
                                               "maxBodies": 1})
            n0 = len(rows)
            serve_all(eng, frames[LEARN_FRAMES:])()
        res[name] = (got, np.concatenate(rows[n0:]), eng, before)
    (tg, rg, eng, before), (te, re_, _, _) = res["graph"], res["eager"]
    check(len(tg) == 1 and tg[0].get("applied") and tg == te,
          f"[15] rebuild: templates {tg} and {te}")
    after = graph_steps(eng)
    check(len(rg) == LEARNED_FRAMES and eng._layout[4] == 1
          and rg.shape[1] == eng._row_ring.bufs[0].shape[-1]
          and before and after and not set(map(id, before))
          & set(map(id, after)),
          "[15] rebuild: the new layout was not served by new graphs")
    check(bits_equal(rg, re_), "[15] rebuild: the rows after the recapture "
          "differ from the eager step's")
    return eng


def compiled_pipeline(rig, cfg, Rs, ts, src):
    """``MocapPipeline.step`` (dense uint8 frames, blurred and sharpened
    first) against ``frame_step`` called op by op: outputs bitwise
    equal."""
    import torch

    from low_cost_mocap_tpu_torch.models import pipeline

    pipe = pipeline.MocapPipeline(rig, cfg, Rs, ts, device=DEVICE)
    st = pipe.init_state()
    st_e = pipeline.make_init_state(rig, device=DEVICE)
    cal = (pipe.Ps, pipe.K, pipe.dist, pipe.to_world_matrix, pipe.Fs)
    for i in range(PIPE_FRAMES):
        f = src.read_at(i / 60)
        st, out = pipe.step(st, f, np.float32(1 / 60))
        st_e, out_e = pipeline.frame_step(
            st_e, torch.from_numpy(f).to(DEVICE), np.float32(1 / 60), *cal,
            **pipe._kw)
        check(bits_equal(pipeline.pack_outputs(out).cpu().numpy(),
                         pipeline.pack_outputs(out_e).cpu().numpy()),
              f"[15] MocapPipeline.step frame {i} differs from frame_step")
    check(len(pipe._steps) == 1 and all(
        s.graph is not None for s in pipe._steps.values()),
          "[15] MocapPipeline.step was not captured")
    return list(pipe._steps.values())


def compiled_refuses_a_sync():
    """A step that reads a value back to the host (``float`` of a device
    tensor) wrapped in ``CompiledStep``: its capture raises."""
    import torch

    from low_cost_mocap_tpu_torch.runtime.compiled import CompiledStep

    def syncing(state, x):
        return state * float(x.sum()), x

    step = CompiledStep(syncing, torch.ones(3, device=DEVICE),
                        torch.ones(3, device=DEVICE), name="syncing")
    try:
        step(step.state, torch.ones(3))
        err = None
    except RuntimeError as e:
        err = e
    check(err is not None and step.graph is None,
          "[15] a step that syncs was captured")
    check(float(torch.ones(4, device=DEVICE).sum()) == 4.0,
          "[15] the card does not work after the refused capture")
    print(f"[15] a step that reads a value back to the host: its capture "
          f"raised {type(err).__name__}: {str(err).splitlines()[0][:160]}")


def overflow(frames):
    """Every OVERFLOW_EVERY-th frame set with a lit square in camera 0,
    past the sparse budget: the packed step takes it."""
    out = []
    for i, f in enumerate(frames):
        if i % OVERFLOW_EVERY == OVERFLOW_EVERY - 1:
            f = f.copy()
            f[0, 100:100 + OVERFLOW_PX, 100:100 + OVERFLOW_PX] = 255
        out.append(f)
    return out


def compiled_cases(rig, cfg, Rs, ts):
    """[15]'s serving cases: (tag, engine factory, frames, detect and bank
    launches the graph run must make, restart for a batched engine)."""
    import dataclasses

    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    n, n_b = COMPILED_FRAMES, COMPILED_BATCHES * BATCH
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    frames = [src.read_at(i / 60) for i in range(max(n, n_b))]
    bcfg = dataclasses.replace(cfg, dispatch_batch=BATCH)
    brig = dataclasses.replace(rig, body_markers=BODY_TMPL_A, max_bodies=2,
                               body_sets=((BODY_TMPL_B, 1),))
    bodycfg = dataclasses.replace(cfg, max_blobs=16)
    scene = BodyScene(brig, Rs, ts)
    body_frames = [scene.read_at(i / 60) for i in range(max(n, BATCH))]
    Rs16, ts16, rig16 = syn.ring_rig(num_cameras=LARGE_CAMERAS,
                                     image_size=320)
    src16 = SyntheticSource(rig16, Rs16, ts16, num_drones=2,
                            headings=(0.0, np.pi))
    frames16 = [src16.read_at(i / 60) for i in range(max(n, n_b))]

    def engine(r, c, R, t, s, **kw):
        return lambda: serving_engine(r, c, R, t, s, **kw)[0]

    def restart(R, t):
        def run(eng):
            eng.handle("triangulate-points", {"startOrStop": "stop"})
            start_tracking(eng, R, t)
        return run

    cases = [
        ("[4b] drone rig, host blobs", engine(rig, cfg, Rs, ts, src),
         frames[:n], 0, n, None),
        ("[4] drone rig, sparse + packed", engine(
            rig, cfg, Rs, ts, src, host_detect=False), overflow(frames[:n]),
         n, n, None),
        ("drone rig, dense", engine(rig, cfg, Rs, ts, src, fast_path=False),
         frames[:n], n, n, None),
        ("[4c] drone rig, batched", engine(rig, bcfg, Rs, ts, src),
         frames[:n_b], 0, COMPILED_BATCHES, restart(Rs, ts)),
        ("[10a] body rig, host blobs", engine(brig, bodycfg, Rs, ts, None),
         body_frames[:n], 0, n, None),
        ("[10a] body rig, batched", engine(brig, dataclasses.replace(
            bodycfg, dispatch_batch=BATCH), Rs, ts, None),
         body_frames[:BATCH], 0, 1, restart(Rs, ts)),
        ("[11] 16 cameras, host blobs", engine(rig16, cfg, Rs16, ts16,
                                               src16), frames16[:n], 0, n,
         None),
        ("[11] 16 cameras, batched", engine(rig16, bcfg, Rs16, ts16, src16),
         frames16[:n_b], 0, COMPILED_BATCHES, restart(Rs16, ts16)),
    ]
    return cases


def phase_compiled(rig, cfg, Rs, ts):
    """[15] The compiled steps (CUDA graphs) against the eager step, on the
    drone rig (host blobs, sparse with packed frames among them, dense;
    batched), the body rig and the 16-camera ring (per frame and batched):
    rows bitwise equal over COMPILED_FRAMES frames a kind and
    COMPILED_BATCHES batches of BATCH (one on the body rig); graph and
    eager rates at equal frames; host launches and device kernels a
    graphed frame; a calibration change and a learn-body-template rebuild;
    MocapPipeline; each graph's capture time and pool memory.  Returns
    {path: launches}."""
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    t_all = time.perf_counter()
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    launches, steps = {}, []
    for tag, make, fs, want_d, want_k, rst in compiled_cases(rig, cfg, Rs,
                                                             ts):
        t0 = time.perf_counter()
        fps, g, launches[f"[15] {tag}"] = graph_vs_eager(
            f"[15] {tag}", make, fs, want_d, want_k, rst)
        kinds = sorted(s.name for s in graph_steps(g))
        steps += [(tag, s) for s in graph_steps(g)]
        msg = (f"[15] {tag}: {len(fs)} frames, graph {fps['graph']:.1f} "
               f"frames/s, eager {fps['eager']:.1f} frames/s "
               f"({fps['graph'] / fps['eager']:.2f}x), rows bitwise equal; "
               f"graphs {kinds}")
        if rst is not None and g._tail_kw["body_sets"]:
            # a batch of body frames holds over a million kernel records;
            # [10a] profiles the body rig
            print(f"{msg} ({time.perf_counter() - t0:.1f} s)")
            continue
        m = LAUNCH_FRAMES if rst is None else BATCH
        prof = profile_frames(serve_all(g, fs[:m], flush=False), m)
        print(f"{msg}; a frame: {prof[1]:.1f} device kernels, "
              f"{prof[0]:.3f} ms busy, the host launched {prof[4][0]:.2f} "
              f"kernels and {prof[4][1]:.2f} graphs "
              f"({time.perf_counter() - t0:.1f} s)")
        if rst is None:
            check(sum(prof[4]) <= HOST_LAUNCHES_MAX and prof[4][1] >= 1,
                  f"[15] {tag}: the host launched {prof[4]} (kernels, "
                  f"graphs) a graphed frame")
    eng = compiled_calibration(rig, cfg, Rs, ts, src)
    steps += [("calibration", s) for s in graph_steps(eng)]
    print(f"[15] calibration changed between frames (true, [9c]'s "
          f"perturbed, true poses, {CAL_FRAMES} frames each): the graph's "
          "rows bitwise equal to track_from_blobs with the same poses")
    eng = compiled_rebuild(rig, cfg, Rs, ts)
    steps += [("rebuild", s) for s in graph_steps(eng)]
    print(f"[15] learn-body-template with apply at readback depth 2: the "
          f"same template, new graphs, the {LEARNED_FRAMES} rows after the "
          "recapture bitwise equal to the eager step's")
    steps += [("MocapPipeline", s) for s in compiled_pipeline(
        rig, cfg, Rs, ts, src)]
    print(f"[15] MocapPipeline.step (dense frames, blur + sharpen) over "
          f"{PIPE_FRAMES} frames: outputs bitwise equal to frame_step")
    for tag, s in steps:
        print(f"    capture {tag} / {s.name}: {s.capture_ms:.1f} ms, pool "
              f"{s.pool_bytes / 2**20:.1f} MiB, launches a replay "
              f"(detect_blobs, kalman_bank) {tuple(s.launches_per_replay)}")
    print(f"[15] took {time.perf_counter() - t_all:.1f} s")
    return launches


def print_captures(tag, steps):
    for s in steps:
        if s.graph is None:
            print(f"    capture {tag} / {s.name}: none (a lazy step called "
                  "once, op by op)")
            continue
        print(f"    capture {tag} / {s.name}: {s.capture_ms:.1f} ms, pool "
              f"{s.pool_bytes / 2**20:.1f} MiB, launches a replay "
              f"(detect_blobs, kalman_bank) {tuple(s.launches_per_replay)}")


def phase_mesh_graphs(rig, cfg, Rs, ts, frames16):
    """[16a] The drone rig camera-sharded at cam = 2 and 4 on the one card
    (at cam = 4 named by its index, ``cuda:0``, as the ``cuda`` tests name
    it) and [16b] the 16-camera ring at cam = 4, each served by a graph
    engine and by the same engine inside ``compiled.disable_graphs()``
    (its steps op by op), on the same frames:
    per frame MESH_GRAPH_FRAMES after the first WARM_FRAMES ([16a]), and
    COMPILED_BATCHES batches of BATCH after a warm-up batch; rows bitwise
    equal ([14a]/[14b] hold the graph engines' rows to the single-device
    engines'); graph and eager frames/s, busy ms and idle share a frame,
    the host's kernel and graph launches a frame, each graph's capture ms
    and pool MiB.  Returns {path: launches}."""
    import dataclasses

    import torch

    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    card = torch.device(DEVICE)
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    n, n_b = WARM_FRAMES + MESH_GRAPH_FRAMES, COMPILED_BATCHES * BATCH
    frames = [src.read_at(i / 60) for i in range(max(n, n_b))]
    bcfg = dataclasses.replace(cfg, dispatch_batch=BATCH)
    Rs16, ts16, rig16 = syn.ring_rig(num_cameras=LARGE_CAMERAS,
                                     image_size=320)

    def restart(R, t):
        def run(eng):
            eng.handle("triangulate-points", {"startOrStop": "stop"})
            start_tracking(eng, R, t)
        return run

    cases = []
    for d in MESH_SHARDS:
        # cam = 4 names the card by its index, as the cuda tests do
        dev = torch.device(card.type, 0) if d == 4 else card

        def make(c, d=d, dev=dev):
            mesh = mesh_lib.make_mesh({"cam": d}, devices=[dev] * d)
            return lambda: serving_engine(rig, c, Rs, ts, src, mesh=mesh,
                                          device=dev)[0]
        cases += [(f"[16a] cam={d}, per frame", make(cfg), frames[:n],
                   d * n, n, None),
                  (f"[16a] cam={d}, batched", make(bcfg), frames[:n_b],
                   d * COMPILED_BATCHES, COMPILED_BATCHES, restart(Rs, ts))]
    mesh4 = mesh_lib.make_mesh({"cam": 4}, devices=[card] * 4)
    cases.append((
        "[16b] 16 cameras, cam=4, batched",
        lambda: serving_engine(rig16, bcfg, Rs16, ts16, None,
                               mesh=mesh4)[0],
        frames16[:n_b], 4 * COMPILED_BATCHES, COMPILED_BATCHES,
        restart(Rs16, ts16)))
    launches = {}
    for tag, make, fs, want_d, want_k, rst in cases:
        t0 = time.perf_counter()
        fps, g, launches[tag] = graph_vs_eager(tag, make, fs, want_d, want_k,
                                               rst)
        m = LAUNCH_FRAMES if rst is None else BATCH
        prof = profile_frames(serve_all(g, fs[:m], flush=False), m)
        idle = 1 - prof[0] / (1e3 / fps["graph"])
        print(f"{tag}: {len(fs)} frames, graph {fps['graph']:.1f} frames/s, "
              f"eager {fps['eager']:.1f} frames/s "
              f"({fps['graph'] / fps['eager']:.2f}x), rows bitwise equal; "
              f"a frame: {prof[1]:.1f} device kernels, {prof[0]:.3f} ms "
              f"busy (idle share {idle:.3f}), the host launched "
              f"{prof[4][0]:.2f} kernels and {prof[4][1]:.2f} graphs "
              f"({time.perf_counter() - t0:.1f} s)")
        if rst is None:
            check(sum(prof[4]) <= HOST_LAUNCHES_MAX and prof[4][1] >= 1,
                  f"{tag}: the host launched {prof[4]} (kernels, graphs) a "
                  "graphed frame")
        print_captures(tag, graph_steps(g))
    return launches


def same_results(a, b) -> bool:
    """Every tensor leaf of two results equal bit for bit."""
    import torch

    from low_cost_mocap_tpu_torch.utils import tree

    def bits(x):
        x = x.contiguous()
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


def phase_offline_graphs(data):
    """[16c] Offline processing as graphs against the same calls op by op
    (``compiled.disable_graphs``) on [12]'s recordings: ``process_recording``
    from frames, from host blobs with ``smooth``, from the body scene's
    blobs with body sets and ``smooth``; ``stream_recording`` (a partial
    last block).  Outputs bitwise equal; frames/s of each; busy ms and
    idle share a frame and the host's launches a frame of the drone
    paths.  Then cold calls at a fresh length (OFFLINE_COLD frame sets)
    with the graph caches emptied first, so that they capture every graph
    they use, each against its eager call (not slower, bitwise equal):
    ``process_recording`` from frames and from host blobs with ``smooth``
    (each then at a third length that captures nothing), and
    ``stream_recording`` (its partial last block of a new length, which a
    lazy step runs op by op at its first call).  Each timed call starts
    after a full collection (``GcPauses``: the script keeps every run's
    results, and a full pause over them would land in whichever call
    crosses the collector's threshold) and prints the collector's pauses
    inside it.  Each graph's capture ms and pool MiB.  Returns {path:
    launches}."""
    import torch

    from low_cost_mocap_tpu_torch.models import offline
    from low_cost_mocap_tpu_torch.runtime import compiled

    frames, (blobs, valid), dts, cal = (data[k] for k in (
        "frames", "blobs", "dts", "cal"))
    b_blobs, bd, brig, bcfg, sets = data["body"]
    rig, cfg = data["rig"], data["cfg"]
    T = len(frames)

    def one_shot(f, n, **kw):
        return lambda: offline.process_recording(
            f, *cal, rig, cfg, dts=dts[:n], chunk=OFFLINE_CHUNK, **kw)

    cases = [
        ("process_recording, frames", one_shot(frames, T), T,
         -(-T // OFFLINE_CHUNK), 1),
        # smooth: the causal bank and the forward filter, a launch each,
        # and the backward pass, two
        ("process_recording, host blobs, smooth",
         one_shot((blobs, valid), T, smooth=True), T, 0, 4),
        ("process_recording, body sets, smooth",
         lambda: offline.process_recording(
             b_blobs, *cal, brig, bcfg, dts=bd, chunk=OFFLINE_BLOCK,
             body_sets=sets, smooth=True), len(bd), 0, 4),
        ("stream_recording", lambda: offline.stream_recording(
            frames, *cal, rig, cfg, dts=dts, block=OFFLINE_BLOCK)[0], T, 0,
         -(-T // OFFLINE_BLOCK)),
    ]

    gc_ms = []

    def timed(fn):
        with GcPauses() as gcp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        gc_ms.append(gcp.ms)
        return out, t

    launches = {}
    for name, fn, n, want_d, want_k in cases:
        tag = f"[16c] {name}"
        # captures any new graph (a lazy step, a streamed block, at its
        # second call)
        fn()
        fn()
        reset_launches()
        got, t_graph = timed(fn)
        launches[tag] = read_launches(tag, want_d, want_k)
        with compiled.disable_graphs():
            want, t_eager = timed(fn)
        check(same_results(got, want), f"{tag}: the graphs' outputs differ "
              "from the calls op by op")
        msg = (f"{tag}: {n} frame sets, graph {n / t_graph:.1f} frames/s "
               f"({t_graph * 1e3:.1f} ms), eager {n / t_eager:.1f} frames/s "
               f"({t_eager / t_graph:.2f}x), outputs bitwise equal")
        if "body" in name:
            # ~10,000 kernels a frame: [10a] profiles the body stage
            print(msg)
            continue
        prof = profile_frames(fn, n)
        print(f"{msg}; a frame: {prof[1]:.2f} device kernels, "
              f"{prof[0]:.4f} ms busy (idle share "
              f"{1 - prof[0] / (t_graph * 1e3 / n):.3f}), the host launched "
              f"{prof[4][0]:.3f} kernels and {prof[4][1]:.3f} graphs")
    print_captures("[16c]", offline.cached_steps())
    # cold calls at a fresh length: every graph captured inside the call
    n = OFFLINE_COLD
    for name, kw in (("frames", {}), ("host blobs, smooth",
                                      dict(smooth=True))):
        f = frames[:n] if name == "frames" else (blobs[:n], valid[:n])
        offline.clear_cache()
        got, t_cold = timed(one_shot(f, n, **kw))
        new = [s for s in offline.cached_steps() if s.graph is not None]
        with compiled.disable_graphs():
            want, t_eager = timed(one_shot(f, n, **kw))
        gc_pair = gc_ms[-2:]
        check(same_results(got, want), f"[16c] cold {name}: outputs differ "
              "from the eager call's")
        check(t_cold <= t_eager, f"[16c] cold {name} at {n} frame sets: "
              f"{t_cold * 1e3:.1f} ms, slower than eager "
              f"{t_eager * 1e3:.1f} ms")
        print(f"[16c] process_recording, {name}, {n} frame sets, cold (the "
              f"cache emptied; {len(new)} graphs captured in the call, "
              f"{sum(s.capture_ms for s in new):.1f} ms of captures): "
              f"{t_cold * 1e3:.1f} ms against {t_eager * 1e3:.1f} ms eager "
              f"({t_eager / t_cold:.2f}x; collector pauses inside "
              f"{gc_pair[0]:.1f} and {gc_pair[1]:.1f} ms), outputs bitwise "
              "equal")
        print_captures(f"[16c] cold {name}", new)
        k = len(offline.cached_steps())
        m = OFFLINE_COLD - 2 * OFFLINE_CHUNK - 1
        _, t_warm = timed(one_shot(f[:m] if name == "frames" else
                                   (blobs[:m], valid[:m]), m, **kw))
        check(len(offline.cached_steps()) == k, f"[16c] {name}: a call at {m} "
              "frame sets captured a graph")
        print(f"[16c] process_recording, {name}, {m} frame sets: no new "
              f"graph, {t_warm * 1e3:.1f} ms")
    # stream_recording at the fresh length: the full block captured at its
    # second call, the partial last block of a new length op by op (lazy)
    offline.clear_cache()

    def stream():
        return offline.stream_recording(frames[:n], *cal, rig, cfg,
                                        dts=dts[:n], block=OFFLINE_BLOCK)[0]

    got, t_cold = timed(stream)
    new = [s for s in offline.cached_steps() if s.graph is not None]
    lazy = len(offline.cached_steps()) - len(new)
    with compiled.disable_graphs():
        want, t_eager = timed(stream)
    check(same_results(got, want), "[16c] cold stream_recording: outputs "
          "differ from the eager call's")
    check(t_cold <= t_eager, f"[16c] cold stream_recording at {n} frame "
          f"sets: {t_cold * 1e3:.1f} ms, slower than eager "
          f"{t_eager * 1e3:.1f} ms")
    print(f"[16c] stream_recording, {n} frame sets, cold ({len(new)} graphs "
          f"captured in the call, {sum(s.capture_ms for s in new):.1f} ms "
          f"of captures; {lazy} lazy step(s) run once, op by op): "
          f"{t_cold * 1e3:.1f} ms against {t_eager * 1e3:.1f} ms eager "
          f"({t_eager / t_cold:.2f}x; collector pauses inside "
          f"{gc_ms[-2]:.1f} and {gc_ms[-1]:.1f} ms), outputs bitwise equal")
    print_captures("[16c] cold stream", new)
    return launches


def timed_call(call, runs=1):
    """(the result of the first of ``runs`` calls, the median wall ms of
    each, the card synchronised around it)."""
    import torch

    out, ms = None, []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out = res if out is None else out
    return out, float(np.median(ms))


def solver_vs_eager(tag, call, steps_of, runs=2):
    """[17] A solver's graphs against the same call under
    ``compiled.disable_graphs()`` on the same inputs, its steps' caches
    emptied first: the first call (a lazy loop's first run goes op by op;
    a lazy step's first call too), the second (which captures what the
    first did not), the warm calls (median of ``runs``) and the eager
    call; every output bitwise equal, the same stats.  ``call(stats)``
    runs the solver; ``steps_of()`` lists the cached steps.  Returns a
    dict of the numbers."""
    from low_cost_mocap_tpu_torch.runtime import compiled

    before = compiled.captures
    st = [{}, {}, {}, {}]
    first, first_ms = timed_call(lambda: call(st[0]))
    second, second_ms = timed_call(lambda: call(st[1]))
    captures = compiled.captures - before
    warm, warm_ms = timed_call(lambda: call(st[2]), runs)
    with compiled.disable_graphs():
        eager, eager_ms = timed_call(lambda: call(st[3]))
    check(all(same_results(r, eager) for r in (first, second, warm)),
          f"{tag}: the graphs' outputs differ from the eager call's")
    check(all(x == st[3] for x in st[:3]),
          f"{tag}: stats {st[:3]} against eager {st[3]}")
    steps = [s for s in steps_of() if s.graph is not None]
    check(bool(steps), f"{tag}: no graph was captured")
    res = {"first_ms": first_ms, "second_ms": second_ms, "warm_ms": warm_ms,
           "eager_ms": eager_ms, "captures": captures,
           "capture_ms": sum(s.capture_ms for s in steps),
           "pool_mib": sum(s.pool_bytes for s in steps) / 2**20,
           "stats": st[2]}
    extra = (f"; {st[2]['iterations']} LM iterations, {st[2]['chunks']} "
             f"chunks replayed and {st[2]['reads']} reads of done a call"
             if st[2] else "")
    print(f"{tag}: warm {warm_ms:.1f} ms a call against {eager_ms:.1f} ms "
          f"eager ({eager_ms / warm_ms:.2f}x); at fresh shapes the first "
          f"call {first_ms:.1f} ms, the second {second_ms:.1f} ms "
          f"({captures} capture(s) in the two, {res['capture_ms']:.1f} ms, "
          f"pool {res['pool_mib']:.1f} MiB); outputs bitwise equal{extra}")
    return res


def board_points(n=INTRINSICS_VIEWS, seed=9):
    """[9d]'s board poses, projected: (board (N, 2), (n, N, 2) points)."""
    import torch

    from low_cost_mocap_tpu_torch.ops import rotations
    from low_cost_mocap_tpu_torch.ops.intrinsics import make_grid

    S = 320
    K_t = np.array([[0.8 * S, 0.0, S / 2 + 3.0], [0.0, 0.79 * S, S / 2 - 4.0],
                    [0.0, 0.0, 1.0]])
    board = make_grid(4, 5, 0.05)
    obj3 = np.concatenate([board, np.zeros((len(board), 1))], axis=-1)
    rng = np.random.default_rng(seed)
    views = []
    while len(views) < n:
        rvec = np.deg2rad(rng.uniform(-25, 25, size=3) * [1, 1, 0.7])
        R = rotations.rotvec_to_matrix(torch.as_tensor(rvec)).numpy()
        t = np.array([-0.10 + rng.uniform(-0.02, 0.02),
                      -0.08 + rng.uniform(-0.02, 0.02),
                      rng.uniform(0.5, 0.7)])
        Xc = obj3 @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * [K_t[0, 0], K_t[1, 1]] + K_t[:2, 2]
        views.append(uv + rng.normal(scale=0.1, size=uv.shape))
    return board, np.asarray(views, np.float32)


def differential_blobs(n, max_blobs, seed=0):
    """``utils.differential``'s clean scene (two drones on the reference
    rig, 0.3 px noise) as ``n`` frame sets of (4, max_blobs, 2) blobs and
    (4, max_blobs) validity."""
    from low_cost_mocap_tpu_torch.utils import differential as dif
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = dif.reference_rig()
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n):
        t = f / 60.0
        X = np.concatenate([
            dif.drone_markers_display(dif._pos_a(t), 0.6 * np.sin(0.4 * t),
                                      +1, +0.01, rig),
            dif.drone_markers_display(dif._pos_b(t), -0.5 * np.cos(0.3 * t),
                                      -1, -0.01, rig)])
        pts, mask = syn.observe(dif.display_to_cam(X).astype(np.float32),
                                Rs, ts, rig, noise_px=0.3, rng=rng)
        blobs = np.zeros((4, max_blobs, 2), np.float32)
        valid = np.zeros((4, max_blobs), bool)
        for c in range(4):
            idx = np.flatnonzero(mask[:, c])
            blobs[c, :len(idx)] = pts[idx, c]
            valid[c, :len(idx)] = True
        out.append((blobs, valid))
    return out


def calibration_event_graphs(rig, cfg, Rs, ts):
    """[17a] [9a]'s ``calculate-camera-pose`` through ``Engine.handle`` at
    a fresh bucket, op by op (``compiled.disable_graphs()``) and cold (the
    first of its 8 BA calls op by op, the capture at the second), in turns
    (eager, cold, eager, cold; the LM chunks' cache emptied before each),
    then warm, each event after a full collection (``GcPauses``); the
    poses bitwise equal; the cold events no slower than the eager ones on
    the mean; then a wand capture of SOLVER_FRESH_N frames, in the same
    bucket, captures nothing."""
    import torch

    from low_cost_mocap_tpu_torch.ops import ba
    from low_cost_mocap_tpu_torch.runtime import compiled
    from low_cost_mocap_tpu_torch.runtime.engine import Engine
    from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink

    eng = Engine(rig, cfg, None, CollectingLink(), device=DEVICE)
    events = []
    eng.on("camera-pose", events.append)

    def event(n, seed=0):
        pts, mask, _ = wand_capture(rig, Rs, ts, n, seed=seed)
        wire = {"cameraPoints": wire_points(pts, mask)}
        events.clear()
        with GcPauses():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.handle("calculate-camera-pose", wire)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return [np.asarray([p["R"] for p in e["camera_poses"]])
                for e in events] + [events[-1]["error"]], ms

    # eager, cold, eager, cold: the two sides' means, in turns (the last
    # cold event leaves the graph the warm one replays)
    runs = {"eager": [], "cold": []}
    for side in ("eager", "cold", "eager", "cold"):
        ba.clear_cache()
        before = compiled.captures
        with op_by_op("eager" if side == "eager" else "graph"):
            runs[side].append(event(WAND_FRAMES))
        captured = compiled.captures - before
    want = runs["eager"][0][0]
    warm, warm_ms = event(WAND_FRAMES)
    for got, what in ((r[0], side) for side in runs for r in runs[side]):
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"[17a] the {what} event's poses differ from the eager one's")
    check(all(np.array_equal(a, b) for a, b in zip(warm, want)),
          "[17a] the warm event's poses differ from the eager one's")
    eager_ms = float(np.mean([ms for _, ms in runs["eager"]]))
    cold_ms = float(np.mean([ms for _, ms in runs["cold"]]))
    check(cold_ms <= eager_ms, f"[17a] the cold event at a fresh bucket "
          f"took {cold_ms:.1f} ms, slower than eager {eager_ms:.1f} ms")
    before = compiled.captures
    _, fresh_ms = event(SOLVER_FRESH_N, seed=1)
    check(compiled.captures == before, f"[17a] a {SOLVER_FRESH_N}-frame "
          f"capture (bucket {ba.bucket(SOLVER_FRESH_N)}) captured "
          f"{compiled.captures - before} graphs")
    step = ba.cached_steps()[0]
    print(f"[17a] calculate-camera-pose on {WAND_FRAMES} wand frames "
          f"(bucket {ba.bucket(WAND_FRAMES)}) at a fresh bucket, each side "
          f"twice in turns: cold {cold_ms:.1f} ms ("
          + ", ".join(f"{ms:.1f}" for _, ms in runs["cold"])
          + f"; {captured} capture, {step.capture_ms:.1f} ms, "
          f"pool {step.pool_bytes / 2**20:.1f} MiB) against {eager_ms:.1f} "
          f"ms op by op (" + ", ".join(f"{ms:.1f}" for _, ms in runs["eager"])
          + f"; {eager_ms / cold_ms:.2f}x); warm {warm_ms:.1f} ms "
          f"({eager_ms / warm_ms:.2f}x); poses bitwise equal; "
          f"{SOLVER_FRESH_N} frames in the same bucket {fresh_ms:.1f} ms, "
          "no capture")
    return {"eager_ms": eager_ms, "cold_ms": cold_ms, "warm_ms": warm_ms}


def phase_solver_graphs(rig, cfg, Rs, ts, temporal_data):
    """[17] The solvers' compiled programs as CUDA graphs against the same
    calls under ``compiled.disable_graphs()``: [17a] [9a]'s event cold at a
    fresh bucket, warm, and at another size in the bucket; [17b]
    ``bundle_adjust`` (free and focals frozen), ``dist_bundle_adjust`` and
    ``schur_bundle_adjust`` (1 shard; BA_SHARDS shards on "cuda" and
    "cuda:0") on [9a]'s wand observations from [14c]'s poses,
    ``calibrate_intrinsics`` on [9d]'s board poses; [17c]
    ``process_sequence`` and ``smooth_sharded`` on [14d]'s recording and
    tracks; [17d] the rts-assoc worker on a one-card time mesh and the
    differential harness's tracking step.  Every output bitwise equal; ms
    a call (first, second, warm, eager), captures, LM chunks and reads.
    Returns {path: launches}."""
    import torch

    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.ops import ba, intrinsics, kalman
    from low_cost_mocap_tpu_torch.ops import rotations as rot
    from low_cost_mocap_tpu_torch.parallel import (dist_ba, multiprocess,
                                                   schur_ba, temporal)
    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
    from low_cost_mocap_tpu_torch.runtime import compiled
    from low_cost_mocap_tpu_torch.utils import differential as dif

    t_all = time.perf_counter()
    card = torch.device(DEVICE)
    calibration_event_graphs(rig, cfg, Rs, ts)

    # [17b] the LM solvers, each from an empty cache
    pts, mask, _ = wand_capture(rig, Rs, ts, WAND_FRAMES)
    rng = np.random.default_rng(4)
    Rs_g = np.einsum("cij,jk->cik", Rs, Rs[0].T).astype(np.float32)
    ts_g = (ts - np.einsum("cij,j->ci", Rs_g, ts[0])).astype(np.float32)
    dR = rot.rotvec_to_matrix(torch.as_tensor(rng.normal(
        scale=0.02, size=(rig.num_cameras, 3)).astype(np.float32))).numpy()
    Rs_p = np.einsum("cij,cjk->cik", dR, Rs_g).astype(np.float32)
    ts_p = (ts_g + rng.normal(scale=0.03, size=ts_g.shape)).astype(
        np.float32)
    Rs_p[0], ts_p[0] = np.eye(3, dtype=np.float32), 0
    A = [torch.as_tensor(a, device=card) for a in (pts, mask, rig.K_stack(),
                                                    Rs_p, ts_p)]
    C = rig.num_cameras
    for freeze in (False, True):
        ba.clear_cache()
        solver_vs_eager(
            f"[17b] bundle_adjust, {WAND_FRAMES} points (bucket "
            f"{ba.bucket(WAND_FRAMES)}), max_iters {cfg.ba_max_iters}"
            + (", focals frozen" if freeze else ""),
            lambda st, f=freeze: ba.bundle_adjust(
                *A, num_cameras=C, max_iters=cfg.ba_max_iters,
                freeze_focals=f, stats=st), ba.cached_steps)
    # the sharded solvers on one shard (one graph a chunk), and on
    # BA_SHARDS shards of a mesh of "cuda" and "cuda:0", two devices that
    # are the one card, laid out as on several cards (a graph per device
    # and phase); BA_SHARDS shards on the repeated card run in [14c]
    for name, mod, solve in (
            ("dist", dist_ba, dist_ba.dist_bundle_adjust),
            ("schur", schur_ba, schur_ba.schur_bundle_adjust)):
        for devs in ([card], [DEVICE, f"{DEVICE}:0"] * (BA_SHARDS // 2)):
            mod._STEPS.clear()
            mesh = mesh_lib.make_mesh({"point": len(devs)}, devices=devs)
            what = ("1 shard" if len(devs) == 1 else
                    f"{len(devs)} shards on {DEVICE!r} and "
                    f"{DEVICE + ':0'!r} (a graph per device and phase)")
            check(dist_ba.layout(mesh, "point")
                  == ("graph" if len(devs) == 1 else "split"),
                  f"[17b] {name}, {what}: layout "
                  f"{dist_ba.layout(mesh, 'point')}")
            solver_vs_eager(
                f"[17b] {name}_bundle_adjust, {what}, {BA_ITERS} LM "
                "iterations (ftol 0)",
                lambda st, m=mesh, s=solve: s(m, *A, max_iters=BA_ITERS,
                                              ftol=0.0, stats=st),
                mod.cached_steps)
    board, views = board_points()
    intrinsics._STEPS.clear()
    solver_vs_eager(
        f"[17b] calibrate_intrinsics, {len(views)} views of "
        f"{views.shape[1]} points",
        lambda st: intrinsics.calibrate_intrinsics(board, views,
                                                   device=card),
        intrinsics.cached_steps)

    # [17c] time sharding on [14d]'s recording
    mesh, seq, per_frame, x = temporal_data
    paths = {}
    for mode in ("graph", "eager"):
        reset_launches()
        with op_by_op(mode):
            timed_call(lambda: temporal.process_sequence(mesh, seq,
                                                         per_frame))
        paths[f"[17c] process_sequence, {mode}"] = read_launches(
            f"[17c] process_sequence, {mode}", TIME_SHARDS, 0)
    temporal._BLOCKS.clear()
    temporal._SMOOTH.clear()
    solver_vs_eager(
        f"[17c] process_sequence, {seq.shape[0]} frame sets at time="
        f"{TIME_SHARDS}",
        lambda st: temporal.process_sequence(mesh, seq, per_frame),
        lambda: [s for s in temporal.cached_steps()
                 if s.name == "process_sequence"])
    solver_vs_eager(
        f"[17c] smooth_sharded, {x.shape[0]}x{x.shape[1]} tracks at time="
        f"{TIME_SHARDS}, halo {SMOOTH_HALO}",
        lambda st: temporal.smooth_sharded(mesh, x, halo=SMOOTH_HALO),
        lambda: [s for s in temporal.cached_steps()
                 if s.name == "smooth_sharded"])

    # [17d] the two helper jits
    mesh1 = mesh_lib.make_mesh({"time": 1}, devices=[card])

    def rts(st):
        r = multiprocess._run_rts_assoc(None, mesh1)
        return (torch.tensor(r["smoothed"]), torch.tensor(r["vs_unsharded"]))

    got = rts({})
    check(got[1] < 1e-4, f"[17d] rts-assoc: {float(got[1])} from the "
          "unsharded smoother")
    steps = []
    real = multiprocess.rts_smooth_assoc_step

    def keep(*a):
        steps.append(real(*a))
        return steps[-1]

    multiprocess.rts_smooth_assoc_step = keep
    try:
        solver_vs_eager("[17d] the rts-assoc worker's rts_smooth_assoc "
                        "(built and captured every call)", rts,
                        lambda: [s for s in steps if s.graph][-1:])
    finally:
        multiprocess.rts_smooth_assoc_step = real
    eng = EngineConfig()
    Rr, tr, rr = dif.reference_rig()
    step = dif.tracking_step(Rr, tr, rr, eng, eng.max_blobs, card)
    frames = differential_blobs(DIFF_FRAMES, eng.max_blobs)

    def track(st):
        state = step.state
        compiled.assign(state, kalman.init_state(2, device=card))
        out = []
        for blobs, valid in frames:
            state, o = step(state, blobs, valid, 1 / 60.0, *step.args[3:])
            out.append((o.tracked.valid.cpu(), o.tracked.pos.cpu()))
        return out

    r = solver_vs_eager(f"[17d] the differential harness's tracking step, "
                        f"{DIFF_FRAMES} frame sets", track, lambda: [step])
    got = track({})
    seen = float(np.mean([bool(v.all()) for v, _ in got[SETTLE_FRAMES:]]))
    check(seen >= LARGE_SEEN, f"[17d] both drones tracked in {seen:.2f} of "
          "the frame sets after the first SETTLE_FRAMES")
    print(f"[17d] tracking step: {r['warm_ms'] / DIFF_FRAMES:.3f} ms a frame "
          f"set against {r['eager_ms'] / DIFF_FRAMES:.3f} eager (one read "
          "a frame)")
    print(f"[17] took {time.perf_counter() - t_all:.1f} s")
    return paths


def breakdown_main():
    """One process's first and second ``calculate-camera-pose`` on [9a]'s
    wand capture, each stage timed (the card synchronised around it):
    RANSAC per camera pair (``ransac_fundamental``), the pose bootstrap,
    each ``bundle_adjust`` call, the first call of each linear-algebra
    routine (its library's set-up) and of BA's ``jacfwd`` (the first
    Jacobian: ``torch.func``'s set-up and the first launch of each of its
    kernels), and the LM chunk's capture where there is one.  Prints one
    ``BREAKDOWN {...}`` line.  Works against any checkout of the port:
    ``calibration_breakdown`` runs it in a process of its own."""
    import torch

    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.models import calibrator
    from low_cost_mocap_tpu_torch.ops import ba, ransac
    from low_cost_mocap_tpu_torch.runtime.engine import Engine
    from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    t_proc = time.perf_counter()
    Rs, ts, rig = syn.ring_rig(num_cameras=4, image_size=320)
    pts, mask, _ = wand_capture(rig, Rs, ts, WAND_FRAMES)
    wire = {"cameraPoints": wire_points(pts, mask)}
    log = {}

    def timer(key, fn):
        def wrapped(*a, **kw):
            capturing = torch.cuda.is_current_stream_capturing()
            if not capturing:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if not capturing:
                torch.cuda.synchronize()
                log.setdefault(key, []).append(
                    (time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    ransac.ransac_fundamental = timer("ransac_pair",
                                      ransac.ransac_fundamental)
    calibrator.bootstrap_poses = timer("bootstrap", calibrator.bootstrap_poses)
    ba.bundle_adjust = timer("bundle_adjust", ba.bundle_adjust)
    first = {}
    for name in ("eigh", "svd", "solve_ex", "inv_ex", "inv", "det",
                 "solve"):
        fn = getattr(torch.linalg, name)

        def once(*a, _fn=fn, _name=name, **kw):
            if _name in first or torch.cuda.is_current_stream_capturing():
                return _fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            first[_name] = (time.perf_counter() - t0) * 1e3
            return out
        setattr(torch.linalg, name, once)
    real_jacfwd = ba.jacfwd

    def jacfwd(fn, *a, **kw):
        jf = real_jacfwd(fn, *a, **kw)
        return once_named("jacfwd", jf)

    def once_named(name, fn):
        def call(*a, **kw):
            if name in first or torch.cuda.is_current_stream_capturing():
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            first[name] = (time.perf_counter() - t0) * 1e3
            return out
        return call

    ba.jacfwd = jacfwd
    eng = Engine(rig, EngineConfig(), None, CollectingLink(), device=DEVICE)
    t_start = (time.perf_counter() - t_proc) * 1e3
    events = []
    for k in range(2):
        log.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.handle("calculate-camera-pose", wire)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        steps = getattr(ba, "cached_steps", lambda: [])()
        events.append({
            "total_ms": total, "ransac_pairs_ms": log.get("ransac_pair", []),
            "bootstrap_ms": sum(log.get("bootstrap", [])),
            "ba_calls_ms": log.get("bundle_adjust", []),
            "capture_ms": sum(s.capture_ms or 0.0 for s in steps)
            if k == 0 else 0.0,
            "rest_ms": total - sum(log.get("bootstrap", []))
            - sum(log.get("bundle_adjust", []))})
    print("BREAKDOWN " + json.dumps({
        "package": os.path.abspath(ba.__file__), "setup_ms": t_start,
        "first_linalg_ms": first, "events": events}))


def calibration_breakdown(root):
    """``breakdown_main`` on the checkout at ``root`` (a directory that
    holds its ``low_cost_mocap_tpu_torch``) in a process of its own:
    the parsed ``BREAKDOWN`` dict, printed as [17e]."""
    script = os.path.abspath(__file__)
    code = (f"import runpy; runpy.run_path({script!r})['breakdown_main']()")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"breakdown in {root} failed:\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("BREAKDOWN ")][-1]
    res = json.loads(line[len("BREAKDOWN "):])
    check(res["package"].startswith(os.path.abspath(root)),
          f"breakdown in {root} imported {res['package']}")
    for k, ev in enumerate(res["events"]):
        print(f"[17e] {root}: calculate-camera-pose #{k + 1} in a fresh "
              f"process: {ev['total_ms']:.1f} ms = bootstrap "
              f"{ev['bootstrap_ms']:.1f} (RANSAC a pair "
              + ", ".join(f"{t:.1f}" for t in ev["ransac_pairs_ms"])
              + ") + BA calls " + ", ".join(f"{t:.1f}"
                                            for t in ev["ba_calls_ms"])
              + f" (capture {ev['capture_ms']:.1f} of them) + rest "
              f"{ev['rest_ms']:.1f}")
    print(f"[17e] {root}: first calls (ms, in the first event) of BA's "
          "jacfwd and of the linear-algebra routines: " + ", ".join(
              f"{k} {v:.1f}" for k, v in res["first_linalg_ms"].items())
          + f"; process set-up before the event {res['setup_ms']:.1f} ms")
    return res


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare-with", metavar="DIR",
                    help="also time the kernels of the checkout in DIR "
                    "against this one's, in turns (phase 8)")
    ap.add_argument("--time-kernels", metavar="INPUTS", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.time_kernels:
        time_kernels_main(opts.time_kernels)
        return
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    smi = phase_build()
    Rs, ts, rig = syn.ring_rig(num_cameras=4, image_size=320)
    cfg = EngineConfig()
    frames_np = smoke_frames(rig, Rs, ts, cfg.cc_iters)
    det_err = phase_detect(cfg, frames_np)
    phase_host_detect(cfg, frames_np)
    bank_err = phase_bank()

    # the main paths: each is driven with the launch counts set to 0 just
    # before it and read just after
    paths = {}
    reset_launches()
    eng, src, fps = phase_serve(rig, cfg, Rs, ts)
    paths["[4] per-frame, detection on the card"] = read_launches(
        "[4]", N_FRAMES, N_FRAMES)
    eng_hd, fps_hd = phase_host_serve(rig, cfg, Rs, ts, src)
    paths["[4b] per-frame, host detection, 4 runs"] = (0, 4 * N_FRAMES)
    eng_b, fps_b, fps_ref = phase_batched_engine(rig, cfg, Rs, ts, src)
    paths["[4c] batched Engine, per-frame reference + 2 runs"] = (
        0, BATCH_ROUNDS * BATCH + 2 * BATCH_ROUNDS)
    paths["[4d] server"] = phase_server(rig, cfg, Rs, ts)
    phase_launcher(Rs, ts)     # another process: no launches counted here
    reset_launches()
    batch = phase_batched(rig, cfg, Rs, ts, src)
    paths["[5] batched tail + per-frame checks"] = read_launches(
        "[5]", BATCH, 1 + BATCH)
    # [9] resets and reads the counts around each of its serving paths
    bank9, calib_times = phase_calibration(rig, cfg, Rs, ts)
    paths["[9c] + [9e] refinement and trajectory serving"] = (0, bank9)
    # [10] the body rig and the rest of the Engine's events, likewise.
    # [10d] first: its trace is the process's first profiler session, as a
    # server's first capture-profile is (a CUDA session after others in the
    # same process can lose its kernel records, PERF.md)
    t10 = time.perf_counter()
    paths["[10d] capture-profile"] = phase_profile(rig, cfg, Rs, ts)
    body_paths, bank64_err, _ = phase_bodies(rig, cfg, Rs, ts)
    paths.update(body_paths)
    paths["[10b] learn-body-template"] = phase_learn(rig, cfg, Rs, ts)
    paths["[10c] record-frames and replay"] = phase_record(rig, cfg, Rs, ts)
    paths["[10e] preprocess_frames"], pre_det_err = phase_preprocess(
        rig, cfg, Rs, ts)
    # [10d'] two capture-profile events in a row, after the profiler
    # sessions of [10a] (the repair of a later session losing its kernels)
    paths["[10d'] two capture-profile events"] = phase_profile(
        rig, cfg, Rs, ts, events=2, tag="[10d']", ms=PROFILE_AGAIN_MS)
    print(f"[10] took {time.perf_counter() - t10:.1f} s")
    t11 = time.perf_counter()
    large_paths, bank128_err, frames16 = phase_large_rig(cfg)
    paths.update(large_paths)
    offline_paths, (off_det_err, off_bank_err), offline_data = \
        phase_offline(rig, cfg, Rs, ts)
    paths.update(offline_paths)
    paths["[13] batched_track_from_blobs, 8 rigs"] = phase_multirig(cfg)
    print(f"[11]-[13] took {time.perf_counter() - t11:.1f} s")
    # [14] the parallel/ slice: camera-sharded serving, the distributed
    # solvers, time sharding, and clusters of processes on the card
    t14 = time.perf_counter()
    mesh_paths, (mesh_det_err, mesh_bank_err), _ = phase_mesh(
        rig, cfg, Rs, ts, frames16)
    paths.update(mesh_paths)
    phase_dist_ba(rig, Rs, ts)
    temporal_paths, temporal_data = phase_temporal(rig, cfg, Rs, ts)
    paths.update(temporal_paths)
    phase_cluster()         # other processes: their launches print there
    print(f"[14] took {time.perf_counter() - t14:.1f} s")
    # [15] the compiled steps against the eager step
    paths.update(phase_compiled(rig, cfg, Rs, ts))
    # [16] the camera-sharded steps and offline processing as graphs
    t16 = time.perf_counter()
    paths.update(phase_mesh_graphs(rig, cfg, Rs, ts, frames16))
    paths.update(phase_offline_graphs(offline_data))
    print(f"[16] took {time.perf_counter() - t16:.1f} s")
    # [17] the solvers' compiled programs, and [9a]'s first event broken
    # down in a process of its own
    paths.update(phase_solver_graphs(rig, cfg, Rs, ts, temporal_data))
    calibration_breakdown(os.path.dirname(os.path.abspath(__file__)))
    det_err = max(det_err, pre_det_err, off_det_err, mesh_det_err)
    bank_err = max(bank_err, bank64_err, bank128_err, off_bank_err,
                   mesh_bank_err)
    launches = tuple(int(sum(v[i] for v in paths.values())) for i in (0, 1))
    for name, (d, k) in paths.items():
        print(f"    {name}: detect_blobs {d}, kalman_bank {k} launches")
    print(f"    main paths in all: detect_blobs {launches[0]}, kalman_bank "
          f"{launches[1]}")

    frames, args, cands, report = phase_times(
        rig, cfg, frames_np, batch, launches, (det_err, bank_err))
    idle = phase_breakdown(eng, src, fps, eng_hd, fps_hd[0], eng_b,
                           fps_b["inline"])
    print("[7] serving paths (frames/s, idle share): "
          f"device detect {fps:.1f} ({idle['device detect']:.3f}); host "
          f"detect depth 0 {fps_hd[0]:.1f} ({idle['host detect']:.3f}), "
          f"depth 2 {fps_hd[2]:.1f}; batched B={BATCH} inline "
          f"{fps_b['inline']:.1f} ({idle['batched']:.3f}), emit worker "
          f"{fps_b['emit worker']:.1f}; per-frame host-detect reference "
          f"{fps_ref:.1f}")
    if opts.compare_with:
        phase_compare(opts.compare_with, frames, args, cands,
                      rig.num_objects)
    # last: a refused capture must leave the card working
    compiled_refuses_a_sync()
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
