"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``), builds both hand-written kernels
from ``low_cost_mocap_tpu_torch/csrc/``, and drives the port's live
tracking step at the configuration the repo serves — the reference's
four-camera PS3-Eye rig: 4 cameras, 320x320 frames, 8 blob slots,
cc_iters 24, 2 candidates per camera, 2 drones, batches of 128:

1. build both kernels (in parallel) and print the card;
2. ``detect_blobs`` against its plain PyTorch version on 4x320x320 frames
   with threshold-edge pixels and a line longer than cc_iters, at cc_iters
   24 and at 150 (three passes of the kernel);
3. ``kalman_bank`` against the plain chain at B=128, M=32, O=2 (dropouts,
   association ties, a gap re-seed) and at B=1;
4. per-frame serving: the port's ``Engine.process_frame`` over 300
   deterministic frames of two drones — both kernels launch once per
   frame, the drones are tracked near ground truth;
5. the batched tail: ``scan_track_from_blobs`` at B=128 on blobs the
   detection kernel found, against 128 per-frame ``track_from_blobs`` rows;
6. times beside each kernel's bound: the event window (CUDA events around
   the wrapper, median of 20 calls) and the device time (``torch.profiler``,
   every kernel, memset and copy of 20 calls);
7. where a served frame's time goes: each stage timed alone, then device
   busy time, kernels and copies per frame under ``torch.profiler``;
8. only with ``--compare-with DIR``: phase 6's kernel times for the
   checkout in DIR and for this one, in four processes in turns (old, new,
   new, old) on the same card.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero; without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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
N_FRAMES = 300
WARM_FRAMES = 20     # frames left out of the steady-state frames/s
SETTLE_FRAMES = 60   # frames before the tracking error is held to bounds
BATCH = 128
DEVICE = "cuda"
TIMING_RUNS = 20
BREAKDOWN_FRAMES = 30
# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W): device memory
# 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, used for both
# kernels' scalar work (float32 in the bank, int32 min/select in detection)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


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
    from low_cost_mocap_tpu_torch.ops import native

    t0 = time.perf_counter()
    names = ("detect_blobs", "kalman_bank")
    pending = {n: native.start_build(n) for n in names}   # nvcc in parallel
    for n in names:
        native.finish_build(n, pending[n])
        native.load(n)
    print(f"[1] built {', '.join(names)} in "
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
    return worst


def phase_serve(rig, cfg, Rs, ts):
    import torch

    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman_cuda
    from low_cost_mocap_tpu_torch.runtime.engine import Engine
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource

    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    frames = [src.read_at(i / 60) for i in range(N_FRAMES)]
    eng = Engine(rig, cfg, device=DEVICE)
    eng.set_camera_poses(Rs, ts)
    eng.is_capturing_points = True
    eng.is_triangulating_points = True
    eng.is_locating_objects = True
    payloads = []
    eng.on("object-points", payloads.append)
    d0, k0 = detect_cuda.launches, kalman_cuda.launches
    outs, stamps = [], [time.perf_counter()]
    for f in frames:   # each call ends in a device->host readback
        outs.append(eng.process_frame(f, 1 / 60))
        stamps.append(time.perf_counter())
    check(detect_cuda.launches - d0 == N_FRAMES,
          "detect_blobs did not launch once per frame")
    check(kalman_cuda.launches - k0 == N_FRAMES,
          "kalman_bank did not launch once per frame")
    check(len(payloads) == N_FRAMES, "object-points not emitted per frame")

    errs, seen = [], 0
    for i, out in enumerate(outs[SETTLE_FRAMES:], start=SETTLE_FRAMES):
        gt = np.stack([src.drone_pose(d, i / 60)[0] for d in range(2)])
        gt_w = np.stack([-gt[:, 0], gt[:, 2], -gt[:, 1]], axis=1)  # to_world
        tv = out.tracked.valid
        if tv.all():
            seen += 1
        for o in np.where(tv)[0]:
            d = np.linalg.norm(gt_w - out.tracked.pos[o], axis=1)
            errs.append(d.min())
        check(not tv.all() or np.linalg.norm(
            out.tracked.pos[0] - out.tracked.pos[1]) > 0.3,
            f"frame {i}: both tracks on one drone")
    n_late = N_FRAMES - SETTLE_FRAMES
    errs = np.asarray(errs)
    check(seen >= 0.95 * n_late,
          f"both drones tracked in only {seen}/{n_late} settled frames")
    check(errs.mean() < TRACK_MEAN_M and errs.max() < TRACK_MAX_M,
          f"tracking error mean {errs.mean():.4f} max {errs.max():.4f} m")
    check(all(np.isfinite(o.object_points).all() for o in outs),
          "non-finite object points")
    fps = (N_FRAMES - WARM_FRAMES) / (stamps[-1] - stamps[WARM_FRAMES])
    fps_all = N_FRAMES / (stamps[-1] - stamps[0])
    print(f"[4] served {N_FRAMES} frames through Engine.process_frame: "
          f"{fps:.1f} frames/s after the first {WARM_FRAMES} "
          f"({fps_all:.1f} with them); both drones tracked in "
          f"{seen}/{n_late} settled frames, "
          f"error mean {errs.mean() * 1e3:.2f} mm max "
          f"{errs.max() * 1e3:.2f} mm; one launch of each kernel per frame")
    return eng, src, fps


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
                marker_side_min=rig.marker_side_min)
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
    for g, w in zip(pipeline.unpack_outputs_batch(rows_np, C, Kb, O),
                    pipeline.unpack_outputs_batch(np.stack(per), C, Kb, O)):
        for a, b in ((g.blob_valid, w.blob_valid),
                     (g.point_valid, w.point_valid),
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
                         pipeline.unpack_outputs_batch(rows_np, C, Kb, O)])
               [BATCH // 2:].all()), "batched tail lost a drone")
    print(f"[5] scan_track_from_blobs B={BATCH} == {BATCH} per-frame "
          f"track_from_blobs rows, max_abs_err {worst}")
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


def device_ms(fn, runs=TIMING_RUNS):
    """Device time of one call of ``fn`` under ``torch.profiler``: every
    kernel, memset and copy it puts on the card, summed over ``runs``
    calls and divided by ``runs``.  Returns (ms, {name: ms per call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    per = {e.key[:60]: e.self_device_time_total / 1e3 / runs
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA}
    return sum(per.values()), per


def kernel_times(frames, args, cands, num_objects):
    """Event-window ms (``cuda_ms``) and device ms (``device_ms``) of the
    two kernels' wrappers at the main path's shapes: detection on
    ``frames``, the bank on ``cands`` at B = len(cands[0]) and at B = 1."""
    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman, kalman_cuda

    st = kalman.init_state(num_objects, device=DEVICE)
    one = tuple(c[:1] for c in cands)
    calls = {"detect_blobs": lambda: detect_cuda.find_blobs(frames, *args),
             f"kalman_bank B={len(cands[0])}":
                 lambda: kalman_cuda.kalman_scan(st, *cands),
             "kalman_bank B=1": lambda: kalman_cuda.kalman_scan(st, *one)}
    out = {}
    for name, fn in calls.items():
        dev, per = device_ms(fn)
        out[name] = {"ms": cuda_ms(fn), "device_ms": dev, "device": per}
    return out


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
    times = kernel_times(frames, args, cands, rig.num_objects)
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
    fps_p = B / wall_median(tail_per_frame, runs=3)
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


def phase_breakdown(eng, src, fps):
    """Where a served frame's time goes, on frames after the main path's.

    First each stage of ``Engine.process_frame`` on the host clock with a
    synchronise after it (median over BREAKDOWN_FRAMES).  Then the same
    frames through ``process_frame`` under ``torch.profiler``: device busy
    time, kernels and host<->device copies per frame, and the busiest
    kernels.  The device's idle share is taken against the unprofiled
    per-frame time of phase 4."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import (camera, correspond, detect,
                                              detect_cuda, rigid, world)

    dev, cfg, rig, kw = eng.device, eng.cfg, eng.rig, eng._step_kw
    frames = [src.read_at((N_FRAMES + BATCH + i) / 60)
              for i in range(BREAKDOWN_FRAMES)]
    times: dict[str, list] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    state = eng._kalman_state
    dts = torch.full((1,), 1 / 60, device=dev)
    for f in frames:
        packed = timed("host threshold+pack",
                       lambda: detect.pack_frames(f, cfg.detect_threshold))
        up = timed("upload", lambda: torch.from_numpy(packed).to(dev))
        blobs, bv, _ = timed("detect (unpack + kernel)",
                             lambda: detect_cuda.find_blobs(
                                 detect.unpack_bits(up), 0.5, kw["max_blobs"],
                                 kw["cc_iters"]))
        blobs, bv = blobs[None], bv[None]
        bu = timed("undistort", lambda: torch.where(
            bv[..., None], camera.undistort_points(
                blobs, eng._K[:, None], eng._dist[:, None]), 0.0))
        m = timed("match + triangulate", lambda: correspond.match_points(
            bu, bv, eng._Ps, gate_px=kw["gate_px"],
            max_candidates=kw["max_candidates"], Fs=eng._F))
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
            rig.num_cameras, cfg.max_blobs, rig.num_objects))
    med = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    print(f"[7] per-frame stages, synchronised, median of "
          f"{BREAKDOWN_FRAMES} frames (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
          + f"; sum {sum(med.values()):.3f}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in frames:
            eng.process_frame(f, 1 / 60)
    ev = prof.key_averages()
    n = len(frames)
    dev_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_ev) / 1e3 / n
    kernels = sum(e.count for e in dev_ev if "emcpy" not in e.key
                  and "emset" not in e.key) / n
    copies = sum(e.count for e in dev_ev if "emcpy" in e.key) / n
    wall_ms = 1e3 / fps
    print(f"[7] profiled process_frame: device busy {busy_ms:.3f} ms per "
          f"frame against {wall_ms:.3f} ms per frame unprofiled (idle share "
          f"{1 - busy_ms / wall_ms:.3f}); {kernels:.1f} kernels and "
          f"{copies:.1f} host<->device copies per frame")
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/frame "
              f"{e.count / n:6.1f}x  {e.key[:90]}")


def phase_compare(old_root, frames, args, cands, num_objects):
    """[8] The kernels of another checkout (``old_root``, a directory that
    holds its ``low_cost_mocap_tpu_torch``) against this one's, on the same
    card and the same inputs: four processes in turns, old, new, new, old,
    each building its own kernels and running ``kernel_times``."""
    import tempfile

    import torch

    script = os.path.abspath(__file__)
    here = os.path.dirname(script)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save({"frames": frames.cpu(), "args": list(args),
                    "cands": [c.cpu() for c in cands], "O": num_objects},
                   path)
        for label, root in (("old", old_root), ("new", here), ("new", here),
                            ("old", old_root)):
            code = (f"import runpy, sys; sys.argv = [{script!r}, "
                    f"'--time-kernels', {path!r}]; "
                    f"runpy.run_path({script!r}, run_name='__main__')")
            proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                                  capture_output=True, text=True,
                                  timeout=600)
            check(proc.returncode == 0,
                  f"timing run in {root} failed:\n{proc.stderr[-3000:]}")
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TIMES ")][-1]
            res = json.loads(line[len("TIMES "):])
            check(res["package"].startswith(os.path.abspath(root)),
                  f"timing run in {root} imported {res['package']}")
            runs.append((label, res))
            print_kernel_times(f"[8] {label} ({root})", res["times"])
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


def time_kernels_main(path):
    """``--time-kernels``: ``kernel_times`` on saved inputs, printed as one
    ``TIMES {...}`` line (a process of ``phase_compare``)."""
    import torch

    from low_cost_mocap_tpu_torch.ops import native

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    d = torch.load(path)
    times = kernel_times(d["frames"].to(DEVICE), tuple(d["args"]),
                         tuple(c.to(DEVICE) for c in d["cands"]), d["O"])
    print("TIMES " + json.dumps({"package": os.path.abspath(native.__file__),
                                 "times": times}))


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
    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman_cuda
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    smi = phase_build()
    Rs, ts, rig = syn.ring_rig(num_cameras=4, image_size=320)
    cfg = EngineConfig()
    frames_np = smoke_frames(rig, Rs, ts, cfg.cc_iters)
    det_err = phase_detect(cfg, frames_np)
    bank_err = phase_bank()

    # the main path: per-frame serving, then the batched tail
    detect_cuda.launches = 0
    kalman_cuda.launches = 0
    eng, src, fps = phase_serve(rig, cfg, Rs, ts)
    batch = phase_batched(rig, cfg, Rs, ts, src)
    launches = (detect_cuda.launches, kalman_cuda.launches)
    check(launches[0] == N_FRAMES + BATCH
          and launches[1] == N_FRAMES + 1 + BATCH,
          f"main-path launches {launches}")
    print(f"    main path launches: detect_blobs {launches[0]}, "
          f"kalman_bank {launches[1]}")

    frames, args, cands, report = phase_times(
        rig, cfg, frames_np, batch, launches, (det_err, bank_err))
    phase_breakdown(eng, src, fps)
    if opts.compare_with:
        phase_compare(opts.compare_with, frames, args, cands,
                      rig.num_objects)
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
