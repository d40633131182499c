"""Offline processing of a recorded session, call after call.

Set-up renders the mix's recording from the seed (dense uint8 frame sets in
host memory, as ``record-frames`` keeps them) and makes the calls that
capture the program's offline steps.  The window then calls
``models.offline.process_recording`` on the whole recording again and
again, each call from a fresh tracker state with the default ``chunk``,
and copies its causal and smoothed tracks (and its points and located
drones) back to the host.  ``frames_per_s`` is the frame sets of the calls
that completed over the time from the window's start to the last call's
end; a call is not started once the window has closed.

The traced run traces the mix's ``trace_spans`` calls of the window.  A
traced call whose records are not whole is not read at all: after the
window, another call is traced in a profiler session of its own, up to
``TRACE_RETRIES`` times, and the run fails when none is whole.  Every
call's outputs, the retraced ones too, are compared with the reference.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np

from mocapbench.common import scene, trace
from mocapbench.common.bounds import detect_bound
from mocapbench.common.cell import Cell, Run, process_age_s

TRACE_RETRIES = 2   # calls traced again after the window for a lost one


def _traffic(cell: Cell):
    """(rig, engine config, Rs, ts, rate, the recording) of a cell."""
    from low_cost_mocap_tpu_torch.config import load_config

    tr = cell.traffic
    rig, ecfg = load_config(cell.config_path)
    sc = cell.config["scene"]
    Rs, ts = scene.ring_poses(rig.num_cameras, sc["ring_radius"],
                              sc["ring_height"], sc["target"])
    rate = float(tr["rate_hz"])
    frames = scene.render(scene.Orbit(cell.seed, rig.num_objects),
                          scene.loop_times(rate, int(tr["frames"])), Rs, ts,
                          rig.K_stack(), rig.image_hw())
    return rig, ecfg, Rs, ts, rate, frames


def _host(res) -> dict:
    """A call's results on the host."""
    out = {"points": res.object_points, "point_valid": res.point_valid,
           "pos": res.objects_pos, "valid": res.objects_valid}
    for pre, t in (("tracked_", res.tracked), ("smoothed_", res.smoothed)):
        for f in ("pos", "vel", "heading", "valid"):
            out[pre + f] = getattr(t, f)
    return {k: v.cpu().numpy() for k, v in out.items()}


def control(cell: Cell) -> dict:
    """The control: the reference held in bfloat16 in the program's place,
    over the cell's recording, compared as a call of the program is."""
    from mocapbench.reference import compare

    rig, ecfg, Rs, ts, rate, frames = _traffic(cell)
    want = reference(cell, frames, Rs, ts, rig, ecfg, lower=False)
    loc, tracked, smoothed = reference(cell, frames, Rs, ts, rig, ecfg,
                                       lower=True)
    got = {"points": loc["points"], "point_valid": loc["point_valid"],
           "pos": loc["pos"], "valid": loc["valid"]}
    for pre, t in (("tracked_", tracked), ("smoothed_", smoothed)):
        for f in ("pos", "vel", "heading", "valid"):
            got[pre + f] = getattr(t, f)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    return compare.offline_numbers([got], *want)


def reference(cell: Cell, frames, Rs, ts, rig, ecfg, lower: bool):
    """(``track.locate`` over the recording, the causal tracks, the
    smoothed tracks), all from the frames."""
    import torch

    from mocapbench.reference import track

    device = cell.device
    T = len(frames)
    blobs, valid = track.detect_frames(frames, ecfg.detect_threshold,
                                       ecfg.max_blobs)
    ref_rig = track.Rig.of(rig, ecfg, Rs, ts)
    loc = track.locate(blobs, valid, ref_rig, device, lower=lower)
    dts = torch.full((T,), 1.0 / ecfg.target_fps, dtype=torch.float32,
                     device=device)
    tracked = track.track(loc, np.arange(T), dts, rig.num_objects, device,
                          lower=lower)
    smoothed = track.smooth(loc, dts, rig.num_objects,
                            ecfg.kalman_process_noise,
                            ecfg.kalman_measurement_noise, device,
                            lower=lower)
    return loc, tracked, smoothed


def run(cell: Cell) -> Run:
    import torch

    from low_cost_mocap_tpu_torch.models import offline
    from low_cost_mocap_tpu_torch.ops import camera as cam_ops

    tr = cell.traffic
    parts = {"imports": process_age_s()}
    t_part = time.perf_counter()
    rig, ecfg, Rs, ts, rate, frames = _traffic(cell)
    parts["render"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    T = len(frames)
    dev = torch.device(cell.device)
    K = torch.as_tensor(rig.K_stack(), device=dev)
    dist = torch.as_tensor(rig.dist_stack(), device=dev)
    Ps = cam_ops.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                   torch.as_tensor(ts, device=dev))
    M = torch.eye(4, device=dev)

    def call():
        return _host(offline.process_recording(frames, Ps, K, dist, M, rig,
                                               ecfg, smooth=True))

    cuda = dev.type == "cuda"
    parts["device"] = time.perf_counter() - t_part
    t_warm = time.perf_counter()
    for k in range(int(tr["warmup_calls"])):
        t_part = time.perf_counter()
        call()
        parts[f"warmup{k}"] = time.perf_counter() - t_part
    per_call = (time.perf_counter() - t_warm) / max(int(tr["warmup_calls"]),
                                                    1)
    sampler = None
    record_function = None
    if cell.trace:
        from torch.profiler import record_function
        expect = max(int(cell.seconds / max(per_call, 1e-3)), 2)
        sampler = trace.Sampler(expect, int(tr["trace_spans"]), 1)
        sampler.prime(call)
        sampler.start()
    gc.collect()
    gc.freeze()        # set-up's objects stay out of the window's collections

    calls, rec_counts = [], []
    setup_s = process_age_s()
    parts["rest"] = setup_s - sum(parts.values())
    t0 = time.perf_counter()
    t_end = t0
    while time.perf_counter() - t0 < cell.seconds:
        recording = sampler is not None and sampler.recording
        if recording:
            c0 = trace.launch_counters()
        with (record_function("offline.process_recording") if record_function
              else contextlib.nullcontext()):
            calls.append(call())
        t_end = time.perf_counter()
        if recording:
            rec_counts.append(trace.launch_counters() - c0)
        if sampler is not None:
            sampler.step()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans, retraced = [], []
    if sampler is not None:
        sampler.stop()
        if len(sampler.spans_events) != len(rec_counts):
            raise trace.LostRecords(f"{len(sampler.spans_events)} traced "
                                    f"spans for {len(rec_counts)} recorded "
                                    "calls")
        tries = TRACE_RETRIES
        for events, counts in zip(sampler.spans_events, rec_counts):
            while True:
                try:
                    trace.check_span(events, counts)
                    break
                except trace.LostRecords as e:
                    if tries <= 0:
                        raise
                    tries -= 1
                    print(f"mocapbench: a traced call lost records ({e}): "
                          "none of them is read, and another call is "
                          "traced", file=sys.stderr)
                    out, events, counts = trace.record_call(
                        call, "offline.process_recording")
                    retraced.append(out)
            spans.append(events)
    offline.clear_cache()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {"frames_per_s": len(calls) * T / (t_end - t0)}
    layer = {"frames_per_call": T}
    if sampler is not None:
        layer["calls_traced"] = len(spans)
        layer["detect_bound_ms"] = _detect_bound_ms(frames, ecfg, dev)

    def check() -> dict:
        from mocapbench.reference import compare

        ref = reference(cell, frames, Rs, ts, rig, ecfg, lower=False)
        return compare.offline_numbers(calls + retraced, *ref)

    return Run(attempted=len(calls), failed=0, setup_s=setup_s,
               metrics=metrics, memory_peak_bytes=int(memory_peak),
               check=check, layer=layer, spans=spans,
               stall_s=sampler.stall_s if sampler is not None else None,
               setup_parts=parts)


def _detect_bound_ms(frames, ecfg, dev, chunk: int = 32) -> float:
    """The least time of one call's detection launches: one a chunk of
    ``chunk`` frame sets (the last one zero-padded), over the float32
    frames the path hands the kernel."""
    import torch

    T, C, H, W = frames.shape
    total = 0.0
    for lo in range(0, T, chunk):
        part = torch.zeros((chunk, C, H, W), dtype=torch.float32, device=dev)
        n = min(chunk, T - lo)
        part[:n] = (torch.from_numpy(frames[lo:lo + n]).to(dev).float()
                    * (1.0 / 255.0))
        total += detect_bound(part.reshape(chunk * C, H, W),
                              ecfg.detect_threshold, ecfg.cc_iters,
                              ecfg.max_blobs)[0]
    return total
