"""Live serving at the camera's rate, open loop.

Set-up renders one loop of the scene from the seed (frame sets in host
memory), builds the Engine the configuration names, starts tracking as the
upstream client does (``triangulate-points``, ``locate-objects``), serves
the mix's warm-up frames (the step's capture), and starts tracking afresh.
The window then hands frame set k to ``Engine.process_frame`` at its due
time T0 + k / rate, or at once when the Engine is behind, so that a stall
counts against every frame queued behind it.  A frame's latency runs from
its due time to the Engine's ``object-points`` emit for it; the frames due
in the window that were never emitted (a minute past the close at most)
are failed.

The harness spins between frames, so that the host's idle states stay
out of the latency.

The traced run profiles a few spans of frames through the window and
gives the Engine a stage timer with room for every frame.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from mocapbench.common import scene, trace
from mocapbench.common.bounds import bank_bound
from mocapbench.common.cell import Cell, Run, process_age_s

LATE_S = 60.0   # how long past the window's close a frame may still come


def _wait_until(t: float) -> None:
    """Spin until ``t``: a core that sleeps between frames wakes slower and
    runs slower at first, which the latency would then carry."""
    while time.perf_counter() < t:
        pass


def _traffic(cell: Cell):
    """(rig, engine config, Rs, ts, rate, frames due, one loop of frame
    sets) of a cell, from its files and its seed."""
    from low_cost_mocap_tpu_torch.config import load_config

    tr = cell.traffic
    rig, ecfg = load_config(cell.config_path)
    sc = cell.config["scene"]
    Rs, ts = scene.ring_poses(rig.num_cameras, sc["ring_radius"],
                              sc["ring_height"], sc["target"])
    rate = float(tr["rate_hz"])
    n_due = int(round(cell.seconds * rate))
    loop = scene.wrap(max(n_due, int(tr["warmup_frames"])), rate)
    frames = scene.render(scene.Orbit(cell.seed, rig.num_objects),
                          scene.loop_times(rate, loop), Rs, ts,
                          rig.K_stack(), rig.image_hw())
    return rig, ecfg, Rs, ts, rate, n_due, frames


def control(cell: Cell) -> dict:
    """The control: the reference held in bfloat16 put in the program's
    place, compared as a run compares the program, over the frames a
    run of the cell serves."""
    from mocapbench.reference import compare

    rig, ecfg, Rs, ts, rate, n_due, frames = _traffic(cell)
    want = reference(cell, frames, Rs, ts, rig, ecfg, n_due, 1.0 / rate,
                     lower=False)
    got = reference(cell, frames, Rs, ts, rig, ecfg, n_due, 1.0 / rate,
                    lower=True)
    return compare.live_numbers(compare.as_served(*got, rig.num_objects),
                                *want)


def run(cell: Cell) -> Run:
    import torch

    from low_cost_mocap_tpu_torch.runtime.engine import (
        Engine, camera_poses_to_serializable)
    from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
    tr = cell.traffic
    parts = {"imports": process_age_s()}
    t_part = time.perf_counter()
    rig, ecfg, Rs, ts, rate, n_due, frames = _traffic(cell)
    parts["render"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    dt = 1.0 / rate
    warm = int(tr["warmup_frames"])
    loop = len(frames)

    eng = Engine(rig, ecfg, None, CollectingLink(), device=cell.device,
                 **cell.config.get("engine_args", {}))
    emits = []
    eng.on("object-points",
           lambda p: emits.append((time.perf_counter(), p)))
    poses = camera_poses_to_serializable(Rs, ts)

    def start_tracking():
        eng.handle("triangulate-points", {"startOrStop": "start",
                                          "cameraPoses": poses})
        eng.handle("locate-objects", {"startOrStop": "start"})

    start_tracking()
    parts["engine"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    for k in range(warm):
        eng.process_frame(frames[k % loop], dt)
    parts["warmup"] = time.perf_counter() - t_part
    sampler = record_function = None
    if cell.trace:
        from torch.profiler import record_function

        sampler = trace.Sampler(n_due, int(tr["trace_spans"]),
                                int(tr["trace_frames"]))
        sampler.prime(lambda: [eng.process_frame(frames[k % loop], dt)
                               for k in range(warm, warm + 5)])
    start_tracking()              # a fresh tracker state for the window
    emits.clear()
    eng.timer = timer = _FrameTimer()
    cuda = torch.device(cell.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    if sampler is not None:
        sampler.start()
    gc.collect()
    gc.freeze()        # set-up's objects stay out of the window's collections

    outs = []
    starts = np.full(n_due, np.nan)
    rec_frames, rec_counts = [], []
    setup_s = process_age_s()
    parts["rest"] = setup_s - sum(parts.values())
    t0 = time.perf_counter() + 0.002
    for k in range(n_due):
        due = t0 + k * dt
        if record_function is None:
            _wait_until(due)
        else:
            with record_function("harness.wait_due"):
                _wait_until(due)
        if time.perf_counter() > t0 + cell.seconds + LATE_S:
            break
        recording = sampler is not None and sampler.recording
        if recording:
            c0 = trace.launch_counters()
        timer.frame = k
        starts[k] = time.perf_counter()
        with (record_function("engine.process_frame") if record_function
              else contextlib.nullcontext()):
            out = eng.process_frame(frames[k % loop], dt)
        if out is not None:
            outs.append(out)
        if recording:
            rec_frames.append(k)
            rec_counts.append(trace.launch_counters() - c0)
        if sampler is not None:
            sampler.step()
    if cuda:
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if sampler is not None:
        sampler.stop()
    eng.handle("triangulate-points", {"startOrStop": "stop"})
    del eng
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    dues = t0 + np.arange(n_due) * dt
    n_emit = min(len(emits), n_due)
    lat = np.full(n_due, np.inf)
    lat[:n_emit] = [emits[k][0] - dues[k] for k in range(n_emit)]
    served = [(outs[k], emits[k][1]) if k < n_emit and k < len(outs)
              else None for k in range(n_due)]
    metrics = {"pose_latency_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    lag = (starts - dues)[:n_emit]
    quiet = np.ones(n_emit, bool)
    layer = {}
    spans = []
    if sampler is not None:
        groups = _contiguous(rec_frames, rec_counts)
        if len(groups) != len(sampler.spans_events):
            raise trace.LostRecords(f"{len(sampler.spans_events)} traced "
                                    f"spans for {len(groups)} runs of "
                                    "recorded frames")
        spans = sampler.spans_events
        for events, (ks, counts) in zip(spans, groups):
            calls = trace.spans_named(events, "engine.process_frame")
            if len(calls) != len(ks):
                raise trace.LostRecords("a span lost frame records")
            trace.check_span(events, counts)
        for ks, _ in groups:
            quiet[_disturbed(lag, ks[0], ks[-1])] = False
        layer["span_frames"] = [g[0] for g in groups]
        layer["bank_bound_ms"] = [
            sum(bank_bound(outs[k].objects.valid[None],
                           outs[k].objects.index[None], 1,
                           outs[k].objects.valid.shape[0],
                           rig.num_objects)[0] for k in ks if k < len(outs))
            for ks, _ in groups]

    layer["queue_wait_s"] = lag[quiet]
    layer["stage_ms"] = timer.means_ms(quiet)

    def check() -> dict:
        from mocapbench.reference import compare

        ref = reference(cell, frames, Rs, ts, rig, ecfg, n_due, dt,
                        lower=False)
        return compare.live_numbers(served, *ref)

    return Run(attempted=n_due, failed=n_due - n_emit, setup_s=setup_s,
               metrics=metrics, memory_peak_bytes=int(memory_peak),
               check=check, layer=layer, spans=spans,
               stall_s=sampler.stall_s if sampler is not None else None,
               setup_parts=parts)


def _disturbed(lag, first: int, last: int) -> slice:
    """The frames a traced span disturbs: its own, and those after it until
    one reaches the Engine no later than the frame before the span did
    (the profiler's stop holds the host for a while, and the queue then
    drains)."""
    base = lag[first - 1] if first > 0 else 0.0
    j = last + 1
    while j < len(lag) and lag[j] > base + 1e-3:
        j += 1
    return slice(first, j)


class _FrameTimer:
    """The Engine's stage timer (``record(name, seconds)``), keeping every
    sample of the window with the frame it belongs to."""

    def __init__(self):
        self.frame = -1
        self.samples = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.samples.setdefault(name, []).append((self.frame, seconds))

    def summary(self) -> dict:
        return {k: {"mean_ms": 1e3 * float(np.mean([s for _, s in v])),
                    "n": len(v)} for k, v in self.samples.items()}

    def means_ms(self, keep) -> dict:
        """Mean ms of each stage over the frames ``keep`` (a mask) marks."""
        out = {}
        for name, v in self.samples.items():
            xs = [s for k, s in v if 0 <= k < len(keep) and keep[k]]
            if xs:
                out[name] = 1e3 * float(np.mean(xs))
        return out


def _contiguous(frames: list, counts: list) -> list:
    """Runs of consecutive recorded frames: [[frames, summed counters]]."""
    groups = []
    for k, c in zip(frames, counts):
        if groups and groups[-1][0][-1] == k - 1:
            groups[-1][0].append(k)
            groups[-1][1] += c
        else:
            groups.append([[k], c.copy()])
    return groups


def reference(cell: Cell, frames, Rs, ts, rig, ecfg, n_frames: int,
              dt: float, lower: bool):
    """The reference over the frames served: (``track.locate``'s dict for
    each frame in order, ``track.track``'s TrackedObjects)."""
    import torch

    from mocapbench.reference import track

    device = cell.device
    blobs, valid = track.detect_frames(frames, ecfg.detect_threshold,
                                       ecfg.max_blobs)
    ref_rig = track.Rig.of(rig, ecfg, Rs, ts)
    loc = track.locate(blobs, valid, ref_rig, device, lower=lower)
    order = np.arange(n_frames) % len(frames)
    dts = torch.full((n_frames,), np.float32(dt), device=device)
    tracked = track.track(loc, order, dts, rig.num_objects, device,
                          lower=lower)
    idx = torch.as_tensor(order, device=device)
    return {k: v[idx] for k, v in loc.items()}, tracked

