"""Sampled device traces and the arithmetic the per-layer metrics share.

A traced run profiles a few short spans of steps spread through the
window (``Sampler``, over ``torch.profiler``'s schedule) and keeps each
span's events in memory: no trace is written to disk.  The events become
plain ``Ev`` records, so that everything below runs on recorded events as
well as on live ones.

``check_records`` refuses a span whose records were lost: a session that
lists CUDA calls but no kernel (the program's ``lost_kernels`` test), a
launch with no device record of its own, or kernel and graph records that
disagree with the program's launch counters.
"""

from __future__ import annotations

import time
from typing import NamedTuple

KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCH_APIS = ("cudaGraphLaunch", "cuGraphLaunch")
DEVICE_KINDS = ("kernel", "memcpy", "memset")
MARGIN_S = 0.005   # the host's wait at each end of a traced span


class Ev(NamedTuple):
    """One profiler record.  ``kind``: kernel, memcpy or memset on the
    device; launch, graph or runtime for CUDA API calls on the host; span
    for a ``record_function`` range; cpu for any other host operator.
    Times in ns on the profiler's clock; ``corr`` links a launch to its
    device records (0 when none)."""

    kind: str
    name: str
    start: int
    end: int
    corr: int


def launch_counters():
    """The program's launch counters: (detect_blobs launches, kalman_bank
    launches, graph replays); a replay counts the launches its graph
    holds."""
    import numpy as np

    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman_cuda
    from low_cost_mocap_tpu_torch.runtime import compiled

    return np.array([detect_cuda.launches, kalman_cuda.launches,
                     compiled.replays], np.int64)


def check_span(events, counts) -> None:
    """``check_records`` of one span against the counters' increase over
    it (``launch_counters``)."""
    check_records(events, {"finish_kernel": int(counts[0]),
                           "kalman_bank": int(counts[1])},
                  graph_launches=int(counts[2]))


class LostRecords(RuntimeError):
    """The profiler lost records: a traced run reports no device metric."""


_ANNOTATIONS = ("user_annotation", "gpu_user_annotation")
# ``record_function`` ranges: the benchmark's own and the profiler's steps
SPAN_PREFIXES = ("engine.", "offline.", "harness.", "ProfilerStep#")


def _kind(e, cuda) -> str | None:
    """The ``Ev`` kind of a profiler event, from its device and name (and
    its activity type where the profiler gives one)."""
    name = e.name()
    act = e.activity_type() if hasattr(e, "activity_type") else ""
    if (act in _ANNOTATIONS or name.startswith(SPAN_PREFIXES)
            or (hasattr(e, "is_user_annotation") and e.is_user_annotation())):
        return None if e.device_type() == cuda else "span"
    if e.device_type() == cuda:
        low = name.lower()
        if "memcpy" in low:
            return "memcpy"
        if "memset" in low:
            return "memset"
        return "kernel"
    if name in KERNEL_LAUNCH_APIS:
        return "launch"
    if name in GRAPH_LAUNCH_APIS:
        return "graph"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "runtime"
    return "cpu"


def from_kineto(events) -> list:
    """Profiler events (``_KinetoEvent``) -> ``Ev`` records, by start."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in events:
        kind = _kind(e, cuda)
        if kind is None:
            continue
        start = int(e.start_ns())
        out.append(Ev(kind, e.name(), start, start + int(e.duration_ns()),
                      int(e.correlation_id())))
    out.sort(key=lambda ev: ev.start)
    return out


class Sampler:
    """``spans`` runs of ``active`` consecutive steps, evenly spread over
    ``steps`` steps, each recorded by ``torch.profiler`` (host operators
    and CUDA activity) and kept in memory as ``Ev`` lists (``spans_events``
    after ``stop``).  Call ``step()`` after every step; ``recording`` says
    whether the step about to run is recorded."""

    def __init__(self, steps: int, spans: int, active: int):
        cycle = max(steps // max(spans, 1), active + 1)
        self.active = active
        self.spans = max(min(spans, steps // cycle), 1)
        self.wait = cycle - active - 1
        self._results = []
        self._prof = None
        self.spans_events = []
        self.stall_s = 0.0      # the longest ``step``: a span's start or end

    def prime(self, fn) -> None:
        """Run ``fn`` under a profiler session whose records are dropped:
        the profiler's first session sets CUDA tracing up, which takes
        seconds, so set-up pays for it rather than the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=self.wait, warmup=1, active=self.active,
                              repeat=self.spans),
            on_trace_ready=self._keep)
        self._prof.start()

    def _keep(self, prof) -> None:
        # the parsing waits for the window's end: only the results are kept
        self._results.append(prof.profiler.kineto_results)

    @property
    def recording(self) -> bool:
        from torch.profiler import ProfilerAction

        return self._prof.current_action in (ProfilerAction.RECORD,
                                             ProfilerAction.RECORD_AND_SAVE)

    def step(self) -> None:
        """After every step.  Around a span's start and its end the host
        waits ``MARGIN_S``: the profiler keeps only the records that fall
        inside the span by its own clock, and the device's timestamps can
        run a little ahead of or behind the host's."""
        from torch.profiler import ProfilerAction

        t = time.perf_counter()
        before = self._prof.current_action
        if before == ProfilerAction.RECORD_AND_SAVE:
            time.sleep(MARGIN_S)
        self._prof.step()
        if before == ProfilerAction.WARMUP and self.recording:
            time.sleep(MARGIN_S)
        self.stall_s = max(self.stall_s, time.perf_counter() - t)

    def stop(self) -> None:
        self._prof.stop()
        self.spans_events = [from_kineto(r.events()) for r in self._results]
        self._results = []


def record_call(fn, name: str):
    """Run ``fn`` once in a profiler session of its own, inside a
    ``record_function`` span called ``name``, the host waiting
    ``MARGIN_S`` at each end: (its result, the session's ``Ev`` records,
    the launch counters' increase over it)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    c0 = launch_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        with record_function(name):
            out = fn()
        time.sleep(MARGIN_S)
    counts = launch_counters() - c0
    return out, from_kineto(prof.profiler.kineto_results.events()), counts


def union_ns(intervals, lo=None, hi=None) -> int:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(events) -> list:
    return [e for e in events if e.kind in DEVICE_KINDS]


def busy_ns(events, windows=None) -> int:
    """Device busy time: the union of kernel and copy intervals, summed
    over ``windows`` ((lo, hi) pairs) when given."""
    iv = [(e.start, e.end) for e in device_events(events)]
    if windows is None:
        return union_ns(iv)
    return sum(union_ns([(s, e) for s, e in iv if e > lo and s < hi], lo, hi)
               for lo, hi in windows)


def idle_pct(events_list, name: str):
    """Share (%) of the ``record_function`` spans called ``name`` in which
    no kernel or copy ran on the device, over every span of
    ``events_list`` (a list of ``Ev`` lists), or None where there is none.

    The time the host spent inside a graph launch while the device was
    idle is left out of both the idle time and the whole: under the
    profiler a ``cudaGraphLaunch`` holds the host for milliseconds (CUPTI
    records each of the graph's nodes), which a run without the profiler
    does not pay."""
    whole, counted_idle = 0, 0
    for events in events_list:
        dev = [(e.start, e.end) for e in device_events(events)]
        launch = [(e.start, e.end) for e in events if e.kind == "graph"]
        for lo, hi in spans_named(events, name):
            busy = union_ns(dev, lo, hi)
            covered = union_ns(dev + launch, lo, hi)
            idle = (hi - lo) - covered
            whole += idle + busy
            counted_idle += idle
    if not whole:
        return None
    return 100.0 * counted_idle / whole


def spans_named(events, name: str) -> list:
    """(start, end) of every ``record_function`` span called ``name``."""
    return [(e.start, e.end) for e in events
            if e.kind == "span" and e.name == name]


def extent(events) -> tuple:
    """(first start, last end) of every record of a span."""
    return (min(e.start for e in events), max(e.end for e in events))


def kernels_named(events, part: str) -> list:
    return [e for e in events if e.kind == "kernel" and part in e.name]


def host_launches(events) -> int:
    """Kernel and graph launches the host made."""
    return sum(e.kind in ("launch", "graph") for e in events)


def check_records(events, kernel_counts: dict, graph_launches: int) -> None:
    """Raise ``LostRecords`` unless one span's records are whole:
    CUDA calls with kernels among them, a device record for every kernel
    and graph launch, ``kernel_counts`` ({kernel name part: launches the
    program counted}) kernel records of each, and ``graph_launches`` graph
    launches."""
    runtime = [e for e in events if e.kind in ("launch", "graph", "runtime")]
    dev = device_events(events)
    if runtime and not any(e.kind == "kernel" for e in dev):
        raise LostRecords("the span lists CUDA calls but no kernel")
    have = {e.corr for e in dev}
    lost = [e for e in runtime
            if e.kind in ("launch", "graph") and e.corr not in have]
    if lost:
        lo, hi = extent(events)
        raise LostRecords(
            f"{len(lost)} of "
            f"{sum(e.kind in ('launch', 'graph') for e in runtime)} launches "
            f"without a device record (first: {lost[0].name} at "
            f"{(lost[0].start - lo) / 1e6:.3f} ms of the span's "
            f"{(hi - lo) / 1e6:.3f})")
    for part, want in kernel_counts.items():
        got = len(kernels_named(dev, part))
        if got != want:
            raise LostRecords(f"{got} records of kernel {part}, the program "
                              f"counted {want} launches")
    got = sum(e.kind == "graph" for e in runtime)
    if got != graph_launches:
        raise LostRecords(f"{got} graph launches recorded, the program "
                          f"counted {graph_launches} replays")


def top_device_ops(spans, top: int = 10) -> list:
    """[[kernel or copy name, seconds], ...]: the device operations that
    took most time over the spans."""
    tot = {}
    for events in spans:
        for e in device_events(events):
            tot[e.name] = tot.get(e.name, 0) + (e.end - e.start)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in best]


def idle_gaps(spans, top: int = 10) -> list:
    """[[what the host was doing, seconds], ...]: the device's idle gaps
    inside each span, each named by the innermost host record (a
    ``record_function`` span or an operator) open at its midpoint, summed
    by name."""
    import heapq

    tot = {}
    for events in spans:
        dev = sorted((e.start, e.end) for e in device_events(events))
        if not dev:
            continue
        host = sorted((e for e in events if e.kind not in DEVICE_KINDS),
                      key=lambda h: h.start)
        # the gaps' midpoints rise, so a sweep keeps the host records open
        # so far in a heap by length; one that closed before a midpoint is
        # closed for every later one and is dropped when it comes up
        heap, nxt = [], 0
        end = dev[0][1]
        for s, e in dev[1:]:
            if s > end:
                mid = (end + s) // 2
                while nxt < len(host) and host[nxt].start <= mid:
                    h = host[nxt]
                    heapq.heappush(heap, (h.end - h.start, h.start, nxt))
                    nxt += 1
                while heap and host[heap[0][2]].end <= mid:
                    heapq.heappop(heap)
                name = host[heap[0][2]].name if heap else "host (no record)"
                tot[name] = tot.get(name, 0) + (s - end)
            end = max(end, e)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in best]
