"""Tracing and step-time metrics of the serving loop.

Counterpart of ``low_cost_mocap_tpu/utils/profiling.py``:

- ``StageTimer``: rolling per-stage wall-time stats as one metrics dict,
  which the engine emits as its ``metrics`` event;
- ``device_trace``: a ``torch.profiler`` context that writes a Chrome
  trace (chrome://tracing, Perfetto) of what the device ran while it was
  open — CUDA activity, from every thread, on a CUDA device; the calling
  thread's CPU operators on the CPU;
- ``time_compiled``: the throughput of a callable, synchronising the
  device once, after the timed calls.
"""

from __future__ import annotations

import collections
import contextlib
import os
import re
import statistics
import threading
import time
from typing import Any, Callable

import torch

# one profiler per process: a second one started while another runs
# crashes the process, so device_trace refuses instead
_trace_lock = threading.Lock()


class StageTimer:
    """Rolling wall-clock stats per named stage."""

    def __init__(self, window: int = 240):
        self._samples: dict[str, collections.deque] = {}
        self._window = window

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples.setdefault(
            name, collections.deque(maxlen=self._window)).append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, q in self._samples.items():
            if not q:
                continue
            xs = list(q)
            mean = statistics.fmean(xs)
            out[name] = {
                "mean_ms": 1e3 * mean,
                "p50_ms": 1e3 * statistics.median(xs),
                "max_ms": 1e3 * max(xs),
                "hz": 1.0 / mean if mean > 0 else float("inf"),
                "n": len(xs),
            }
        return out


def lost_kernels(trace_text: str) -> bool:
    """Whether a Chrome trace lists CUDA runtime calls but no kernel: CUPTI
    made no kernel record in the session while keeping the launches and
    copies (``_session``)."""
    return (re.search(r'"cat":\s*"cuda_runtime"', trace_text) is not None
            and re.search(r'"cat":\s*"kernel"', trace_text) is None)


@contextlib.contextmanager
def _session(device, quiesce=None):
    """A ``torch.profiler`` session over the block; yields the profiler.

    It starts and stops with ``quiesce`` held and, on a CUDA device, with
    the device idle; there it records CUDA activity, on the CPU the calling
    thread's operators.  CUPTI stops
    recording the kernels of a thread that launches while the kernel
    activity is switched on or off, for as long as the process lives (and
    for a later thread that reuses that thread's id), so every thread that
    launches on the device must hold ``quiesce`` while it launches."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    hold = contextlib.nullcontext() if quiesce is None else quiesce
    prof = profile(activities=acts)
    with hold:
        if cuda:
            torch.cuda.synchronize(device)
        prof.start()
        if cuda:
            torch.cuda.synchronize(device)
    try:
        yield prof
    finally:
        with hold:
            if cuda:
                torch.cuda.synchronize(device)
            prof.stop()


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda", quiesce=None):
    """Profile the block; on exit write ``<log_dir>/trace.json``.  Yields
    that path.

    On a CUDA device the session records the kernels of every thread that
    holds ``quiesce`` while it launches (``_session``; the Engine passes
    its model lock).  Raises RuntimeError when a profiler is already
    running, or when the trace of a CUDA device came back without its
    kernels."""
    if not _trace_lock.acquire(blocking=False):
        raise RuntimeError("a profiler is already running")
    try:
        if torch.autograd.profiler._is_profiler_enabled:
            raise RuntimeError("a profiler is already running")
        path = os.path.join(log_dir, "trace.json")
        with _session(device, quiesce) as prof:
            yield path
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(path)
        if torch.device(device).type == "cuda":
            with open(path) as f:
                if lost_kernels(f.read()):
                    raise RuntimeError(
                        f"the trace {path} lists CUDA calls but no kernel: "
                        "the profiler lost the kernel records")
    finally:
        _trace_lock.release()


def _synchronize(out) -> None:
    """Wait for the device of the first CUDA tensor in ``out``."""
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    for x in leaves:
        if isinstance(x, (tuple, list)):
            _synchronize(x)
            return
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return


def time_compiled(fn: Callable[..., Any], *args, iters: int = 100,
                  warmup: int = 3) -> dict[str, float]:
    """Throughput of ``fn(*args)``: ``warmup`` calls and a synchronise,
    then ``iters`` calls timed up to one synchronise at the end."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _synchronize(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _synchronize(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_ms": dt * 1e3, "hz": 1.0 / dt, "iters": iters}
