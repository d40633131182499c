"""Step-time metrics of the serving loop.

``StageTimer``, the port's copy of the JAX package's
(``low_cost_mocap_tpu/utils/profiling.py``): rolling per-stage wall-time
stats as one metrics dict, which the engine emits as its ``metrics`` event.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import time


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
