"""What a driver is given and what it gives back."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH_DIR = ROOT / "mocapbench"


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record of it)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One run of one cell: the entries of ``BENCHMARK.json`` and the files
    they name, and the run's arguments."""

    name: str
    config: dict          # mocapbench/configs/<config>.json
    config_path: Path
    traffic: dict         # mocapbench/traffic/<traffic>.json
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


@dataclass
class Run:
    """A driver's result.  ``metrics``: the end-to-end values by name;
    ``layer``: what the per-layer readers read; ``spans``: the traced
    spans' records (``common.trace.Ev`` lists); ``check``: runs the
    reference once the program's state is freed and returns {name:
    value}."""

    attempted: int
    failed: int
    setup_s: float
    metrics: dict
    memory_peak_bytes: int
    check: Callable[[], dict]
    layer: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    stall_s: float | None = None   # the traced run's longest profiler step
    setup_parts: dict = field(default_factory=dict)   # setup_s by stage
