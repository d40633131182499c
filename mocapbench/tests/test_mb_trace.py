"""The traced run's guard against lost profiler records, and the trace
arithmetic the per-layer metrics share, on a recorded frame: one drone4
frame served by the Engine on an H100 (host detection, one graph replay
with 1,065 kernels)."""

import json
from pathlib import Path

import pytest

from mocapbench.common import trace

FIXTURE = Path(__file__).parent / "fixtures" / "drone4_frame.json"
# what the program's counters read for that frame: one replay holding one
# kalman_bank launch, no detection launch
COUNTS = {"finish_kernel": 0, "kalman_bank": 1}


@pytest.fixture
def frame():
    return [trace.Ev(*e) for e in json.loads(FIXTURE.read_text())["events"]]


def test_whole_frame_passes(frame):
    trace.check_records(frame, COUNTS, graph_launches=1)


def test_kernels_all_lost(frame):
    kept = [e for e in frame if e.kind != "kernel"]
    with pytest.raises(trace.LostRecords, match="no kernel"):
        trace.check_records(kept, COUNTS, graph_launches=1)


def test_launch_without_its_kernel(frame):
    launch = next(e for e in frame if e.kind == "launch")
    kept = [e for e in frame if e.kind == "launch"
            or e.corr != launch.corr]
    with pytest.raises(trace.LostRecords, match="1 of 2 launches"):
        trace.check_records(kept, COUNTS, graph_launches=1)


def test_graph_kernel_lost_against_counter(frame):
    bank = trace.kernels_named(frame, "kalman_bank")[0]
    kept = [e for e in frame if e is not bank]
    with pytest.raises(trace.LostRecords, match="kalman_bank"):
        trace.check_records(kept, COUNTS, graph_launches=1)


def test_replays_against_counter(frame):
    with pytest.raises(trace.LostRecords, match="graph launches"):
        trace.check_records(frame, COUNTS, graph_launches=2)


def test_busy_is_the_union_of_device_intervals(frame):
    dev = trace.device_events(frame)
    busy = trace.busy_ns(frame)
    assert 0 < busy <= sum(e.end - e.start for e in dev)
    assert busy <= max(e.end for e in dev) - min(e.start for e in dev)
    # clipped to the frame's own span it can only shrink
    span = trace.spans_named(frame, "engine.process_frame")
    assert len(span) == 1
    assert trace.busy_ns(frame, span) <= busy


def test_union_arithmetic():
    assert trace.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.union_ns([(0, 10), (5, 20), (30, 40)], 8, 35) == 17
    assert trace.union_ns([]) == 0


def test_breakdown_lists(frame):
    ops = trace.top_device_ops([frame])
    gaps = trace.idle_gaps([frame])
    assert 0 < len(ops) <= 10 and 0 < len(gaps) <= 10
    assert all(s > 0 for _, s in ops + gaps)
    assert trace.host_launches(frame) == 2


def test_idle_leaves_out_the_graph_launch():
    """Idle time under a graph launch is left out of both idle and whole;
    device time under it still counts as busy."""
    ev = [trace.Ev("span", "engine.process_frame", 0, 100, 0),
          trace.Ev("graph", "cudaGraphLaunch", 10, 50, 1),
          trace.Ev("kernel", "k", 40, 70, 1)]
    # span 100: busy 30 (40-70), idle under the launch 30 (10-40), idle
    # elsewhere 40 (0-10, 70-100): 40 / (100 - 30)
    assert trace.idle_pct([ev], "engine.process_frame") == pytest.approx(
        100.0 * 40 / 70)
    assert trace.idle_pct([ev], "offline.process_recording") is None


def test_idle_of_the_recorded_frame(frame):
    with_launch = trace.idle_pct([frame], "engine.process_frame")
    span = trace.spans_named(frame, "engine.process_frame")
    plain = 100.0 * (1 - trace.busy_ns(frame, span)
                     / sum(e - s for s, e in span))
    assert 0.0 <= with_launch <= plain
