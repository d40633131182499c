"""Each driver at a tiny size on the CPU, held against the reference: the
run's outputs agree, and with the timed path broken underneath, the check
says so."""

import pytest

from mocapbench.drivers import live_open_loop, offline_recording
from mocapbench.tests._cells import correct, tiny

LIVE = [("drone4", "live150", 0.1)]


def _live(config, traffic, seconds):
    return tiny(config, traffic, seconds, warmup_frames=3)


def _offline():
    return tiny("drone4", "offline_smoothed", 0.01, frames=12,
                warmup_calls=1)


@pytest.mark.parametrize("config,traffic,seconds", LIVE)
def test_live_against_reference(config, traffic, seconds):
    cell = _live(config, traffic, seconds)
    run = live_open_loop.run(cell)
    assert run.attempted == int(round(seconds * cell.traffic["rate_hz"]))
    assert run.failed == 0
    assert run.metrics["pose_latency_p95_ms"] > 0
    numbers = run.check()
    assert correct(numbers, cell.traffic["limits"]), numbers


def test_offline_against_reference():
    cell = _offline()
    run = offline_recording.run(cell)
    assert run.attempted >= 1 and run.metrics["frames_per_s"] > 0
    numbers = run.check()
    assert correct(numbers, cell.traffic["limits"]), numbers


def _altered_decode(monkeypatch):
    """An answer altered where it is produced: every decoded point moves
    by a tenth of a millimetre."""
    from low_cost_mocap_tpu_torch.runtime import engine

    real = engine.Engine._decode

    def decode(rb):
        outs = real(rb)
        for o in outs:
            o.object_points[:] += 1e-4
        return outs

    monkeypatch.setattr(engine.Engine, "_decode", staticmethod(decode))


def _frozen_bank(monkeypatch):
    """A step that returns its state unchanged: the bank reports, but its
    tracker state never advances."""
    from low_cost_mocap_tpu_torch.models import pipeline

    real = pipeline._bank

    def bank(state, *args):
        return state, real(state, *args)[1]

    monkeypatch.setattr(pipeline, "_bank", bank)


@pytest.mark.parametrize("fault", [_altered_decode, _frozen_bank])
def test_live_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    cell = _live("drone4", "live150", 0.1)
    numbers = live_open_loop.run(cell).check()
    assert not correct(numbers, cell.traffic["limits"]), numbers


def _half_recording(monkeypatch):
    """Half of each chunk of the recording left out (zeroed)."""
    from low_cost_mocap_tpu_torch.models import offline

    real = offline._load

    def load(buf, x, lo, hi):
        real(buf, x, lo, hi)
        buf[(hi - lo) // 2:hi - lo].zero_()

    monkeypatch.setattr(offline, "_load", load)


def _altered_smoothed(monkeypatch):
    """The smoothed tracks altered where they are produced."""
    from low_cost_mocap_tpu_torch.ops import kalman

    real = kalman.smooth_sequence

    def smooth(*a, **kw):
        out, xs = real(*a, **kw)
        return out._replace(pos=out.pos + 1e-4), xs

    monkeypatch.setattr(kalman, "smooth_sequence", smooth)


def _frozen_tracker(monkeypatch):
    """A step that returns its state unchanged: every tracker step (the
    causal bank's and the smoother's forward filter's) reports, but its
    state never advances."""
    from low_cost_mocap_tpu_torch.ops import kalman

    real = kalman.update

    def update(state, *a, **kw):
        new, out = real(state, *a, **kw)
        return state, out

    monkeypatch.setattr(kalman, "update", update)


@pytest.mark.parametrize("fault", [_half_recording, _altered_smoothed,
                                   _frozen_tracker])
def test_offline_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    cell = _offline()
    numbers = offline_recording.run(cell).check()
    assert not correct(numbers, cell.traffic["limits"]), numbers


@pytest.mark.parametrize("driver,cell", [
    (live_open_loop, lambda: _live("drone4", "live150", 0.1)),
    (offline_recording, _offline)])
def test_control_is_not_correct(driver, cell):
    """The control (the reference in bfloat16 in the program's place)
    fails the limits at the test's size as it does on the card."""
    c = cell()
    assert not correct(driver.control(c), c.traffic["limits"])


def test_offline_traced_call_that_lost_records_is_traced_again(
        monkeypatch, capsys):
    """A traced call whose records are not whole is not read: another
    call is traced after the window, and its outputs are compared too;
    with no retries left the run fails."""
    from mocapbench.common import trace

    real = trace.check_span
    seen = []

    def check_span(events, counts):
        seen.append(len(events))
        if len(seen) == 1:
            raise trace.LostRecords("1 of 2 launches without a device record")
        real(events, counts)

    monkeypatch.setattr(trace, "check_span", check_span)
    cell = _offline()
    cell.trace = True
    cell.seconds = 10.0       # a window long enough to trace a call in
    run = offline_recording.run(cell)
    assert len(seen) == 2 and len(run.spans) == 1
    assert trace.spans_named(run.spans[0], "offline.process_recording")
    assert "another call is traced" in capsys.readouterr().err
    assert correct(run.check(), cell.traffic["limits"])

    seen.clear()
    monkeypatch.setattr(offline_recording, "TRACE_RETRIES", 0)
    with pytest.raises(trace.LostRecords):
        offline_recording.run(cell)
