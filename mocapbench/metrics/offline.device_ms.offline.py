"""Device busy ms a frame set: the union of kernel and copy intervals in
the traced calls, divided by the frame sets they processed."""

from mocapbench.common import trace


def read(run):
    sets = run.layer.get("calls_traced", 0) * run.layer["frames_per_call"]
    if not sets:
        return None
    return sum(trace.busy_ns(ev) for ev in run.spans) / sets / 1e6
