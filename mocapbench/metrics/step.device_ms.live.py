"""Device busy ms a frame: the union of kernel and copy intervals over
the traced spans, divided by the frames served in them."""

from mocapbench.common import trace


def read(run):
    frames = sum(len(ks) for ks in run.layer.get("span_frames", []))
    if not frames:
        return None
    return sum(trace.busy_ns(ev) for ev in run.spans) / frames / 1e6
