"""Kernel and graph launches the host made a frame, counted from the
CUDA runtime calls in the traced spans."""

from mocapbench.common import trace


def read(run):
    frames = sum(len(ks) for ks in run.layer.get("span_frames", []))
    if not frames:
        return None
    return sum(trace.host_launches(ev) for ev in run.spans) / frames
