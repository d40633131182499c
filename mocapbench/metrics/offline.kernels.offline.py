"""Kernels the device ran a frame set in the traced calls."""


def read(run):
    sets = run.layer.get("calls_traced", 0) * run.layer["frames_per_call"]
    if not sets:
        return None
    return sum(e.kind == "kernel" for ev in run.spans for e in ev) / sets
