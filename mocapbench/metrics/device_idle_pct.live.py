"""Share (%) of the traced frames' service intervals (each
``engine.process_frame`` call, which ends at its emit) in which no kernel
or copy ran on the device, leaving out the profiler's own cost in graph
launches (``trace.idle_pct``)."""

from mocapbench.common import trace


def read(run):
    return trace.idle_pct(run.spans, "engine.process_frame")
