"""Share (%) of the traced ``offline.process_recording`` calls' time in
which no kernel or copy ran on the device, leaving out the profiler's own
cost in graph launches (``trace.idle_pct``)."""

from mocapbench.common import trace


def read(run):
    return trace.idle_pct(run.spans, "offline.process_recording")
