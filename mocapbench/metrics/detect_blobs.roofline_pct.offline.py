"""Share (%) of its roofline that ``detect_blobs`` reached in the traced
calls: the least time of a call's launches (``bounds.detect_bound`` over
the float32 frames the path hands the kernel, one launch a chunk) over the
device time of the kernel's two passes (``propagate_kernel``,
``finish_kernel``)."""

from mocapbench.common import trace


def read(run):
    calls = run.layer.get("calls_traced", 0)
    bound = run.layer.get("detect_bound_ms", 0.0) * calls
    ns = sum(e.end - e.start for ev in run.spans
             for part in ("propagate_kernel", "finish_kernel")
             for e in trace.kernels_named(ev, part))
    if not ns or not bound:
        return None
    return 100.0 * bound / (ns / 1e6)
