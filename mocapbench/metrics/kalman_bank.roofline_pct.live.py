"""Share (%) of its roofline that the ``kalman_bank`` kernel reached in
the traced frames: the least time of each frame's bank step
(``bounds.bank_bound`` over the frame's located drones) over the kernel's
device time."""

from mocapbench.common import trace


def read(run):
    bound = sum(run.layer.get("bank_bound_ms", []))
    ns = sum(e.end - e.start for ev in run.spans
             for e in trace.kernels_named(ev, "kalman_bank"))
    if not ns or not bound:
        return None
    return 100.0 * bound / (ns / 1e6)
