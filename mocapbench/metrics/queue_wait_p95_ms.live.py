"""95th percentile (ms) of how late each frame reached
``Engine.process_frame`` after its due time: the camera queue ahead of
the Engine, on the harness's clock, over the frames that no traced span
disturbed (``live_open_loop._disturbed``)."""

import numpy as np


def read(run):
    q = run.layer.get("queue_wait_s")
    if q is None or len(q) == 0:
        return None
    return float(np.percentile(q, 95)) * 1e3
