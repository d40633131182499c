"""Mean ms of the Engine's ``readback`` stage (the wait for a frame's row
and its decode), from its stage timer, over every frame of the window that
no traced span disturbed (``live_open_loop._disturbed``)."""


def read(run):
    return run.layer.get("stage_ms", {}).get("readback")
