"""Mean ms of the Engine's ``ingest`` stage (native detection into the
upload buffer), from its stage timer, over every frame of the window that
no traced span disturbed (``live_open_loop._disturbed``)."""


def read(run):
    return run.layer.get("stage_ms", {}).get("ingest")
