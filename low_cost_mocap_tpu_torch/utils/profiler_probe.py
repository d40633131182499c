"""Which ``torch.profiler`` sessions lose their kernel records, on a card.

A diagnostic of ``utils/profiling.py``'s CUDA sessions.  Run from the
repository root on a CUDA machine::

    python -m low_cost_mocap_tpu_torch.utils.profiler_probe MODE VARIANT N

An Engine serves the synthetic 4-camera rig on its capture thread while
sessions are traced from another thread, as ``capture-profile`` does, for
N cycles: each cycle starts the capture loop, traces two 0.6 s windows from
a thread of their own and stops it, then traces 8 ``process_frame`` calls
of a second engine on the main thread.  VARIANT "base" starts and stops the
profiler while the capture thread launches; "quiesce" holds the engine's
model lock (which the step's launches hold) while it starts and stops, as
``Engine.handle_capture_profile`` does.  MODE "real" first runs
``chip_smoke.py``'s phases [10d], [10a], [10b], [10c] and [10e], the
sessions and engines a trace follows there.  After a window that lost its
kernels it tries, while the same capture thread serves: the same window
again, a quiesced window and a window of the main thread.  Each session
prints its counts of kernels, copies and launch calls (a session with
launch calls but no kernel lost them), and the last line is a JSON
summary.
"""

from __future__ import annotations

import json
import sys
import threading
import time

WINDOW_S = 0.6


def _counts(prof):
    """(kernels, copies, kernel-launch calls) of a finished session."""
    import torch

    cuda_t = torch.autograd.DeviceType.CUDA
    ev = prof.key_averages()
    kernels = sum(e.count for e in ev if e.device_type == cuda_t
                  and "emcpy" not in e.key and "emset" not in e.key)
    copies = sum(e.count for e in ev if e.device_type == cuda_t
                 and "emcpy" in e.key)
    launches = sum(e.count for e in ev if e.device_type != cuda_t
                   and e.key.startswith(("cudaLaunch", "cuLaunch")))
    return kernels, copies, launches


def _window(run, quiesce=None):
    from low_cost_mocap_tpu_torch.utils import profiling

    with profiling._session("cuda", quiesce) as prof:
        run()
    return _counts(prof)


def _in_thread(fn):
    box = {}

    def go():
        try:
            box["r"] = fn()
        except Exception as e:   # reported with the session
            box["r"] = ("error", repr(e))

    th = threading.Thread(target=go, name="lcm-profile")
    th.start()
    th.join()
    return box["r"]


class _Log:
    def __init__(self):
        self.rows, self.t0 = [], time.perf_counter()

    def add(self, tag, res) -> bool:
        lost = (isinstance(res, tuple) and len(res) == 3 and res[0] == 0
                and res[2] > 0)
        self.rows.append({"tag": tag, "res": res, "lost": lost,
                          "t": round(time.perf_counter() - self.t0, 1)})
        print(f"  {tag}: kernels/copies/launch-calls {res}"
              + ("  LOST" if lost else ""), flush=True)
        return lost


def _served_windows(log, eng, variant, tag):
    """Two windows from a thread of their own while ``eng``'s capture loop
    serves; after a lost one, the retries.  Returns whether one was
    lost."""
    lock = eng._model_lock if variant == "quiesce" else None
    sleep = lambda: time.sleep(WINDOW_S)  # noqa: E731
    eng.start()
    try:
        time.sleep(0.3)
        for j in range(2):
            if log.add(f"{tag} worker {variant} {j}",
                       _in_thread(lambda: _window(sleep, lock))):
                log.add(f"{tag}   again", _in_thread(lambda: _window(sleep)))
                log.add(f"{tag}   again, quiesced", _in_thread(
                    lambda: _window(sleep, eng._model_lock)))
                log.add(f"{tag}   a main-thread window", _window(sleep))
                return True
    finally:
        eng.stop()
    return False


def main(argv=None) -> None:
    import numpy as np
    import torch

    mode, variant, cycles = (argv or sys.argv[1:])[:3]
    cycles = int(cycles)
    if mode not in ("real", "synthetic") or variant not in ("base",
                                                            "quiesce"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    print(f"profiler_probe {mode} {variant} {cycles}: torch "
          f"{torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    log = _Log()
    Rs, ts, rig = syn.ring_rig(num_cameras=4, image_size=320)
    cfg = EngineConfig()
    src, src2 = (SyntheticSource(rig, Rs, ts, num_drones=2,
                                 headings=(0.0, np.pi)) for _ in range(2))
    eng, _ = cs.serving_engine(rig, cfg, Rs, ts, src)
    eng2, _ = cs.serving_engine(rig, cfg, Rs, ts, src2)

    def frames():
        for i in range(8):
            eng2.process_frame(src2.read_at(i / 60), 1 / 60)

    frames()
    torch.cuda.synchronize()
    if mode == "real":
        cs.phase_profile(rig, cfg, Rs, ts)
        cs.phase_bodies(rig, cfg, Rs, ts)
        cs.phase_learn(rig, cfg, Rs, ts)
        cs.phase_record(rig, cfg, Rs, ts)
        cs.phase_preprocess(rig, cfg, Rs, ts)
    for c in range(cycles):
        _served_windows(log, eng, variant, f"c{c}")
        log.add(f"c{c} main-thread process_frame", _window(frames))
    print(json.dumps({"mode": mode, "variant": variant,
                      "sessions": len(log.rows),
                      "lost": sum(r["lost"] for r in log.rows),
                      "secs": round(time.perf_counter() - log.t0, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
