"""Which ``torch.profiler`` sessions lose their kernel records, on a card.

A diagnostic of ``utils/profiling.py``'s CUDA sessions.  Run from the
repository root on a CUDA machine::

    python -m low_cost_mocap_tpu_torch.utils.profiler_probe MODE VARIANT N
    python -m low_cost_mocap_tpu_torch.utils.profiler_probe phases
    python -m low_cost_mocap_tpu_torch.utils.profiler_probe drift SECONDS

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

MODE "phases" runs ``chip_smoke.py``'s phases [4]-[15] in its order
(a list of its own here, ``_phases``) and, before the first and after
each, the kernel-time sessions of its phase [6] (five calls of the bank at
B=128 and B=1 and of the detection kernel, as ``chip_smoke.device_ms``
traces them, without its check) on the main thread, printing the threads
alive and each session's records of the kernel kept out of five and its
device ms a call; a session that kept fewer is flagged LOST and traced
again from a new thread.  It names the phase after which a session first
loses its records.

MODE "drift" traces, every 20 s for SECONDS, five launches of the bank
kernel twice, in a process that does nothing else: in a session that
holds only them (as ``chip_smoke.py``'s ``device_ms`` does) and in one
padded with 0.3 s of waiting before and after them.  It prints how many
kernel records each kept and, for the padded one, each kept kernel's start
minus the start of a launch call (paired in order) on the profiler's
timeline.
"""

from __future__ import annotations

import json
import sys
import threading
import time

WINDOW_S = 0.6
TIMED_CALLS = 5     # the calls of a kernel-time session


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


def _session(run, pad: float = 0.0):
    """The events of a ``torch.profiler`` session (CPU and CUDA) around
    ``run()`` and a synchronisation, ``pad`` s of waiting before and
    after them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        run()
        torch.cuda.synchronize()
        time.sleep(pad)
    return prof.events()


def _kernel_session(fn, kernel: str, runs: int = TIMED_CALLS):
    """``chip_smoke.device_ms``'s session without its check: one call of
    ``fn`` outside it, ``runs`` inside.  Returns (the records of the kernel
    whose name holds ``kernel`` kept, the device ms a call)."""
    import torch

    def calls():
        for _ in range(runs):
            fn()

    fn()
    torch.cuda.synchronize()
    dev = [e for e in _session(calls)
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kept = sum(kernel in e.name for e in dev)
    ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / runs
    return kept, round(ms, 4)


def _kernel_records(log, tag) -> None:
    """[6]'s sessions on the main thread; a lost one again from a new
    thread."""
    import torch

    import chip_smoke as cs
    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman, kalman_cuda

    alive = sorted(f"{t.name}{'' if t.daemon else '(non-daemon)'}"
                   for t in threading.enumerate())
    print(f"{tag}: {len(alive)} threads alive: {alive}", flush=True)
    case = [torch.from_numpy(a).to("cuda") for a in cs.bank_case(128)]
    st = kalman.init_state(2, device="cuda")
    frames = torch.rand((4, 320, 320), device="cuda")
    calls = {"kalman_bank B=128": (lambda: kalman_cuda.kalman_scan(st, *case),
                                   "kalman_bank"),
             "kalman_bank B=1": (lambda: kalman_cuda.kalman_scan(
                 st, *(a[:1] for a in case)), "kalman_bank"),
             "detect_blobs": (lambda: detect_cuda.find_blobs(frames, 0.5, 8),
                              "propagate_kernel")}
    for name, (fn, kernel) in calls.items():
        def session(fn=fn, kernel=kernel):
            return _kernel_session(fn, kernel)
        for where, run in (("", session),
                           (", a new thread", lambda: _in_thread(session))):
            res = run()
            lost = res[0] != TIMED_CALLS
            log.rows.append({"tag": f"{tag} {name}{where}", "res": res,
                             "lost": lost,
                             "t": round(time.perf_counter() - log.t0, 1)})
            print(f"  {tag} {name}{where}: {res[0]}/{TIMED_CALLS} records, "
                  f"{res[1]} ms" + ("  LOST" if lost else ""), flush=True)
            if not lost:
                break


def _drift(seconds: float) -> None:
    import torch

    import chip_smoke as cs
    from low_cost_mocap_tpu_torch.ops import kalman, kalman_cuda

    cs.phase_build()
    case = [torch.from_numpy(a).to("cuda") for a in cs.bank_case(128)]
    st = kalman.init_state(2, device="cuda")

    def calls():
        for _ in range(TIMED_CALLS):
            kalman_cuda.kalman_scan(st, *case)

    def session(pad):
        calls()
        torch.cuda.synchronize()
        ev = _session(calls, pad)
        kern = sorted(e.time_range.start for e in ev
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        launch = sorted(e.time_range.start for e in ev
                        if e.name.startswith(("cudaLaunch", "cuLaunch")))
        return len(kern), [round(k - c, 1) for k, c in zip(kern, launch)]

    t0 = time.perf_counter()
    while True:
        t = time.perf_counter() - t0
        short, padded = session(0.0), session(0.3)
        print(f"t={t:6.1f} s: short session {short[0]}/{TIMED_CALLS} kernel "
              f"records; padded {padded[0]}/{TIMED_CALLS}, kernel start - "
              f"launch start (us) "
              f"{padded[1]}", flush=True)
        if t > seconds:
            return
        time.sleep(max(0.0, 20.0 - (time.perf_counter() - t0 - t)))


def _phases(log) -> None:
    """``chip_smoke.main``'s phases in order, [6]'s sessions around each."""
    import chip_smoke as cs
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    cs.phase_build()
    Rs, ts, rig = syn.ring_rig(num_cameras=4, image_size=320)
    cfg = EngineConfig()
    _kernel_records(log, "before serving")
    _, src, _ = cs.phase_serve(rig, cfg, Rs, ts)
    steps = [
        ("[4b]", lambda: cs.phase_host_serve(rig, cfg, Rs, ts, src)),
        ("[4c]", lambda: cs.phase_batched_engine(rig, cfg, Rs, ts, src)),
        ("[4d]", lambda: cs.phase_server(rig, cfg, Rs, ts)),
        ("[4e]", lambda: cs.phase_launcher(Rs, ts)),
        ("[5]", lambda: cs.phase_batched(rig, cfg, Rs, ts, src)),
        ("[9]", lambda: cs.phase_calibration(rig, cfg, Rs, ts)),
        ("[10d]", lambda: cs.phase_profile(rig, cfg, Rs, ts)),
        ("[10a]", lambda: cs.phase_bodies(rig, cfg, Rs, ts)),
        ("[10b]", lambda: cs.phase_learn(rig, cfg, Rs, ts)),
        ("[10c]", lambda: cs.phase_record(rig, cfg, Rs, ts)),
        ("[10e]", lambda: cs.phase_preprocess(rig, cfg, Rs, ts)),
        ("[11]", lambda: cs.phase_large_rig(cfg)),
        ("[12]", lambda: cs.phase_offline(rig, cfg, Rs, ts)),
        ("[15]", lambda: cs.phase_compiled(rig, cfg, Rs, ts)),
    ]
    _kernel_records(log, "after [4]")
    for tag, run in steps:
        cs.reset_launches()
        run()
        _kernel_records(log, f"after {tag}")


def main(argv=None) -> None:
    import numpy as np
    import torch

    args = (argv or sys.argv[1:])
    if args[:1] == ["drift"]:
        _drift(float(args[1]))
        return
    if args[:1] == ["phases"]:
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card")
        log = _Log()
        _phases(log)
        print(json.dumps({"mode": "phases", "sessions": len(log.rows),
                          "lost": [r["tag"] for r in log.rows if r["lost"]],
                          "secs": round(time.perf_counter() - log.t0, 1)}),
              flush=True)
        return
    mode, variant, cycles = args[:3]
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
