"""Multi-process execution of the distributed solvers.

Counterpart of ``low_cost_mocap_tpu/parallel/multiprocess.py``.  The
one-process meshes validate the sharding semantics; this module runs the
same solvers across separate OS processes joined by ``torch.distributed``:
each process owns ``local_devices`` shards of one global mesh axis, and
the collectives cross a real process boundary (gloo over localhost, or
NCCL between CUDA devices).

Two halves:

- ``worker_main()`` — the per-process program (``python -m
  low_cost_mocap_tpu_torch.parallel.multiprocess``): joins the group,
  builds the deterministic synthetic scene, runs one solver over the
  global mesh, and writes a JSON result file.  Solvers: ``schur``
  (``schur_bundle_adjust``), ``reference`` (``dist_bundle_adjust``, the
  reference's formulation), ``live-pipeline`` (``dist_frame_step``),
  ``batched-sharded`` (``dist_scan_frame_step``), ``rts-assoc`` (the RTS
  smoother's associative scan with the sequence sharded over time) and
  ``smooth`` (``smooth_sharded``'s halo exchange).
- ``run_cluster()`` — the launcher: spawns the workers, waits with a
  deadline, and returns their parsed results.

Each rank's shards live on one device: ``cuda:<rank mod cards>`` with
``--device cuda`` (the default, with NCCL), the CPU with ``--device cpu``.
Two ranks may share a card through gloo; NCCL refuses two ranks on one
device.  The launcher imports no torch, so it is safe to call from any
process.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

SOLVERS = ("schur", "reference", "live-pipeline", "batched-sharded",
           "rts-assoc", "smooth")


# --------------------------------------------------------------- worker

def _build_scene(n_points: int, n_cams: int, seed: int = 0):
    """Deterministic synthetic rig and camera-0-gauge initial poses; every
    process builds the same scene from the seed."""
    import numpy as np

    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = syn.ring_rig(num_cameras=n_cams)
    rng = np.random.default_rng(seed)
    X = syn.random_points(rng, n_points)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=0.3, rng=rng)
    R0, t0 = Rs[0].copy(), ts[0].copy()
    Rs_g = np.einsum("cij,jk->cik", Rs, R0.T).astype(np.float32)
    ts_g = (ts - np.einsum("cij,j->ci", Rs_g, t0)).astype(np.float32)
    return pts, mask, rig.K_stack(), Rs_g, ts_g


def _launch_counts() -> dict:
    from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman_cuda

    return {"detect_blobs": detect_cuda.launches,
            "kalman_bank": kalman_cuda.launches}


def _write(args, result: dict) -> None:
    tmp = args.out + f".tmp{args.process_id}"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, args.out)


def worker_main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-method", required=True,
                    help="torch.distributed rendezvous, e.g. file:///tmp/x")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-points", type=int, default=512)
    ap.add_argument("--n-cams", type=int, default=4)
    ap.add_argument("--max-iters", type=int, default=8)
    ap.add_argument("--solver", choices=SOLVERS, default="schur")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--timeout-s", type=float, default=600.0)
    args = ap.parse_args(argv)

    import datetime

    import torch
    import torch.distributed as dist

    from low_cost_mocap_tpu_torch.device import resolve_device
    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib

    if args.device == "cuda":
        resolve_device("cuda")          # raises without CUDA
        dev = torch.device("cuda",
                           args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(
        args.backend, init_method=args.init_method,
        world_size=args.num_processes, rank=args.process_id,
        timeout=datetime.timedelta(seconds=args.timeout_s))
    try:
        axis = {"schur": "point", "reference": "point",
                "live-pipeline": "cam", "batched-sharded": "cam",
                "rts-assoc": "time", "smooth": "time"}[args.solver]
        mesh = mesh_lib.make_mesh(
            {axis: args.num_processes * args.local_devices},
            devices=[dev] * args.local_devices, group=dist.group.WORLD)
        run = {"schur": _run_ba, "reference": _run_ba,
               "live-pipeline": _run_live_pipeline,
               "batched-sharded": _run_batched_sharded,
               "rts-assoc": _run_rts_assoc, "smooth": _run_smooth}
        result = run[args.solver](args, mesh)
        result.update(process_id=args.process_id,
                      num_processes=args.num_processes,
                      global_devices=mesh.size,
                      local_devices=len(mesh.local), solver=args.solver,
                      device=str(dev), backend=args.backend,
                      launches=_launch_counts())
        _write(args, result)
    finally:
        dist.destroy_process_group()


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_ba(args, mesh) -> dict:
    """Distributed BA over the global ``point`` axis, solved twice (the
    second timed)."""
    import numpy as np
    import torch

    pts, mask, K, Rs0, ts0 = (torch.as_tensor(np.asarray(a))
                              for a in _build_scene(args.n_points,
                                                    args.n_cams))
    if args.solver == "schur":
        from low_cost_mocap_tpu_torch.parallel.schur_ba import \
            schur_bundle_adjust as solver
    else:
        from low_cost_mocap_tpu_torch.parallel.dist_ba import \
            dist_bundle_adjust as solver

    def solve():
        return solver(mesh, pts, mask, K, Rs0, ts0,
                      max_iters=args.max_iters, ftol=0.0)

    solve()
    _sync(mesh.tail_device)
    t0 = time.perf_counter()
    res = solve()
    cost = float(res.cost)        # a device read: the solve has finished
    wall = time.perf_counter() - t0
    return {"cost": cost, "ts": res.ts.cpu().numpy().tolist(),
            "wall_s": wall, "ms_per_iter": wall / args.max_iters * 1e3}


def _live_scene(n_cams: int, drone_x):
    """A drone and three stray points on the ring rig, rendered to uint8
    frames, one frame set a drone position."""
    import numpy as np

    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = syn.ring_rig(num_cameras=n_cams)
    frames = []
    rng = np.random.default_rng(0)
    for x in drone_x:
        X = np.concatenate([
            syn.drone_markers(np.array([x, -0.1, 0.9], np.float32), 0.4,
                              rig),
            syn.random_points(rng, 3),
        ])
        pts, mask = syn.observe(X, Rs, ts, rig)
        frames.append(syn.render_frames(pts, mask, rig.image_size,
                                        sigma=0.8))
    return Rs, ts, rig, (np.stack(frames) * 255).astype(np.uint8)


def _calibration(rig, Rs, ts, dev):
    import numpy as np
    import torch

    from low_cost_mocap_tpu_torch.ops import camera as cam_ops
    from low_cost_mocap_tpu_torch.ops.correspond import \
        _pairwise_fundamentals

    K = torch.as_tensor(rig.K_stack(), device=dev)
    dist = torch.as_tensor(rig.dist_stack(), device=dev)
    Ps = cam_ops.projection_matrix(
        K, torch.as_tensor(np.asarray(Rs), device=dev),
        torch.as_tensor(np.asarray(ts), device=dev))
    return (Ps, K, dist, torch.eye(4, device=dev),
            _pairwise_fundamentals(Ps))


def _run_live_pipeline(args, mesh) -> dict:
    """The camera-sharded live step across the processes (each host owns a
    camera group): every rank detects only its cameras, the blobs cross
    the process boundary in one all_gather, and every rank runs the tail
    on the same blobs."""
    import numpy as np
    import torch

    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.models.pipeline import (make_init_state,
                                                          pack_outputs)
    from low_cost_mocap_tpu_torch.parallel.dist_pipeline import \
        dist_frame_step

    Rs, ts, rig, frames = _live_scene(args.n_cams, [0.1])
    tail = mesh.tail_device
    cal = _calibration(rig, Rs, ts, tail)
    cfg = EngineConfig()
    state = make_init_state(rig, device=tail)
    rows = []
    t0 = time.perf_counter()
    for _ in range(3):   # a few frames: the state threads through
        state, out = dist_frame_step(
            mesh, state, torch.from_numpy(frames[0]),
            np.float32(1.0 / 60.0), *cal, rig, cfg)
        rows.append(pack_outputs(out))
    rows = torch.stack(rows).cpu().numpy()
    wall = time.perf_counter() - t0
    return {"tracked_pos": out.tracked.pos.cpu().numpy().tolist(),
            "tracked_valid": out.tracked.valid.cpu().numpy().tolist(),
            "n_points": int(out.point_valid.sum()),
            "rows_sha": hashlib.sha256(rows.tobytes()).hexdigest(),
            "wall_s": wall}


def _run_batched_sharded(args, mesh) -> dict:
    """The batched x camera-sharded serving step (dist_scan_frame_step)
    across the processes: 8 frames in one step, each rank ingesting its
    camera shard, the packed (B, L) rows equal on every rank."""
    import numpy as np
    import torch

    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.models.pipeline import (
        make_init_state, unpack_outputs_batch)
    from low_cost_mocap_tpu_torch.parallel.dist_pipeline import \
        dist_scan_frame_step

    B = 8
    Rs, ts, rig, frames_b = _live_scene(
        args.n_cams, [0.1 + 0.004 * f for f in range(B)])
    tail = mesh.tail_device
    cal = _calibration(rig, Rs, ts, tail)
    cfg = EngineConfig()
    dts = np.full((B,), 1.0 / 60.0, np.float32)
    state = make_init_state(rig, device=tail)
    t0 = time.perf_counter()
    state, rows = dist_scan_frame_step(
        mesh, state, torch.from_numpy(frames_b), dts, *cal, rig, cfg)
    rows = rows.cpu().numpy()
    wall = time.perf_counter() - t0
    outs = unpack_outputs_batch(rows, rig.num_cameras, cfg.max_blobs,
                                rig.num_objects)
    last = outs[-1]
    return {"rows_sha": hashlib.sha256(rows.tobytes()).hexdigest(),
            "tracked_pos": np.asarray(last.tracked.pos).tolist(),
            "tracked_valid": np.asarray(last.tracked.valid).tolist(),
            "frames_tracked": int(sum(bool(o.tracked.valid.any())
                                      for o in outs)),
            "wall_s": wall}


def _rts_assoc(state, xs, Ps, dts):
    from low_cost_mocap_tpu_torch.ops import kalman

    return state, kalman.rts_smooth_assoc(xs, Ps, dts)[0]


def rts_smooth_assoc_step(xs, Ps, dts):
    """The unsharded ``kalman.rts_smooth_assoc`` the rts-assoc worker
    holds its result to, as one ``CompiledStep`` over buffers shaped like
    ``xs``, ``Ps`` and ``dts`` (JAX's ``jax.jit`` of it): called with
    ((), xs, Ps, dts) -> ((), the (T, O, 9) smoothed means), a CUDA graph
    on the card, op by op on the CPU."""
    import torch

    from low_cost_mocap_tpu_torch.runtime import compiled

    return compiled.CompiledStep(
        _rts_assoc, (), *(torch.empty_like(t) for t in (xs, Ps, dts)),
        name="rts_smooth_assoc")


def _run_rts_assoc(args, mesh) -> dict:
    """The RTS smoother's associative scan with the sequence sharded over
    time: each shard scans its block of the backward recursion's affine
    maps (Hillis-Steele), the block totals (a 9x9, a 9-vector and a 9x9
    an object) are gathered, each shard folds in the totals of the later
    blocks, and the smoothed blocks are gathered last."""
    import numpy as np
    import torch

    from low_cost_mocap_tpu_torch.ops import kalman

    T, dt = 64, 1.0 / 60.0
    rng = np.random.default_rng(3)
    t = np.arange(T) * dt
    pos = np.stack([0.4 * np.sin(1.3 * t), 0.3 * np.cos(1.7 * t),
                    0.6 + 0.1 * t], -1).astype(np.float32)
    meas = pos + rng.normal(scale=0.004, size=pos.shape).astype(np.float32)
    tail = mesh.tail_device

    # forward filter (every rank, deterministic) -> per-frame (x, P)
    st = kalman.init_state(1, device=tail)
    xs, Ps = [], []
    for z in meas:
        st, (_, x_f, P_f) = kalman.update(
            st, torch.as_tensor(z[None], device=tail),
            torch.zeros(1, device=tail),
            torch.zeros(1, dtype=torch.int32, device=tail),
            torch.ones(1, dtype=torch.bool, device=tail), dt,
            advance_on_miss=True, return_cov=True)
        xs.append(x_f)
        Ps.append(P_f)
    xs, Ps = torch.stack(xs), torch.stack(Ps)          # (T, 1, 9[, 9])
    dts = torch.full((T,), dt, device=tail)

    t0 = time.perf_counter()
    n = mesh.shape["time"]
    bounds = np.array_split(np.arange(T - 1), n)      # element blocks
    width = max(len(b) for b in bounds)
    # every local block on the rank's device (the forward pass is there)
    blocks, totals = [], []
    for k, _ in mesh.axis_shards("time"):
        lo, hi = int(bounds[k][0]), int(bounds[k][-1]) + 1
        E, g, L = kalman.suffix_compose(*kalman.rts_elements(
            xs[lo:hi + 1], Ps[lo:hi + 1], dts[lo:hi + 1]))
        blocks.append((E, g, L))
        totals.append(torch.cat([E[0].flatten(1), g[0], L[0].flatten(1)],
                                dim=1))
    tot = mesh.gather(totals)[:, None]              # (n, 1, O, 171)
    tot = (tot[..., :81].unflatten(-1, (9, 9)), tot[..., 81:90],
           tot[..., 90:].unflatten(-1, (9, 9)))
    out = []
    for (k, _), (E, g, L) in zip(mesh.axis_shards("time"), blocks):
        if k + 1 < n:                   # the later blocks, composed
            later = tuple(t[n - 1] for t in tot)
            for j in range(n - 2, k, -1):
                later = kalman.compose_maps(tuple(t[j] for t in tot), later)
            E, g, L = kalman.compose_maps(
                (E, g, L), tuple(x.expand(E.shape[0], *x.shape[1:])
                                 for x in later))
        xs_s = torch.einsum("toij,oj->toi", E, xs[-1]) + g
        pad = torch.zeros(width - xs_s.shape[0], *xs_s.shape[1:],
                          device=tail)
        out.append(torch.cat([xs_s, pad]))
    sm = mesh.gather(out)                           # (n, width, O, 9)
    sm = torch.cat([sm[k, :len(b)] for k, b in enumerate(bounds)]
                   + [xs[-1:]]).cpu().numpy()
    wall = time.perf_counter() - t0
    one = rts_smooth_assoc_step(xs, Ps, dts)((), xs, Ps, dts)[1]
    return {"smoothed": sm.tolist(),
            "vs_unsharded": float(np.abs(sm - one.cpu().numpy()).max()),
            "rmse_vs_truth_mm": float(np.sqrt(
                ((sm[:, 0, :3] - pos) ** 2).mean()) * 1e3),
            "wall_s": wall}


def _run_smooth(args, mesh) -> dict:
    """``smooth_sharded`` over the global time axis (halo exchange across
    the process boundary), its blocks gathered, beside the sequential
    smoother."""
    import numpy as np
    import torch

    from low_cost_mocap_tpu_torch.parallel import temporal

    rng = np.random.default_rng(1)
    T, D = 256, 3
    x = torch.as_tensor(np.cumsum(rng.normal(size=(T, D)).astype(
        np.float32), axis=0) * np.float32(0.01))
    t0 = time.perf_counter()
    mine = temporal.smooth_sharded(mesh, x, halo=32)
    ours = mesh.gather(list(mine.chunk(len(mesh.local)))).reshape(T, D)
    wall = time.perf_counter() - t0
    ref = temporal.smooth_reference(x.to(mesh.tail_device))
    return {"smoothed": ours.cpu().numpy().tolist(),
            "reference": ref.cpu().numpy().tolist(), "wall_s": wall}


# -------------------------------------------------------------- launcher

def run_cluster(num_processes: int, local_devices: int = 1, *,
                n_points: int = 512, n_cams: int = 4, max_iters: int = 8,
                solver: str = "schur", timeout_s: float = 600.0,
                device: str = "cuda", backend: str = "nccl") -> list[dict]:
    """Spawn ``num_processes`` workers of ``local_devices`` shards each;
    return each process's result.  ``num_processes == 1`` is the
    one-process reference for invariance checks.  A worker that fails
    raises with the end of its stderr; past ``timeout_s`` every worker is
    killed."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}: {solver!r}")
    with tempfile.TemporaryDirectory(prefix="lcm_mp_") as tmpdir:
        # a file rendezvous in this launcher's own directory: launchers
        # running side by side cannot race for a port
        init = "file://" + os.path.join(tmpdir, "rendezvous")
        env = dict(os.environ)
        # keep worker threading modest: the workers timeshare the host
        env.setdefault("OMP_NUM_THREADS", "1")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        procs, outs, err_files = [], [], []
        for pid in range(num_processes):
            out = os.path.join(tmpdir, f"result_{pid}.json")
            outs.append(out)
            cmd = [sys.executable, "-m",
                   "low_cost_mocap_tpu_torch.parallel.multiprocess",
                   "--init-method", init, "--out", out,
                   "--num-processes", str(num_processes),
                   "--process-id", str(pid),
                   "--local-devices", str(local_devices),
                   "--n-points", str(n_points), "--n-cams", str(n_cams),
                   "--max-iters", str(max_iters), "--solver", solver,
                   "--device", device, "--backend", backend,
                   "--timeout-s", str(timeout_s)]
            # stderr goes to a file, not a pipe: a crashed worker writing a
            # long traceback into a full pipe would block while its peers
            # wait for it in a collective and the launcher waits on an
            # earlier worker
            ef = open(os.path.join(tmpdir, f"stderr_{pid}.log"), "wb")
            err_files.append(ef)
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))),
                stdout=subprocess.DEVNULL, stderr=ef))
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(
                        f"multiprocess worker timed out after {timeout_s}s")
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
            for ef in err_files:
                ef.close()
        for pid, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(tmpdir, f"stderr_{pid}.log"),
                          errors="replace") as f:
                    err = f.read()
                raise RuntimeError(
                    f"worker {pid} exited {p.returncode}:\n{err[-2000:]}")
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
        return results


if __name__ == "__main__":
    worker_main()
