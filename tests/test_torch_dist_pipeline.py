"""PyTorch port: the camera-sharded live step and ``Engine(mesh=...)`` on
the CPU.

The sharded step at ``cam`` = 2 and 4 against JAX's ``dist_frame_step`` /
``dist_scan_frame_step`` on a one-device JAX mesh (discrete outputs
equal, floats within atol 1e-5), and bitwise against the port's own
single-device step; the mesh engine per frame and batched against JAX's
mesh engine on the scenes of ``tests/test_engine_mesh.py``, and bitwise
against the port's single-device engine; the engine's and the launcher's
refusals.  The mesh engine's compiled steps (``runtime/engine.py``: one step
over every shard on one device, ``_ShardedStep`` over several) run op by
op over their buffers on the CPU, bitwise equal to ``dist_frame_step`` and
``dist_scan_frame_step``; a mesh across processes has no compiled step.
The graphs are held to the same steps op by op on the card by
``tests/test_torch_compiled.py``'s ``cuda`` cases and ``chip_smoke.py``
[16a]/[16b].
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.models import pipeline
from low_cost_mocap_tpu_torch.ops import camera as cam_ops
from low_cost_mocap_tpu_torch.ops import detect, detect_cuda
from low_cost_mocap_tpu_torch.ops.correspond import _pairwise_fundamentals
from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
from low_cost_mocap_tpu_torch.parallel.dist_pipeline import (
    dist_frame_step, dist_scan_frame_step)
from low_cost_mocap_tpu_torch.runtime.engine import Engine, _ShardedStep
from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")


def _cam_mesh(d):
    return mesh_lib.make_mesh({"cam": d}, devices=[CPU] * d)


def _jax_mesh():
    from low_cost_mocap_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh({"cam": 1}, devices=jax.devices()[:1])


def _frames(B, seed=1):
    """The JAX tests' scene on the 4-camera ring: a drone drifting over B
    frame sets, three stray points each."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    rng = np.random.default_rng(seed)
    out = []
    for t in range(B):
        X = np.concatenate([
            syn.drone_markers(
                np.array([0.1 + 0.02 * t, -0.1, 0.9], np.float32), 0.4, rig),
            syn.random_points(rng, 3)])
        pts, mask = syn.observe(X, Rs, ts, rig)
        out.append(syn.render_frames(pts, mask, rig.image_size, sigma=0.8))
    return Rs, ts, rig, (np.stack(out) * 255).astype(np.uint8)


def _cal(rig, Rs, ts):
    K = torch.as_tensor(rig.K_stack())
    dist = torch.as_tensor(rig.dist_stack())
    Ps = cam_ops.projection_matrix(K, torch.as_tensor(Rs),
                                   torch.as_tensor(ts))
    return Ps, K, dist, torch.eye(4), _pairwise_fundamentals(Ps)


def _jcal(rig, Rs, ts):
    from low_cost_mocap_tpu.ops import camera as jcam
    from low_cost_mocap_tpu.ops.correspond import \
        _pairwise_fundamentals as jfund

    K = jnp.asarray(rig.K_stack())
    Ps = jcam.projection_matrix(K, jnp.asarray(Rs), jnp.asarray(ts))
    return (Ps, K, jnp.asarray(rig.dist_stack()),
            jnp.eye(4, dtype=jnp.float32), jfund(Ps))


def _jrig(rig):
    from low_cost_mocap_tpu.config import RigConfig as JRigConfig

    return JRigConfig(num_cameras=rig.num_cameras, image_size=rig.image_size)


def _assert_rows_close(got, want, rig, cfg):
    """Packed (B, L) rows: discrete fields equal, floats within TOL."""
    C, K, O = rig.num_cameras, cfg.max_blobs, rig.num_objects
    for g, w in zip(pipeline.unpack_outputs_batch(got, C, K, O),
                    pipeline.unpack_outputs_batch(want, C, K, O)):
        for name in ("blob_valid", "point_valid"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        for name in ("valid", "index"):
            np.testing.assert_array_equal(getattr(g.objects, name),
                                          getattr(w.objects, name))
        np.testing.assert_array_equal(g.tracked.valid, w.tracked.valid)
        for name in ("blob_px", "object_points", "point_errors"):
            np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                       **TOL)
        for a, b in zip((*g.objects, *g.tracked), (*w.objects, *w.tracked)):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_dist_frame_step_matches_jax_and_the_single_device_step(packed):
    from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
    from low_cost_mocap_tpu.models.pipeline import \
        make_init_state as jinit
    from low_cost_mocap_tpu.models.pipeline import pack_outputs as jpack
    from low_cost_mocap_tpu.ops.detect import pack_frames as jpack_frames
    from low_cost_mocap_tpu.parallel.dist_pipeline import \
        dist_frame_step as jstep

    Rs, ts, rig, frames = _frames(3)
    cfg = EngineConfig()
    cal = _cal(rig, Rs, ts)
    jcal = _jcal(rig, Rs, ts)
    if packed:
        frames = np.stack([jpack_frames(f, cfg.detect_threshold)
                           for f in frames])
    kw = dict(threshold=cfg.detect_threshold, max_blobs=cfg.max_blobs,
              cc_iters=cfg.cc_iters, gate_px=cfg.epipolar_gate_px,
              max_candidates=cfg.max_candidates_per_cam,
              marker_dist1=rig.marker_dist_short,
              marker_dist2=rig.marker_dist_long,
              marker_tol=rig.marker_dist_tol,
              marker_side_min=rig.marker_side_min, do_preprocess=False,
              packed_input=packed)
    jst = jinit(_jrig(rig))
    states = {d: pipeline.make_init_state(rig, device="cpu") for d in
              (0, 2, 4)}
    for f in frames:
        jst, jout = jstep(_jax_mesh(), jst, jnp.asarray(f),
                          jnp.float32(1 / 60), *jcal, _jrig(rig),
                          JEngineConfig(), packed=packed)
        want = np.asarray(jpack(jout))[None]
        states[0], ref = pipeline.frame_step(
            states[0], torch.as_tensor(f), np.float32(1 / 60), *cal, **kw)
        ref = pipeline.pack_outputs(ref)
        for d in (2, 4):
            states[d], row = dist_frame_step(
                _cam_mesh(d), states[d], torch.as_tensor(f),
                np.float32(1 / 60), *cal, rig, cfg, packed=packed, pack=True)
            assert torch.equal(row, ref), d
            _assert_rows_close(row[None].numpy(), want, rig, cfg)
    assert bool(jout.tracked.valid.any())


def test_dist_scan_frame_step_matches_jax_and_the_batched_path():
    from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
    from low_cost_mocap_tpu.models.pipeline import \
        make_init_state as jinit
    from low_cost_mocap_tpu.parallel.dist_pipeline import \
        dist_scan_frame_step as jscan

    B = 5
    Rs, ts, rig, frames_b = _frames(B)
    cfg = EngineConfig()
    cal = _cal(rig, Rs, ts)
    dts = np.full((B,), 1 / 60, np.float32)
    _, want = jscan(_jax_mesh(), jinit(_jrig(rig)), jnp.asarray(frames_b),
                    jnp.asarray(dts), *_jcal(rig, Rs, ts), _jrig(rig),
                    JEngineConfig(), with_obs=True)
    # the port's single-device batched path: one detection launch over
    # the batch's cameras, then the batched tail
    f = torch.as_tensor(frames_b).to(torch.float32) * (1.0 / 255.0)
    c, v, _ = detect_cuda.find_blobs(f.reshape(-1, *f.shape[2:]),
                                     cfg.detect_threshold, cfg.max_blobs,
                                     cfg.cc_iters)
    C, K = rig.num_cameras, cfg.max_blobs
    _, ref = pipeline.scan_track_from_blobs(
        pipeline.make_init_state(rig, device="cpu"), c.reshape(B, C, K, 2),
        v.reshape(B, C, K), dts, *cal,
        gate_px=cfg.epipolar_gate_px,
        max_candidates=cfg.max_candidates_per_cam,
        marker_dist1=rig.marker_dist_short,
        marker_dist2=rig.marker_dist_long, marker_tol=rig.marker_dist_tol,
        marker_side_min=rig.marker_side_min, with_obs=True)
    for d in (2, 4):
        _, rows = dist_scan_frame_step(
            _cam_mesh(d), pipeline.make_init_state(rig, device="cpu"),
            torch.as_tensor(frames_b), dts, *cal, rig, cfg, with_obs=True)
        assert torch.equal(rows, ref), d
        g = pipeline.unpack_outputs_batch(rows.numpy(), C, K,
                                          rig.num_objects, with_obs=True)
        w = pipeline.unpack_outputs_batch(np.asarray(want), C, K,
                                          rig.num_objects, with_obs=True)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.point_valid, b.point_valid)
            np.testing.assert_array_equal(a.point_obs_mask, b.point_obs_mask)
            np.testing.assert_array_equal(a.tracked.valid, b.tracked.valid)
            np.testing.assert_allclose(a.object_points, b.object_points,
                                       **TOL)
            np.testing.assert_allclose(a.point_obs, b.point_obs, **TOL)
            np.testing.assert_allclose(a.tracked.pos, b.tracked.pos, **TOL)
        assert g[-1].tracked.valid.any(), d


def _engine(rig, Rs, ts, cfg, **kw):
    e = Engine(rig, cfg, SyntheticSource(rig, Rs, ts, num_drones=1),
               CollectingLink(), **kw)
    e.set_camera_poses(Rs, ts)
    e.is_capturing_points = True
    e.is_triangulating_points = True
    e.is_locating_objects = True
    got = []
    e.on("object-points", got.append)
    return e, got


def _jengine(rig, Rs, ts, src, **cfg):
    from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
    from low_cost_mocap_tpu.runtime.engine import Engine as JEngine
    from low_cost_mocap_tpu.runtime.serial_link import \
        CollectingLink as JCollectingLink

    e = JEngine(_jrig(rig), JEngineConfig(**cfg), src, JCollectingLink(),
                mesh=_jax_mesh())
    e.set_camera_poses(Rs, ts)
    e.is_capturing_points = True
    e.is_triangulating_points = True
    e.is_locating_objects = True
    got = []
    e.on("object-points", got.append)
    return e, got


def _assert_payloads(got, want, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a["object_points"]),
                                   np.asarray(b["object_points"]), atol=atol)
        assert len(a["filtered_objects"]) == len(b["filtered_objects"])
        for fa, fb in zip(a["filtered_objects"], b["filtered_objects"]):
            assert fa["droneIndex"] == fb["droneIndex"]
            np.testing.assert_allclose(fa["pos"], fb["pos"], atol=atol)
            np.testing.assert_allclose(fa["vel"], fb["vel"], atol=atol)


@pytest.mark.parametrize("batch", [1, 4])
def test_mesh_engine_matches_jax_and_the_single_device_engine(batch):
    """Per frame and batched (the emits come at batch ends): the mesh
    engine's payloads equal the port's single-device engine's bit for
    bit, and the JAX mesh engine's within atol 1e-5."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    src = SyntheticSource(rig, Rs, ts, num_drones=1)
    # frames at the camera rate, as the dt passed with them says: frames
    # read at wall-clock times would change the scene from run to run
    frames_seq = [src.read_at(i / 60) for i in range(8)]
    cfg = EngineConfig(dispatch_batch=batch)
    ref, ref_got = _engine(rig, Rs, ts, EngineConfig(), device="cpu",
                           fast_path=True, host_detect=False)
    jeng, jgot = _jengine(rig, Rs, ts, src, dispatch_batch=batch)
    for d in (2, 4):
        eng, got = _engine(rig, Rs, ts, cfg, mesh=_cam_mesh(d))
        assert eng.device == CPU and eng._fast and not eng._host_detect
        rets = [eng.process_frame(f, 1 / 60) for f in frames_seq]
        if batch > 1:
            assert [r is None for r in rets] == \
                [(i + 1) % batch != 0 for i in range(len(frames_seq))]
        if d == 2:
            for f in frames_seq:
                ref.process_frame(f, 1 / 60)
                jeng.process_frame(f, 1 / 60)
        _assert_payloads(got, ref_got, atol=0.0)
        _assert_payloads(got, jgot, atol=1e-5)
    assert got[-1]["filtered_objects"]


def test_port_and_jax_differ_only_at_a_near_tie_of_the_epipolar_argmin():
    """A known divergence, not a fault: on the drone scene at t = 0.018 s
    two camera-2 blobs lie within 1e-3 px of each other in their distance
    to a camera-0 root's epiline, below float32's rounding of the
    ~300-px terms that cancel there.  The port and JAX round differently,
    so their closest candidate (and with it one camera-2 root) differs;
    the distances agree within that rounding and every other root is the
    same."""
    from low_cost_mocap_tpu.ops import correspond as jcorr

    from low_cost_mocap_tpu_torch.ops import correspond
    from low_cost_mocap_tpu_torch.parallel.dist_pipeline import gather_blobs

    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    cfg = EngineConfig()
    src = SyntheticSource(rig, Rs, ts, num_drones=1)
    packed = detect.pack_frames(src.read_at(0.018), cfg.detect_threshold)
    b = gather_blobs(_cam_mesh(1), torch.from_numpy(packed), cfg,
                     packed=True)
    Ps, K, dist, _, Fs = _cal(rig, Rs, ts)
    valid = b[..., 2] > 0.5
    pts = torch.where(valid[..., None], cam_ops.undistort_points(
        b[..., :2], K[:, None], dist[:, None]), 0.0)
    d, g = (x[0].numpy() for x in correspond._epipolar_distances(
        pts[None], valid[None], cfg.epipolar_gate_px, Fs))
    jPs, _, _, _, jFs = _jcal(rig, Rs, ts)
    jd, jg = (np.asarray(x) for x in jcorr._epipolar_distances(
        jnp.asarray(pts.numpy()), jnp.asarray(valid.numpy()), jPs,
        cfg.epipolar_gate_px, jFs))
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_allclose(d[g], jd[g], atol=1e-3)
    roots = correspond._compute_roots(torch.from_numpy(d)[None],
                                      torch.from_numpy(g)[None],
                                      valid[None])[0].numpy()
    jroots = np.asarray(jcorr._compute_roots(jnp.asarray(jd),
                                             jnp.asarray(jg),
                                             jnp.asarray(valid.numpy())))
    differ = np.argwhere(roots != jroots)
    assert len(differ) == 1 and differ[0][0] == 2         # one camera-2 root
    # the one earlier root whose closest camera-2 candidate differs, and
    # its two nearest candidates within 1e-3 px of each other
    flips = []
    for a in range(2):
        for k in range(cfg.max_blobs):
            m = g[a, k, 2]
            if m.any() and (np.argmin(np.where(m, d[a, k, 2], np.inf))
                            != np.argmin(np.where(m, jd[a, k, 2], np.inf))):
                flips.append(np.sort(d[a, k, 2][m])[:2])
    assert len(flips) == 1 and flips[0][1] - flips[0][0] < 1e-3


def test_mesh_engine_refusals():
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    src = SyntheticSource(rig, Rs, ts, num_drones=1)

    def build(mesh, **kw):
        return Engine(rig, EngineConfig(), src, CollectingLink(), mesh=mesh,
                      **kw)

    with pytest.raises(ValueError, match="divisible"):
        build(_cam_mesh(3))
    with pytest.raises(ValueError, match="preprocess"):
        build(_cam_mesh(2), preprocess_frames=True)
    with pytest.raises(ValueError, match="host_detect"):
        build(_cam_mesh(2), host_detect=True)
    with pytest.raises(ValueError, match="fast_path"):
        build(_cam_mesh(2), fast_path=False)
    with pytest.raises(ValueError, match="'cam' axis"):
        build(mesh_lib.make_mesh({"point": 2}, devices=[CPU] * 2))
    # the engine's device is the mesh's first
    assert build(_cam_mesh(2), device="cpu").device == CPU


def test_serve_cam_shards_needs_the_cards(monkeypatch, tmp_path):
    from low_cost_mocap_tpu_torch import serve

    args = serve.parse_args(["--cam-shards", "2", "--artifacts-dir",
                             str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build(args)
    # one card for two shards: too few
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs as many CUDA devices"):
        serve.build(args)


def _rows(eng, frames):
    """Every packed row ``eng`` decodes serving ``frames``, as (n, L)."""
    rows, decode = [], eng._decode

    def capture(rb):
        outs = decode(rb)               # waits for the row's copy
        buf = rb.ring.bufs[rb.slot]
        rows.append(buf.numpy().reshape(-1, buf.shape[-1]).copy())
        return outs

    eng._decode = capture
    for f in frames:
        eng.process_frame(f, 1 / 60)
    eng.flush_batches()
    return np.concatenate(rows)


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


@pytest.mark.parametrize("batch", [1, 4])
def test_compiled_mesh_steps_equal_the_eager_functions(batch):
    """The mesh engine's compiled step (CPU mode: op by op over its
    buffers) gives ``dist_frame_step``'s / ``dist_scan_frame_step``'s rows
    bit for bit at cam = 2 and 4; so does the several-device step, on a
    mesh whose shards alternate between "cpu" and "cpu:0" (two devices to
    the mesh, one to the tensors)."""
    B = 8
    Rs, ts, rig, frames = _frames(B)
    cfg = EngineConfig(dispatch_batch=batch)
    dts = np.full((batch,), 1 / 60, np.float32)
    meshes = {d: _cam_mesh(d) for d in (2, 4)}
    meshes["cpu, cpu:0"] = mesh_lib.make_mesh(
        {"cam": 4}, devices=[CPU, torch.device("cpu", 0)] * 2)
    for name, mesh in meshes.items():
        eng, _ = _engine(rig, Rs, ts, cfg, mesh=mesh)
        step = eng._steps["batched" if batch > 1 else "mesh"]
        assert isinstance(step, _ShardedStep) == (name == "cpu, cpu:0")
        got = _rows(eng, frames)
        state = pipeline.make_init_state(rig, device="cpu")
        cal = eng._calibration()
        want = []
        for i in range(0, B, batch):
            if batch > 1:
                state, rows = dist_scan_frame_step(
                    mesh, state, torch.as_tensor(np.stack([
                        detect.pack_frames(f, cfg.detect_threshold)
                        for f in frames[i:i + batch]])), dts, *cal, rig,
                    cfg, packed=True, with_obs=True)
            else:
                state, rows = dist_frame_step(
                    mesh, state, detect.pack_frames(
                        frames[i], cfg.detect_threshold), dts[0], *cal, rig,
                    cfg, packed=True, with_obs=True, pack=True)
            want.append(rows.reshape(-1, rows.shape[-1]).numpy())
        assert _same_bits(got, np.concatenate(want)), name


def test_a_mesh_across_processes_has_no_compiled_step():
    """A mesh with a ``torch.distributed`` group runs its step op by op by
    construction (its gather is a collective); one process's mesh has a
    compiled step per kind."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    devices = np.empty(2, dtype=object)
    devices[:] = [CPU, CPU]
    across = mesh_lib.Mesh(devices, ("cam",), group="a process group",
                           local=(0,))
    for batch in (1, 4):
        cfg = EngineConfig(dispatch_batch=batch)
        eng, _ = _engine(rig, Rs, ts, cfg, mesh=across)
        assert eng._steps == {}
        one, _ = _engine(rig, Rs, ts, cfg, mesh=_cam_mesh(2))
        assert list(one._steps) == ["batched" if batch > 1 else "mesh"]
