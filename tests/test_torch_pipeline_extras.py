"""PyTorch port: the pipeline's remaining entry points and small ops
against the JAX package — ``MocapPipeline`` (``tests/test_pipeline.py``),
``batched_track_from_blobs`` (``tests/test_multirig.py``), the display
remap ``build_undistort_map``/``undistort_image``
(``tests/test_camera.py``), the single-frame ``find_blobs`` with and
without ``integer_centroids`` (``tests/test_detect.py``), ``lpf_scan``,
and ``fit_floor`` on degenerate floor clouds.

Discrete outputs are exactly equal, floats within 1e-5 (the multi-rig
JAX run is jitted and its Kalman chain fuses multiply-adds, so tracked
positions there within 1e-4: ROADMAP.md §3).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
from low_cost_mocap_tpu.models import pipeline as jpipe
from low_cost_mocap_tpu.ops import camera as jcam
from low_cost_mocap_tpu.ops import correspond as jcorr
from low_cost_mocap_tpu.ops import detect as jdetect
from low_cost_mocap_tpu.ops import lowpass as jlow
from low_cost_mocap_tpu.ops import world as jworld
from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.models import pipeline
from low_cost_mocap_tpu_torch.ops import camera, correspond, detect, lowpass
from low_cost_mocap_tpu_torch.ops import world
from low_cost_mocap_tpu_torch.utils import synthetic as syn
from low_cost_mocap_tpu_torch.utils import tree

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _outputs_close(got, want, pos_atol=1e-5):
    for name in ("blob_valid", "point_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("blob_px", "object_points"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL)
    np.testing.assert_array_equal(got.objects.valid.numpy(),
                                  np.asarray(want.objects.valid))
    np.testing.assert_array_equal(got.objects.index.numpy(),
                                  np.asarray(want.objects.index))
    np.testing.assert_array_equal(got.tracked.valid.numpy(),
                                  np.asarray(want.tracked.valid))
    np.testing.assert_allclose(got.tracked.pos.numpy(),
                               np.asarray(want.tracked.pos), atol=pos_atol)


def test_mocap_pipeline_step_matches_jax():
    """tests/test_pipeline.py:64's moving drone, frame by frame, on both
    packages' MocapPipeline (no preprocessing, as that test runs)."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    jp = jpipe.MocapPipeline(rig_for_jax(rig), JEngineConfig(), Rs, ts,
                             preprocess_frames=False)
    tp = pipeline.MocapPipeline(rig, EngineConfig(), Rs, ts,
                                preprocess_frames=False, device="cpu")
    assert tp.device.type == "cpu"
    js, st = jp.init_state(), tp.init_state()
    for t in range(12):
        pos = np.array([0.1 + 0.004 * t, 0.0, 0.6], np.float32)
        pts, mask = syn.observe(syn.drone_markers(pos, 0.0, rig), Rs, ts, rig)
        frames = syn.render_frames(pts, mask, rig.image_size, sigma=0.8)
        js, jout = jp.step(js, jnp.asarray(frames), 1.0 / 60.0)
        st, out = tp.step(st, frames, 1.0 / 60.0)
        _outputs_close(out, jout, pos_atol=1e-4)
    assert int(out.point_valid.sum()) == 3 and bool(out.tracked.valid.any())


def test_mocap_pipeline_preprocesses_and_needs_cuda_unless_asked(
        monkeypatch):
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.MocapPipeline(rig, EngineConfig(), Rs, ts)
    tp = pipeline.MocapPipeline(rig, EngineConfig(), Rs, ts, device="cpu")
    assert tp.preprocess_frames
    pts, mask = syn.observe(syn.drone_markers([0.1, 0.0, 0.6], 0.0, rig),
                            Rs, ts, rig)
    frames = syn.render_frames(pts, mask, rig.image_size, sigma=0.8)
    _, out = tp.step(tp.init_state(), torch.from_numpy(frames), 1 / 60)
    assert int(out.blob_valid.sum()) >= 9


def rig_for_jax(rig):
    from low_cost_mocap_tpu.config import RigConfig as JRigConfig

    return JRigConfig(num_cameras=rig.num_cameras, image_size=rig.image_size)


def _rig_inputs(seed):
    """tests/test_multirig.py's rigs: ring radii 1.8-2.2 m, five points."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4, radius=1.8 + 0.2 * (seed % 3))
    rng = np.random.default_rng(seed)
    pts, mask = syn.observe(syn.random_points(rng, 5), Rs, ts, rig)
    slots = np.zeros((4, 8, 2), np.float32)
    ok = np.zeros((4, 8), bool)
    for c in range(4):
        vis = np.where(mask[:, c])[0]
        slots[c, :len(vis)] = pts[vis, c]
        ok[c, :len(vis)] = True
    Ps = camera.projection_matrix(torch.tensor(rig.K_stack()),
                                  torch.tensor(Rs), torch.tensor(ts))
    return rig, slots, ok, Ps


def test_batched_track_from_blobs_matches_per_rig_and_jax():
    R = 3
    per = [_rig_inputs(s) for s in range(R)]
    rig = per[0][0]
    kw = dict(gate_px=5.0, max_candidates=2,
              marker_dist1=rig.marker_dist_short,
              marker_dist2=rig.marker_dist_long,
              marker_tol=rig.marker_dist_tol,
              marker_side_min=rig.marker_side_min, with_obs=True)
    K = torch.tensor(rig.K_stack()).expand(R, 4, 3, 3)
    dist = torch.tensor(rig.dist_stack()).expand(R, 4, 5)
    M = torch.eye(4).expand(R, 4, 4)
    Ps = torch.stack([p[3] for p in per])
    Fs = torch.stack([correspond._pairwise_fundamentals(p) for p in Ps])
    blobs = torch.tensor(np.stack([p[1] for p in per]))
    valid = torch.tensor(np.stack([p[2] for p in per]))
    dts = torch.full((R,), 1 / 60)
    states = tree.stack([pipeline.make_init_state(rig, device="cpu")
                         for _ in range(R)])
    # two steps, the second from the carried states
    for _ in range(2):
        states, bout = pipeline.batched_track_from_blobs(
            states, blobs, valid, dts, Ps, K, dist, M, Fs, **kw)
    jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jpipe.make_init_state(rig_for_jax(rig)) for _ in range(R)])
    jarg = lambda t: jnp.asarray(t.numpy())
    jkw = {k: v for k, v in kw.items()}
    for _ in range(2):
        jstates, jout = jpipe.batched_track_from_blobs(
            jstates, jarg(blobs), jarg(valid), jarg(dts), jarg(Ps), jarg(K),
            jarg(dist), jarg(M), jarg(Fs), **jkw)
    _outputs_close(bout, jout, pos_atol=1e-4)
    np.testing.assert_array_equal(bout.point_obs_mask.numpy(),
                                  np.asarray(jout.point_obs_mask))
    for r in range(R):
        st = pipeline.make_init_state(rig, device="cpu")
        for _ in range(2):
            st, out = pipeline.track_from_blobs(
                st, blobs[r], valid[r], dts[r], Ps[r], K[r], dist[r], M[r],
                Fs[r], **kw)
        for a, b in zip(pipeline.pack_outputs(out),
                        pipeline.pack_outputs(tree.tree_map(
                            lambda x: x[r], bout))):
            assert torch.equal(a, b)
        assert torch.equal(states.x[r], st.x)


def test_undistort_map_and_image_match_jax():
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 160.0], [0, 0, 1.0]],
                 np.float32)
    dist = np.array([-0.12, 0.05, 0.001, -0.002, 0.01], np.float32)
    H, W = 96, 128
    jmap = jcam.build_undistort_map(jnp.asarray(K), jnp.asarray(dist), H, W)
    tmap = camera.build_undistort_map(torch.tensor(K), torch.tensor(dist), H,
                                      W)
    np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), **TOL)
    rng = np.random.default_rng(3)
    for img in (rng.integers(0, 256, (H, W), dtype=np.uint8),
                rng.random((H, W, 3)).astype(np.float32)):
        got = camera.undistort_image(torch.tensor(img), tmap)
        want = jcam.undistort_image(jnp.asarray(img), jmap)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_find_blobs_single_frame_and_integer_centroids_match_jax():
    pts = np.array([[[50.0, 60.0]], [[200.5, 120.25]], [[100.6, 50.4]]],
                   np.float32)
    frame = syn.render_frames(pts, np.ones((3, 1), bool), 320, sigma=1.5)[0]
    for ic in (False, True):
        jc, jv, js = jdetect.find_blobs(jnp.asarray(frame), 0.2, max_blobs=4,
                                        integer_centroids=ic)
        tcen, tv, tsz = detect.find_blobs(torch.tensor(frame), 0.2,
                                          max_blobs=4, integer_centroids=ic)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tsz.numpy(), np.asarray(js))
        np.testing.assert_allclose(tcen.numpy(), np.asarray(jc), **TOL)
        assert int(tv.sum()) == 3
        if ic:
            np.testing.assert_array_equal(tcen.numpy(),
                                          np.floor(tcen.numpy()))
    frames = np.stack([frame, np.zeros_like(frame)])
    a = detect.find_blobs_multi(torch.tensor(frames), 0.2, 4,
                                integer_centroids=True)
    b = jdetect.find_blobs_multi(jnp.asarray(frames), 0.2, 4,
                                 integer_centroids=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_lpf_scan_matches_jax_and_the_step_loop():
    b, a = lowpass.butter_coeffs()
    x = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    got = lowpass.lpf_scan(torch.tensor(x), b, a)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jlow.lpf_scan(jnp.asarray(x), b, a)), **TOL)
    s = lowpass.init_state((3,), device="cpu")
    tb, ta = torch.tensor(b), torch.tensor(a)
    for t in range(50):
        s, y = lowpass.lpf_step(s, torch.tensor(x[t]), tb, ta)
        assert torch.equal(y, got[t])
    # from a given state
    s0 = torch.tensor(np.random.default_rng(2).normal(size=(3, 5)),
                      dtype=torch.float32)
    np.testing.assert_allclose(
        lowpass.lpf_scan(torch.tensor(x), b, a, state=s0).numpy(),
        np.asarray(jlow.lpf_scan(jnp.asarray(x), b, a,
                                 state=jnp.asarray(s0.numpy()))), **TOL)


@pytest.mark.parametrize("cloud", ["two_points", "collinear", "one_point",
                                   "plane"])
def test_fit_floor_on_degenerate_clouds_matches_jax(cloud):
    """The SVD minimum-norm plane: finite and JAX's matrix within 1e-5 on
    clouds that leave the plane underdetermined."""
    rng = np.random.default_rng(4)
    pts = {"two_points": np.array([[0.1, 0.02, 0.3], [-0.4, 0.05, 0.2]]),
           "collinear": np.array([[t, 0.01 + 0.02 * t, 0.5 - t]
                                  for t in np.linspace(-0.5, 0.5, 12)]),
           "one_point": np.array([[0.2, 0.03, -0.1]]),
           "plane": np.concatenate([rng.uniform(-0.6, 0.6, (40, 1)),
                                    rng.normal(0, 1e-3, (40, 1)),
                                    rng.uniform(-0.6, 0.6, (40, 1))], 1),
           }[cloud].astype(np.float32)
    M = np.eye(4, dtype=np.float32)
    M[:3, 3] = [0.1, -0.2, 0.05]
    want = np.asarray(jworld.fit_floor(jnp.asarray(pts), jnp.asarray(M)))
    got = world.fit_floor(torch.tensor(pts), torch.tensor(M)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_serve_builds_and_answers_with_sixteen_cameras(tmp_path):
    """``serve --cameras 16`` on the synthetic source (one drone): the
    engine matches in assoc mode (auto above five cameras) and tracks the
    drone."""
    from low_cost_mocap_tpu_torch import serve
    from low_cost_mocap_tpu_torch.runtime.engine import \
        camera_poses_to_serializable

    engine, _, source, _ = serve.build(serve.parse_args(
        ["--port", "0", "--link", "none", "--cameras", "16",
         "--artifacts-dir", str(tmp_path)]), device="cpu")
    assert engine.rig.num_cameras == 16
    got = []
    engine.on("object-points", got.append)
    Rs, ts = engine.camera_poses
    engine.handle("triangulate-points", {
        "startOrStop": "start",
        "cameraPoses": camera_poses_to_serializable(Rs, ts)})
    engine.handle("locate-objects", {"startOrStop": "start"})
    for i in range(6):
        engine.process_frame(source.read_at(i / 60), 1 / 60)
    engine.flush_batches()
    assert len(got) == 6
    assert len(got[-1]["object_points"]) == 3
    assert len(got[-1]["filtered_objects"]) == 1
