"""PyTorch port: the differential harness against the original
reference implementation.

The harness's numpy helpers (``utils/reference_impl.py``,
``utils/differential.py``) are copies: they are held equal to the JAX
package's here.  The comparisons against the reference itself are the
port of ``tests/test_reference_differential.py``, with the port's ops and
its ``track_from_blobs`` on the CPU.  They need the original repository's
checkout (``reference_impl.REFERENCE_API_DIR``) and skip without it.
"""

import numpy as np
import pytest
import torch

from low_cost_mocap_tpu.utils import differential as jdiff
from low_cost_mocap_tpu.utils import reference_impl as jref
from low_cost_mocap_tpu_torch.utils import differential, reference_impl
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)
needs_reference = pytest.mark.skipif(
    not reference_impl.reference_available(),
    reason="reference checkout not present")


def test_reference_rig_matches_jax():
    Rs, ts, rig = differential.reference_rig()
    jRs, jts, jrig = jdiff.reference_rig()
    np.testing.assert_array_equal(Rs, jRs)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(rig.K_stack(), jrig.K_stack())
    np.testing.assert_array_equal(rig.dist_stack(), jrig.dist_stack())
    assert differential.REF_K == jdiff.REF_K
    np.testing.assert_array_equal(rig.K_stack()[0], np.asarray(jdiff.REF_K))


@pytest.mark.parametrize("s, delta", [(+1, +0.01), (-1, -0.01)])
def test_drone_markers_and_display_frame_match_jax(s, delta):
    from low_cost_mocap_tpu_torch.ops import world

    _, _, rig = differential.reference_rig()
    _, _, jrig = jdiff.reference_rig()
    for t in np.linspace(0.0, 4.0, 9):
        for fn, jfn in ((differential._pos_a, jdiff._pos_a),
                        (differential._pos_b, jdiff._pos_b)):
            np.testing.assert_array_equal(fn(t), jfn(t))
        pos, phi = differential._pos_a(t), 0.6 * np.sin(0.4 * t)
        m = differential.drone_markers_display(pos, phi, s, delta, rig)
        np.testing.assert_array_equal(
            m, jdiff.drone_markers_display(pos, phi, s, delta, jrig))
        cam = differential.display_to_cam(m)
        np.testing.assert_array_equal(cam, jdiff.display_to_cam(m))
        # display_to_cam inverts the port's world transform at M = I
        back = world.to_world(torch.as_tensor(cam), torch.eye(4,
                                                      dtype=torch.float64))
        np.testing.assert_allclose(back.numpy(), m, atol=1e-12)


def test_fundamental_from_projections_matches_jax_and_epipolar():
    from low_cost_mocap_tpu_torch.ops import camera, epipolar

    Rs, ts, rig = differential.reference_rig()
    Ps = camera.projection_matrix(torch.as_tensor(rig.K_stack()),
                                  torch.as_tensor(Rs),
                                  torch.as_tensor(ts)).double()
    for i, j in ((0, 1), (1, 3), (2, 0)):
        F = reference_impl._fundamental_from_projections_np(Ps[i], Ps[j])
        np.testing.assert_array_equal(
            F, jref._fundamental_from_projections_np(Ps[i], Ps[j]))
        got = epipolar.fundamental_from_projections(Ps[i], Ps[j]).numpy()
        np.testing.assert_allclose(got / np.abs(got).max(),
                                   F / np.abs(F).max(), atol=1e-9)


def test_fake_clock_and_the_reference_gate_match_jax(tmp_path):
    for mod in (reference_impl, jref):
        clock = mod.FakeClock()
        assert clock.time() == 1.7e9
        clock.advance(0.5)
        assert clock.time() == 1.7e9 + 0.5
    assert reference_impl.REFERENCE_API_DIR == jref.REFERENCE_API_DIR
    assert (reference_impl.reference_available()
            == jref.reference_available())
    assert reference_impl.reference_available(str(tmp_path))
    assert not reference_impl.reference_available(str(tmp_path / "no"))
    with pytest.raises(FileNotFoundError):
        reference_impl.load_reference(str(tmp_path / "no"))
    stub = reference_impl._stub_pseyepy(4)
    cam = stub.Camera()
    assert len(cam.exposure) == 4 and cam.RES_SMALL == 0


@pytest.fixture(scope="module")
def ref():
    return reference_impl.load_reference()


@pytest.fixture(scope="module")
def rig4():
    return differential.reference_rig()


def _calib(rig, Rs, ts):
    from low_cost_mocap_tpu_torch.ops import camera as cam_ops

    return cam_ops.projection_matrix(torch.as_tensor(rig.K_stack()),
                                     torch.as_tensor(Rs), torch.as_tensor(ts))


@needs_reference
def test_triangulate_points_matches_reference(ref, rig4):
    from low_cost_mocap_tpu_torch.ops import triangulate

    Rs, ts, rig = rig4
    rng = np.random.default_rng(3)
    X = syn.random_points(rng, 40)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=0.3, rng=rng)
    assert mask.all()
    poses = [{"R": Rs[i].tolist(), "t": ts[i].tolist()} for i in range(4)]
    ref_X = ref.helpers.triangulate_points(pts.astype(np.float64), poses)
    Ps = _calib(rig, Rs, ts)
    repo_X, valid = triangulate.triangulate_points(
        torch.as_tensor(pts), Ps, torch.as_tensor(mask))
    assert bool(valid.all())
    d = np.linalg.norm(np.asarray(ref_X) - repo_X.numpy(), axis=1)
    assert d.max() < 1e-5
    mask2 = mask.copy()
    mask2[0, 1:] = False
    pts_ref = pts.astype(object).copy()
    pts_ref[0, 1:] = None
    ref_X2 = ref.helpers.triangulate_points(pts_ref, poses)
    assert all(v is None for v in np.asarray(ref_X2[0]).ravel())
    _, valid2 = triangulate.triangulate_points(
        torch.as_tensor(pts), Ps, torch.as_tensor(mask2))
    assert not bool(valid2[0]) and bool(valid2[1:].all())


@needs_reference
def test_locate_objects_matches_reference(ref, rig4):
    from low_cost_mocap_tpu_torch.ops import rigid

    _, _, rig = rig4
    rng = np.random.default_rng(11)
    for trial in range(8):
        pts = []
        for s, dlt in ((+1, +0.01), (-1, -0.01)):
            pos = rng.uniform(-0.5, 0.5, 3)
            phi = rng.uniform(-1.0, 1.0)
            u = np.array([np.cos(phi), np.sin(phi), 0.0])
            w = np.array([-np.sin(phi), np.cos(phi), 0.0])
            h = np.sqrt(rig.marker_dist_short ** 2
                        - (rig.marker_dist_long / 2) ** 2)
            pts += [pos + 0.075 * u, pos - 0.075 * u,
                    pos + s * h * w + np.array([0.0, dlt, 0.0])]
        pts += [rng.uniform(-0.5, 0.5, 3) + np.array([0, 0, 2.0]),
                rng.uniform(-0.5, 0.5, 3) - np.array([0, 0, 2.0])]
        cloud = np.asarray(pts)
        errors = np.abs(np.random.default_rng(0).normal(size=len(cloud)))
        ref_objs = ref.helpers.locate_objects(cloud, errors)
        got = rigid.locate_objects(
            torch.as_tensor(cloud, dtype=torch.float32)[None],
            torch.as_tensor(errors, dtype=torch.float32)[None],
            torch.ones(1, len(cloud), dtype=torch.bool),
            dist1=rig.marker_dist_short, dist2=rig.marker_dist_long,
            tol=rig.marker_dist_tol, ax_h1=0, ax_h2=1, side_min=0.0)
        gv = got.valid[0].numpy()
        assert gv.sum() == len(ref_objs) == 2
        ref_by_idx = {o["droneIndex"]: o for o in ref_objs}
        for slot in np.flatnonzero(gv):
            r = ref_by_idx[int(got.index[0, slot])]
            np.testing.assert_allclose(got.pos[0, slot].numpy(), r["pos"],
                                       atol=1e-5)
            np.testing.assert_allclose(float(got.heading[0, slot]),
                                       float(r["heading"]), atol=1e-5)
            np.testing.assert_allclose(float(got.error[0, slot]),
                                       float(r["error"]), atol=1e-5)


def _run(**kw):
    return differential.run_differential(device="cpu", **kw)


@needs_reference
def test_tracked_trajectory_matches_reference_within_its_ate():
    m = _run(T=240, noise_px=0.3, seed=7)
    for idx in (0, 1):
        r = m[idx]
        assert r["frames_common"] >= 230, r
        assert r["ate_ref_vs_repo_mm"] <= r["ate_ref_vs_truth_mm"] * 1.10, r
        assert r["ate_ref_vs_repo_mm"] < 6.0, r
        assert r["ate_ref_vs_repo_steady_mm"] < 3.0, r
        assert r["ate_repo_vs_truth_mm"] <= r["ate_ref_vs_truth_mm"], r


@needs_reference
def test_partial_occlusion_tracks_through_where_reference_drops_out():
    m = _run(T=140, occlusions=((60, 100, 2, 0, 3),))
    occluded, clear = m[0], m[1]
    assert occluded["frames_ref"] <= 100, occluded
    assert occluded["frames_repo"] >= occluded["frames_ref"] + 20, occluded
    assert (occluded["ate_ref_vs_repo_mm"]
            <= occluded["ate_ref_vs_truth_mm"] * 1.10), occluded
    assert (occluded["ate_repo_vs_truth_mm"]
            <= occluded["ate_ref_vs_truth_mm"] * 0.45), occluded
    assert clear["ate_ref_vs_repo_steady_mm"] < 3.0, clear
    assert clear["frames_common"] >= 135, clear


@needs_reference
def test_full_dropout_reacquisition():
    m = _run(T=200, occlusions=((80, 110, -1, 0, 3),))
    r = m[0]
    assert r["frames_ref"] >= 165 and r["frames_repo"] >= 160, r
    assert r["ate_ref_vs_repo_steady_mm"] < 3.0, r
    assert (r["postgap_repo_vs_truth_mm"]
            <= r["postgap_ref_vs_truth_mm"] * 0.6), r
    assert m[1]["ate_ref_vs_repo_steady_mm"] < 3.0, m[1]


@needs_reference
def test_distractor_blobs_parity():
    m = _run(T=140, n_distractors=2)
    for idx in (0, 1):
        r = m[idx]
        assert r["frames_common"] >= 125, r
        assert r["ate_ref_vs_repo_steady_mm"] < 3.0, r
        assert r["ate_repo_vs_truth_steady_mm"] < 3.5, r
        assert r["ate_repo_vs_truth_mm"] <= r["ate_ref_vs_truth_mm"], r


@needs_reference
def test_crowded_scene_beyond_candidate_budget():
    m = _run(T=140, n_extra_markers=4, max_blobs=16)
    for idx in (0, 1):
        r = m[idx]
        assert r["frames_common"] >= 130, r
        assert r["ate_ref_vs_repo_steady_mm"] < 3.5, r
        assert r["ate_repo_vs_truth_mm"] <= r["ate_ref_vs_truth_mm"], r


@pytest.mark.slow
@needs_reference
def test_tracked_trajectory_zero_noise_structural_parity():
    m = _run(T=240, noise_px=0.0, seed=7)
    for idx in (0, 1):
        r = m[idx]
        assert r["frames_common"] == 240, r
        assert r["ate_ref_vs_repo_steady_mm"] < 0.8, r


@needs_reference
def test_reprojection_errors_match_reference(ref, rig4):
    from low_cost_mocap_tpu_torch.ops import triangulate as tri

    Rs, ts, rig = rig4
    rng = np.random.default_rng(9)
    X = syn.random_points(rng, 25)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=0.7, rng=rng)
    assert mask.all()
    poses = [{"R": Rs[i].tolist(), "t": ts[i].tolist()} for i in range(4)]
    ref_err = ref.helpers.calculate_reprojection_errors(
        pts.astype(np.float64), X.astype(np.float64), poses)
    ours = tri.reprojection_errors(torch.as_tensor(pts), torch.as_tensor(X),
                                   _calib(rig, Rs, ts),
                                   torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_err), rtol=1e-4,
                               atol=1e-5)


@needs_reference
def test_lowpass_filter_matches_reference_stream(ref):
    from low_cost_mocap_tpu_torch.ops import lowpass

    rng = np.random.default_rng(2)
    x = rng.normal(size=(250, 3)).astype(np.float64)
    lpf_ref = ref.LowPassFilter.LowPassFilter(
        cutoff_frequency=20, sampling_frequency=60.0, dims=3)
    b, a = (torch.as_tensor(c) for c in lowpass.butter_coeffs())
    s = lowpass.init_state((3,), device="cpu")
    for t in range(len(x)):
        want = lpf_ref.filter(x[t])
        s, got = lowpass.lpf_step(
            s, torch.as_tensor(x[t], dtype=torch.float32), b, a)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@needs_reference
def test_bundle_adjustment_beats_reference_on_its_own_metric(ref, rig4):
    import contextlib
    import io
    import types as types_mod

    from scipy.spatial.transform import Rotation

    from low_cost_mocap_tpu_torch.ops import ba as ba_ops

    Rs, ts, rig = rig4
    rng = np.random.default_rng(5)
    R0, t0 = Rs[0].copy(), ts[0].copy()
    Rs_g = np.einsum("cij,jk->cik", Rs, R0.T).astype(np.float64)
    ts_g = (ts - np.einsum("cij,j->ci", Rs_g, t0)).astype(np.float64)
    F = 40
    t = np.arange(F) * 0.2
    X = np.stack([0.45 * np.sin(0.9 * t), 0.45 * np.cos(0.7 * t),
                  0.5 + 0.3 * np.sin(0.35 * t)], -1).astype(np.float32)
    X_g = (X @ R0.T + t0).astype(np.float32)
    K = rig.K_stack().astype(np.float64)
    pts = np.zeros((F, 4, 2), np.float32)
    for c in range(4):
        Xc = X_g @ Rs_g[c].T + ts_g[c]
        uv = Xc @ K[c].T
        pts[:, c] = (uv[:, :2] / uv[:, 2:3]) + rng.normal(scale=0.5,
                                                          size=(F, 2))
    Rs_p, ts_p = Rs_g.copy(), ts_g.copy()
    for c in range(1, 4):
        Rs_p[c] = (Rotation.from_rotvec(rng.normal(scale=0.02, size=3))
                   .as_matrix() @ Rs_g[c])
        ts_p[c] = ts_g[c] + rng.normal(scale=0.03, size=3)
    poses_p = [{"R": Rs_p[c], "t": ts_p[c]} for c in range(4)]

    def mean_err(poses):
        op = ref.helpers.triangulate_points(pts.astype(np.float64), poses)
        return float(np.mean(ref.helpers.calculate_reprojection_errors(
            pts.astype(np.float64), op, poses)))

    e_init = mean_err([{"R": p["R"].copy(), "t": p["t"].copy()}
                       for p in poses_p])
    dummy = types_mod.SimpleNamespace(emit=lambda *a, **k: None)
    with contextlib.redirect_stdout(io.StringIO()):
        ref_out = ref.helpers.bundle_adjustment(
            pts.astype(np.float64),
            [{"R": p["R"].copy(), "t": p["t"].copy()} for p in poses_p],
            dummy)
    e_ref = mean_err([{"R": np.asarray(p["R"]), "t": np.asarray(p["t"])}
                      for p in ref_out])
    res = ba_ops.bundle_adjust(
        torch.as_tensor(pts), torch.ones(F, 4, dtype=torch.bool),
        torch.as_tensor(rig.K_stack()),
        torch.as_tensor(Rs_p, dtype=torch.float32),
        torch.as_tensor(ts_p, dtype=torch.float32), num_cameras=4,
        mode="reference", freeze_focals=True)
    e_ours = mean_err([{"R": res.Rs[c].double().numpy(),
                        "t": res.ts[c].double().numpy()} for c in range(4)])
    assert e_ref < e_init * 0.1, (e_ref, e_init)
    assert e_ours <= e_ref * 1.05, (e_ours, e_ref)
    for c in range(1, 4):
        Rr = np.asarray(ref_out[c]["R"])
        Ro = res.Rs[c].double().numpy()
        ang = np.degrees(np.arccos(np.clip(
            (np.trace(Rr @ Ro.T) - 1) / 2, -1, 1)))
        assert ang < 5.0, (c, ang)
