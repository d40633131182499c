"""PyTorch port: the calibration ops against the JAX package on the CPU.

Rotations against JAX and scipy (atol 1e-6); epipolar relations (rtol
1e-5); RANSAC fed JAX's own sample tables (inlier mask equal, F / F[2,2]
within 1e-3 relative); bundle adjustment's residuals (rtol 1e-5) and
Jacobian against ``jax.jacfwd`` (rtol 1e-4), and full solves (poses within
1e-3 of JAX's); the pose bootstrap and the whole calibration on JAX's
draws (relative rotations within 1e-3); floor, origin and scale (atol
1e-5).  Inputs are the scenes of ``tests/test_calibration.py`` and
``tests/test_world.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from low_cost_mocap_tpu.models import calibrator as jcalib
from low_cost_mocap_tpu.ops import ba as jba
from low_cost_mocap_tpu.ops import epipolar as jepi
from low_cost_mocap_tpu.ops import ransac as jransac
from low_cost_mocap_tpu.ops import rotations as jrot
from low_cost_mocap_tpu.ops import world as jworld
from low_cost_mocap_tpu_torch.models import calibrator
from low_cost_mocap_tpu_torch.ops import ba, camera, epipolar, ransac
from low_cost_mocap_tpu_torch.ops import rotations as rot
from low_cost_mocap_tpu_torch.ops import triangulate, world
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rotvecs():
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-7, 3e-4, 0.7, np.pi - 5e-4, np.pi - 1e-5])
    return (axes * angles[:, None]).astype(np.float32)


def test_rotations_match_jax_and_scipy():
    rv = _rotvecs()
    R = rot.rotvec_to_matrix(_t(rv)).numpy()
    np.testing.assert_allclose(R, np.asarray(jrot.rotvec_to_matrix(
        jnp.asarray(rv))), atol=1e-6)
    np.testing.assert_allclose(R, Rotation.from_rotvec(rv).as_matrix(),
                               atol=1e-6)
    back = rot.matrix_to_rotvec(_t(R)).numpy()
    back_j = np.asarray(jrot.matrix_to_rotvec(jnp.asarray(R)))
    np.testing.assert_allclose(back, back_j, atol=1e-6)
    np.testing.assert_allclose(back[:4], Rotation.from_matrix(
        R[:4].astype(np.float64)).as_rotvec(), atol=1e-6)
    # near pi the axis comes from square roots of the diagonal, whose
    # float32 rounding both packages share: scipy's answer (the sign of a
    # half turn is a convention, so compare the rotations) is met to 1e-3
    for got in (back[4:], back_j[4:]):
        np.testing.assert_allclose(Rotation.from_rotvec(got).as_matrix(),
                                   R[4:], atol=1e-3)
    # one matrix without a batch axis takes the same path
    np.testing.assert_allclose(rot.matrix_to_rotvec(_t(R[4])).numpy(),
                               back[4], atol=0)
    q = rot.matrix_to_quat(_t(R)).numpy()
    np.testing.assert_allclose(q, np.asarray(jrot.matrix_to_quat(
        jnp.asarray(R))), atol=1e-6)
    np.testing.assert_allclose(rot.quat_to_matrix(_t(q)).numpy(), R,
                               atol=1e-6)
    np.testing.assert_allclose(rot.quat_to_matrix_np(q),
                               jrot.quat_to_matrix_np(q), atol=1e-6)
    v = rv[3]
    np.testing.assert_allclose(rot.hat(_t(v)).numpy() @ np.ones(3),
                               np.cross(v, np.ones(3)), atol=1e-6)


def _correspondences(n=100, noise=0.5, outliers=0, seed=0, n_cams=2):
    Rs, ts, rig = syn.ring_rig(num_cameras=n_cams)
    rng = np.random.default_rng(seed)
    X = syn.random_points(rng, n)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=noise, rng=rng)
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        pts[idx, 1] = rng.random((outliers, 2)) * 300
    return X, pts, mask, Rs, ts, rig


def _jax_draws(key, mask, iters):
    """JAX's own RANSAC sample table, as ``ransac_fundamental`` draws it."""
    m = jnp.asarray(mask)
    probs = m.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.asarray(jax.random.choice(key, m.shape[0], shape=(iters, 8),
                                        p=probs))


def _jax_pair_tables(key, mask, iters):
    """One table per adjacent camera pair, as ``bootstrap_poses`` draws."""
    keys = jax.random.split(key, mask.shape[1] - 1)
    return [_t(_jax_draws(keys[i], mask[:, i] & mask[:, i + 1], iters))
            for i in range(mask.shape[1] - 1)]


def test_epipolar_relations_match_jax():
    X, pts, mask, Rs, ts, rig = _correspondences(n=30, noise=0.3, seed=5)
    K = rig.K_stack()
    Ps = camera.projection_matrix(_t(K), _t(Rs), _t(ts))
    F = epipolar.fundamental_from_projections(Ps[0], Ps[1])
    F = F / F[2, 2]
    Fj = jnp.asarray(F.numpy())
    p1, p2 = pts[:, 0], pts[:, 1]
    rt = dict(rtol=1e-5, atol=1e-6)
    lines = epipolar.epiline(_t(p1), F)
    np.testing.assert_allclose(lines.numpy(), np.asarray(
        jepi.epiline(jnp.asarray(p1), Fj)), **rt)
    np.testing.assert_allclose(
        epipolar.point_line_distance(_t(p2), lines).numpy(),
        np.asarray(jepi.point_line_distance(jnp.asarray(p2),
                                            jepi.epiline(jnp.asarray(p1), Fj))),
        rtol=1e-5, atol=1e-4)
    # x2ᵀ F x1 cancels to a fraction of a pixel from terms of hundreds: the
    # two packages' summation orders differ there by ~1e-5 px²
    np.testing.assert_allclose(
        epipolar.sampson_distance(_t(p1), _t(p2), F).numpy(),
        np.asarray(jepi.sampson_distance(jnp.asarray(p1), jnp.asarray(p2),
                                         Fj)), rtol=1e-5, atol=2e-5)
    # a batch of F's against one point set, as RANSAC scores its trials
    Fb = torch.stack([F, F * 2.0])
    np.testing.assert_allclose(
        epipolar.sampson_distance(_t(p1), _t(p2), Fb)[1].numpy(),
        epipolar.sampson_distance(_t(p1), _t(p2), F).numpy(), rtol=1e-5)
    E = epipolar.essential_from_fundamental(F, _t(K[0]), _t(K[1]))
    Ej = jepi.essential_from_fundamental(Fj, jnp.asarray(K[0]),
                                         jnp.asarray(K[1]))
    np.testing.assert_allclose(E.numpy(), np.asarray(Ej), **rt)
    Rc, tc = epipolar.motion_from_essential(E)
    Rcj, tcj = (np.asarray(a) for a in jepi.motion_from_essential(Ej))
    # the four candidates as a set: SVD signs may order them differently
    for R, t in zip(Rc.numpy(), tc.numpy()):
        assert min(np.abs(R - Rj).max() + np.abs(t - tj).max()
                   for Rj, tj in zip(Rcj, tcj)) < 1e-4
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    # the true relative rotation is one of them
    R_rel = Rs[1] @ Rs[0].T
    assert min(np.abs(R - R_rel).max() for R in Rc.numpy()) < 2e-2


def test_ransac_fed_jax_draws_matches_jax():
    X, pts, mask, Rs, ts, rig = _correspondences(n=120, noise=0.3,
                                                 outliers=30)
    m = mask.all(axis=1)
    key = jax.random.PRNGKey(0)
    Fj, inl_j = jransac.ransac_fundamental(
        key, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(m))
    idx = _jax_draws(key, m, 512)
    F, inl = ransac.ransac_fundamental(_t(pts[:, 0]), _t(pts[:, 1]), _t(m),
                                       idx=_t(idx))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    Fj = np.asarray(Fj)
    assert np.abs(F.numpy() - Fj).max() <= 1e-3 * np.abs(Fj).max()
    assert float(F[2, 2]) == 1.0


def test_ransac_with_its_own_generator_recovers_geometry():
    X, pts, mask, Rs, ts, rig = _correspondences(n=120, noise=0.3,
                                                 outliers=30)
    g = torch.Generator().manual_seed(0)
    F, inl = ransac.ransac_fundamental(
        _t(pts[:, 0]), _t(pts[:, 1]), _t(mask.all(axis=1)), generator=g)
    assert int(inl.sum()) >= 70
    clean = inl.numpy()
    d = epipolar.sampson_distance(_t(pts[clean, 0]), _t(pts[clean, 1]), F)
    assert np.sqrt(np.median(d.numpy())) < 1.0
    # the same generator state gives the same table
    a = ransac.draw_samples(_t(mask[:, 0]), 4, torch.Generator().manual_seed(3))
    b = ransac.draw_samples(_t(mask[:, 0]), 4, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (4, 8)


def _gauged_scene(seed, n=60, rot_sd=0.03, t_sd=0.05):
    """The perturbed 4-camera scenes of tests/test_calibration.py, in the
    camera-0 frame (BA's gauge)."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    rng = np.random.default_rng(seed)
    X = syn.random_points(rng, n)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=0.3, rng=rng)
    R0, t0 = Rs[0].copy(), ts[0].copy()
    Rs = np.einsum("cij,jk->cik", Rs, R0.T).astype(np.float32)
    ts = (ts - np.einsum("cij,j->ci", Rs, t0)).astype(np.float32)
    dR = np.asarray(jrot.rotvec_to_matrix(jnp.asarray(
        rng.normal(scale=rot_sd, size=(4, 3)).astype(np.float32))))
    Rs_p = np.einsum("cij,cjk->cik", dR, Rs).astype(np.float32)
    ts_p = (ts + rng.normal(scale=t_sd, size=ts.shape)).astype(np.float32)
    Rs_p[0], ts_p[0] = np.eye(3, dtype=np.float32), 0
    return pts, mask, rig.K_stack(), Rs, ts, Rs_p, ts_p


def test_ba_params_roundtrip_and_match_jax():
    _, _, K, Rs, ts, _, _ = _gauged_scene(3)
    focals = K[:, 0, 0]
    p = ba.pack_params(_t(Rs), _t(ts), _t(focals))
    pj = jba.pack_params(jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(focals))
    assert p.shape == (1 + 7 * 3,)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-6)
    R2, t2, f2 = ba.unpack_params(p, 4)
    np.testing.assert_allclose(R2.numpy(), Rs, atol=1e-5)
    np.testing.assert_allclose(t2.numpy()[1:], ts[1:], atol=1e-6)
    np.testing.assert_array_equal(f2.numpy(), focals)
    K2 = ba._apply_focals(_t(K), f2 * 1.5).numpy()
    np.testing.assert_array_equal(K2, np.asarray(jba._apply_focals(
        jnp.asarray(K), jnp.asarray(focals * 1.5))))


@pytest.mark.parametrize("mode", ["pixel", "reference"])
def test_ba_residuals_and_jacobian_match_jax(mode):
    pts, mask, K, _, _, Rs_p, ts_p = _gauged_scene(3)
    mask = mask.copy()
    mask[5, 1:] = False                  # a one-view point: residuals 0
    p = ba.pack_params(_t(Rs_p), _t(ts_p), _t(K[:, 0, 0]))
    args = (_t(pts), _t(mask), _t(K), 4, mode)
    jargs = (jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(K), 4, mode)
    pj = jnp.asarray(p.numpy())
    r = ba.residuals(p, *args).numpy()
    rj = np.asarray(jba.residuals(pj, *jargs))
    scale = np.abs(rj).max()
    np.testing.assert_allclose(r, rj, rtol=1e-5, atol=1e-5 * scale)
    J = torch.func.jacfwd(lambda q: ba.residuals(q, *args))(p).numpy()
    Jj = np.asarray(jax.jacfwd(lambda q: jba.residuals(q, *jargs))(pj))
    assert np.isfinite(J).all()
    np.testing.assert_allclose(J, Jj, rtol=1e-4, atol=1e-4 * np.abs(Jj).max())


def _unit(ts):
    """Translations divided by their overall norm, sign fixed by camera 1's
    first component."""
    ts = np.asarray(ts, np.float64)
    return ts / np.linalg.norm(ts) * np.sign(ts[1, 0])


@pytest.mark.parametrize("freeze", [False, True], ids=["free", "frozen"])
def test_bundle_adjust_matches_jax(freeze):
    seed, rot_sd, t_sd = (9, 0.02, 0.03) if freeze else (3, 0.03, 0.05)
    pts, mask, K, Rs, ts, Rs_p, ts_p = _gauged_scene(seed, rot_sd=rot_sd,
                                                     t_sd=t_sd)
    want = jba.bundle_adjust(jnp.asarray(pts), jnp.asarray(mask),
                             jnp.asarray(K), jnp.asarray(Rs_p),
                             jnp.asarray(ts_p), num_cameras=4, max_iters=40,
                             freeze_focals=freeze)
    got = ba.bundle_adjust(_t(pts), _t(mask), _t(K), _t(Rs_p), _t(ts_p),
                           num_cameras=4, max_iters=40, freeze_focals=freeze)
    np.testing.assert_allclose(got.Rs.numpy(), np.asarray(want.Rs), atol=1e-3)
    # the translations' common scale (and sign) is BA's free gauge: both
    # solvers wander along it once the damping is small, so compare them
    # normalised
    np.testing.assert_allclose(_unit(got.ts.numpy()),
                               _unit(np.asarray(want.ts)), atol=1e-3)
    if freeze:
        np.testing.assert_array_equal(got.focals.numpy(), K[:, 0, 0])

    def mean_err(R, t, f):
        Ps = camera.projection_matrix(ba._apply_focals(_t(K), f), R, t)
        X, _ = triangulate.triangulate_points(_t(pts), Ps, _t(mask))
        e = triangulate.reprojection_errors(_t(pts), X, Ps, _t(mask))
        return float(torch.where(torch.isfinite(e), e, 0.0).mean())

    e_got = mean_err(got.Rs, got.ts, got.focals)
    e_want = mean_err(_t(np.asarray(want.Rs)), _t(np.asarray(want.ts)),
                      _t(np.asarray(want.focals)))
    assert abs(e_got - e_want) < 1e-3
    assert e_got < 0.35
    assert e_got < mean_err(_t(Rs_p), _t(ts_p), _t(K[:, 0, 0])) / 10


def _three_camera_scene():
    Rs, ts, rig = syn.ring_rig(num_cameras=3)
    rng = np.random.default_rng(4)
    X = syn.random_points(rng, 80)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=0.3, rng=rng)
    return Rs, ts, rig, pts, mask


def _rel_rot_err(Ra, Rb):
    """Largest difference between the relative rotations R_i R_0ᵀ."""
    rel = lambda R: np.einsum("cij,kj->cik", R, R[0])
    return np.abs(rel(np.asarray(Ra)) - rel(np.asarray(Rb))).max()


def test_bootstrap_and_calibrate_match_jax_on_its_draws():
    Rs, ts, rig, pts, mask = _three_camera_scene()
    K = rig.K_stack()
    key = jax.random.PRNGKey(2)
    tables = _jax_pair_tables(key, mask, 512)
    Rb_j, tb_j = jcalib.bootstrap_poses(key, jnp.asarray(pts),
                                        jnp.asarray(mask), jnp.asarray(K))
    Rb, tb = calibrator.bootstrap_poses(_t(pts), _t(mask), _t(K),
                                        index_tables=tables)
    assert _rel_rot_err(Rb.numpy(), Rb_j) < 1e-3
    np.testing.assert_allclose(tb.numpy(), np.asarray(tb_j), atol=1e-3)

    want = jcalib.calibrate(key, jnp.asarray(pts), jnp.asarray(mask),
                            jnp.asarray(K), ba_iters=40)
    progress = []
    got = calibrator.calibrate(_t(pts), _t(mask), _t(K), ba_iters=40,
                               index_tables=tables,
                               progress_cb=lambda R, t, n: progress.append(n))
    assert progress == [8, 16, 24, 32, 40]
    assert float(got.mean_error) < 0.5
    # the chunked solve converges to the same poses as JAX's one solve
    assert _rel_rot_err(got.Rs.numpy(), want.Rs) < 1e-3
    assert _rel_rot_err(got.Rs.numpy(), Rs) < 1e-2          # and the truth


def test_floor_origin_and_scale_match_jax():
    rng = np.random.default_rng(1)
    M0 = np.eye(4, dtype=np.float32)
    M0[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    n_true = np.array([0.2, -0.15, 1.0])
    n_true /= np.linalg.norm(n_true)
    basis = np.linalg.svd(n_true[None])[2][1:]
    cam = (rng.normal(size=(120, 2)) @ basis + [0.1, 0.2, 1.5]).astype(
        np.float32)
    collected = world.to_world(_t(cam), _t(M0))
    M1 = world.fit_floor(collected, _t(M0))
    M1j = jworld.fit_floor(jnp.asarray(collected.numpy()), jnp.asarray(M0))
    np.testing.assert_allclose(M1.numpy(), np.asarray(M1j), atol=1e-5)
    assert world.to_world(_t(cam), M1).numpy()[:, 1].std() < 1e-3
    # an already level cloud leaves the matrix as it is
    xy = rng.normal(size=(50, 2)).astype(np.float32)
    level = np.column_stack([xy[:, 0], np.full(50, 0.3, np.float32),
                             xy[:, 1]]).astype(np.float32)
    np.testing.assert_allclose(world.fit_floor(_t(level), _t(M0)).numpy(),
                               M0, atol=1e-4)

    p = world.to_world(_t(cam[0]), M1)
    M2 = world.set_origin(p, M1)
    np.testing.assert_allclose(M2.numpy(), np.asarray(jworld.set_origin(
        jnp.asarray(p.numpy()), jnp.asarray(M1.numpy()))), atol=1e-5)
    np.testing.assert_allclose(world.to_world(_t(cam[0]), M2).numpy(), 0.0,
                               atol=1e-5)

    base = rng.normal(size=(20, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True) * 0.075
    pairs = np.stack([base, base + d], axis=1)
    ts = rng.normal(size=(4, 3)).astype(np.float32)
    s, ts2 = world.determine_scale(_t(pairs), _t(ts))
    sj, ts2j = jworld.determine_scale(jnp.asarray(pairs), jnp.asarray(ts))
    np.testing.assert_allclose(float(s), float(sj), atol=1e-5)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(ts2j), atol=1e-5)
    np.testing.assert_allclose(float(s), 2.0, rtol=1e-4)
