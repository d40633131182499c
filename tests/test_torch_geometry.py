"""PyTorch port: camera, epipolar, triangulation, correspondence, world and
rigid-body ops against the JAX package on the synthetic 4-camera rig.

Index, validity and slot outputs are exactly equal.  Floats agree within
atol 1e-5 and rtol 1e-5: both packages contract their small einsums and
matrix products in float32 but sum in different orders.  The
correspondence tests feed both packages the JAX package's own fundamental
matrices (``utils/convert.py``), as a calibrated engine would.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from low_cost_mocap_tpu.ops import camera as jcam
from low_cost_mocap_tpu.ops import correspond as jcorr
from low_cost_mocap_tpu.ops import epipolar as jepi
from low_cost_mocap_tpu.ops import rigid as jrigid
from low_cost_mocap_tpu.ops import triangulate as jtri
from low_cost_mocap_tpu.ops import world as jworld
from low_cost_mocap_tpu.utils import synthetic as jsyn
from low_cost_mocap_tpu_torch.ops import camera, correspond, epipolar, rigid
from low_cost_mocap_tpu_torch.ops import triangulate, world
from low_cost_mocap_tpu_torch.utils import synthetic as syn
from low_cost_mocap_tpu_torch.utils.convert import calibration_from_numpy

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rig():
    Rs, ts, rig = jsyn.ring_rig(num_cameras=4)
    K = rig.K_stack()
    Ps = np.asarray(jcam.projection_matrix(jnp.asarray(K), jnp.asarray(Rs),
                                           jnp.asarray(ts)))
    Fs = np.asarray(jcorr._pairwise_fundamentals(jnp.asarray(Ps)))
    return Rs, ts, rig, K, Ps, Fs


def test_synthetic_rig_matches_jax():
    Rs, ts, rig = jsyn.ring_rig(num_cameras=4)
    Rs2, ts2, rig2 = syn.ring_rig(num_cameras=4)
    np.testing.assert_array_equal(Rs, Rs2)
    np.testing.assert_array_equal(ts, ts2)
    np.testing.assert_array_equal(rig.K_stack(), rig2.K_stack())
    X = jsyn.random_points(np.random.default_rng(0), 6)
    np.testing.assert_array_equal(
        X, syn.random_points(np.random.default_rng(0), 6))
    p1, m1 = jsyn.observe(X, Rs, ts, rig)
    p2, m2 = syn.observe(X, Rs, ts, rig2)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(jsyn.render_frames(p1, m1, 64),
                                  syn.render_frames(p2, m2, 64))
    np.testing.assert_array_equal(jsyn.drone_markers([0.1, 0, 0.5], 0.3, rig),
                                  syn.drone_markers([0.1, 0, 0.5], 0.3, rig2))


def test_camera_ops_match_jax():
    Rs, ts, rig, K, Ps, _ = _rig()
    rng = np.random.default_rng(1)
    dist = np.tile(np.array([0.12, -0.05, 1e-3, -2e-3, 0.01], np.float32),
                   (4, 1))
    px = rng.uniform(0, 320, (4, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(
        camera.undistort_points(_t(px), _t(K)[:, None], _t(dist)[:, None]),
        jcam.undistort_points(jnp.asarray(px), jnp.asarray(K)[:, None],
                              jnp.asarray(dist)[:, None]), **TOL)
    X = jsyn.random_points(rng, 5)
    np.testing.assert_allclose(
        camera.project_points(_t(X)[None], _t(Rs), _t(ts), _t(K), _t(dist)),
        jcam.project_points(jnp.asarray(X)[None], jnp.asarray(Rs),
                            jnp.asarray(ts), jnp.asarray(K),
                            jnp.asarray(dist)), **TOL)
    np.testing.assert_allclose(
        camera.projection_matrix(_t(K), _t(Rs), _t(ts)), Ps, **TOL)


def test_fundamentals_match_jax():
    """F is defined up to scale and its entries run to ~1e7 px^2, so each
    cross-camera F is compared after dividing by its Frobenius norm; the
    same-camera blocks are rounding noise of a zero determinant, which the
    matcher masks, and are not compared."""
    _, _, _, _, Ps, Fs = _rig()
    F = correspond._pairwise_fundamentals(_t(Ps)).numpy()
    F1 = epipolar.fundamental_from_projections(_t(Ps[0]), _t(Ps[1])).numpy()
    np.testing.assert_allclose(
        F1, np.asarray(jepi.fundamental_from_projections(
            jnp.asarray(Ps[0]), jnp.asarray(Ps[1]))), rtol=1e-5,
        atol=1e-5 * np.abs(F1).max())
    for a in range(4):
        for b in range(4):
            if a != b:
                n = np.linalg.norm(Fs[a, b])
                np.testing.assert_allclose(F[a, b] / n, Fs[a, b] / n, **TOL)


def test_triangulation_matches_jax():
    Rs, ts, rig, K, Ps, _ = _rig()
    rng = np.random.default_rng(2)
    X = jsyn.random_points(rng, 16)
    pts, mask = jsyn.observe(X, Rs, ts, rig, noise_px=0.3, rng=rng)
    mask[3, 1:] = False            # one single-view point: invalid
    mask[4, 2] = False
    Xj, vj = jtri.triangulate_points(jnp.asarray(pts), jnp.asarray(Ps),
                                     jnp.asarray(mask))
    Xt, vt = triangulate.triangulate_points(_t(pts), _t(Ps), _t(mask))
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), **TOL)
    ej = jtri.reprojection_errors(jnp.asarray(pts), Xj, jnp.asarray(Ps),
                                  jnp.asarray(mask))
    et = triangulate.reprojection_errors(_t(pts), Xt, _t(Ps), _t(mask))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **TOL)
    B = jtri._dlt_system(jnp.asarray(pts), jnp.asarray(Ps)[None],
                         jnp.asarray(mask))
    v = triangulate.smallest_eigvec_sym4(_t(np.asarray(B)))
    np.testing.assert_allclose(
        np.abs(v.numpy()), np.abs(np.asarray(jtri.smallest_eigvec_sym4(B))),
        **TOL)


def _scene(seed, n_drones=2, dup=False):
    Rs, ts, rig, K, Ps, Fs = _rig()
    rng = np.random.default_rng(seed)
    markers = np.concatenate([
        jsyn.drone_markers(rng.uniform(-0.4, 0.4, 3) * [1, 1, 0]
                           + [0, 0, 0.6], rng.uniform(-0.3, 0.3), rig)
        for _ in range(n_drones)])
    pts, mask = jsyn.observe(markers, Rs, ts, rig, noise_px=0.2, rng=rng)
    C, Kb = 4, 8
    blobs = np.zeros((C, Kb, 2), np.float32)
    valid = np.zeros((C, Kb), bool)
    for c in range(C):
        order = rng.permutation(len(markers))
        vis = [i for i in order if mask[i, c]]
        blobs[c, :len(vis)] = pts[vis, c]
        valid[c, :len(vis)] = True
    if dup:
        # a detection duplicated in the next slot: equal epipolar
        # distances, so the candidate ranking meets finite ties
        for c in range(1, C):
            n = int(valid[c].sum())
            blobs[c, n] = blobs[c, 0]
            valid[c, n] = True
    return blobs, valid, Ps, Fs


@pytest.mark.parametrize("seed,dup", [(0, False), (1, False), (2, True),
                                      (3, True)])
def test_match_points_exact_mode_matches_jax(seed, dup):
    blobs, valid, Ps, Fs = _scene(seed, dup=dup)
    want = jcorr.match_points(jnp.asarray(blobs), jnp.asarray(valid),
                              jnp.asarray(Ps), Fs=jnp.asarray(Fs))
    got = correspond.match_points(_t(blobs), _t(valid), _t(Ps), Fs=_t(Fs))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    assert got["valid"].sum() >= 3
    np.testing.assert_allclose(got["object_points"].numpy(),
                               np.asarray(want["object_points"]), **TOL)
    np.testing.assert_allclose(got["errors"].numpy(),
                               np.asarray(want["errors"]), **TOL)


def test_candidate_ranking_keeps_lowest_index_among_ties():
    blobs, valid, Ps, Fs = _scene(2, dup=True)
    d, gated = correspond._epipolar_distances(_t(blobs)[None], _t(valid)[None],
                                              5.0, _t(Fs))
    d_masked = torch.where(gated, d, float("inf"))[0]
    _, order = torch.sort(d_masked, dim=-1, stable=True)
    import jax
    _, idx = jax.lax.top_k(-jnp.asarray(d_masked.numpy()), 2)
    np.testing.assert_array_equal(order[..., :2].numpy(), np.asarray(idx))
    # the scene really has finite ties: two slots at one distance
    same = d_masked[..., :, None] == d_masked[..., None, :]
    off_diag = ~torch.eye(8, dtype=torch.bool)
    assert (same & off_diag & torch.isfinite(d_masked)[..., None]).any()


def test_match_points_rejects_unported_modes():
    """Every JAX mode is ported (assoc and beam are held to JAX in
    tests/test_torch_correspond_modes.py); a mode JAX does not name is
    refused."""
    blobs, valid, Ps, Fs = _scene(0)
    exact = correspond.match_points(_t(blobs), _t(valid), _t(Ps),
                                    mode="exact", Fs=_t(Fs))
    for mode in ("assoc", "beam"):
        got = correspond.match_points(_t(blobs), _t(valid), _t(Ps),
                                      mode=mode, Fs=_t(Fs))
        assert int(got["valid"].sum()) == int(exact["valid"].sum()) > 0
    with pytest.raises(ValueError, match="mode"):
        correspond.match_points(_t(blobs), _t(valid), _t(Ps), mode="fast")


def test_world_and_rigid_match_jax():
    blobs, valid, Ps, Fs = _scene(4)
    m = jcorr.match_points(jnp.asarray(blobs), jnp.asarray(valid),
                           jnp.asarray(Ps), Fs=jnp.asarray(Fs))
    M = np.eye(4, dtype=np.float32)
    M[:3, 3] = (0.1, -0.2, 0.05)
    M[:3, :3] = jsyn.look_at([1.0, 0.2, 0.3], [0, 0, 0])[0]
    calib = calibration_from_numpy(np.eye(3)[None], np.zeros((1, 5)), Ps, Fs,
                                   M, device="cpu")
    pts_j = jworld.to_world(m["object_points"], jnp.asarray(M))
    pts_t = world.to_world(_t(np.asarray(m["object_points"])), calib.to_world)
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), **TOL)

    pts = np.asarray(jworld.to_world(m["object_points"], jnp.eye(4)))
    errs, ok = np.asarray(m["errors"]), np.asarray(m["valid"])
    # a distractor point near one marker, and an invalid slot
    pts = pts.copy()
    pts[-1] = pts[np.argmax(ok)] + [0.09, 0.0, 0.02]
    ok = ok.copy()
    ok[-1] = True
    errs = errs.copy()
    errs[-1] = 0.5
    want = jrigid.locate_objects(jnp.asarray(pts), jnp.asarray(errs),
                                 jnp.asarray(ok), side_min=0.02, ax_h1=0,
                                 ax_h2=2)
    got = rigid.locate_objects(_t(pts)[None], _t(errs)[None], _t(ok)[None],
                               side_min=0.02, ax_h1=0, ax_h2=2)
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.index[0].numpy(), np.asarray(want.index))
    assert got.valid.sum() == 2
    for name in ("pos", "heading", "error"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)), **TOL)


@pytest.mark.parametrize("seed,dup", [(0, False), (2, True), (3, True)])
def test_match_points_observations_match_jax(seed, dup):
    """``with_obs``: the winners' per-camera observations, also on scenes
    with duplicated blobs (finite ties, ghost roots): the mask exactly
    equal, the pixels within 1e-5; a batch of two frames gives each
    frame's own."""
    blobs, valid, Ps, Fs = _scene(seed, dup=dup)
    want = jcorr.match_points(jnp.asarray(blobs), jnp.asarray(valid),
                              jnp.asarray(Ps), Fs=jnp.asarray(Fs),
                              with_obs=True)
    got = correspond.match_points(_t(blobs), _t(valid), _t(Ps), Fs=_t(Fs),
                                  with_obs=True)
    np.testing.assert_array_equal(got["obs_mask"].numpy(),
                                  np.asarray(want["obs_mask"]))
    np.testing.assert_allclose(got["obs"].numpy(), np.asarray(want["obs"]),
                               **TOL)
    assert got["obs_mask"].shape == (32, 4) and got["obs"].shape == (32, 4, 2)
    assert (got["obs_mask"].sum(-1)[got["valid"]] >= 2).all()
    assert not got["obs_mask"][~got["valid"]].any()
    b2, v2, _, _ = _scene(seed + 10, dup=dup)
    both = correspond.match_points(_t(np.stack([blobs, b2])),
                                   _t(np.stack([valid, v2])), _t(Ps),
                                   Fs=_t(Fs), with_obs=True)
    for key in ("obs", "obs_mask", "valid"):
        assert torch.equal(both[key][0], got[key])
