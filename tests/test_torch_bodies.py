"""PyTorch port: rigid bodies against the JAX package — exact assignment,
templates, Horn's absolute orientation, 6-DoF body fits and their greedy
extraction, the body tracker (exact and greedy association, the offline
smoother), template learning, and the body stage of the tracking step
(two template sets, the packed row, batched against per-frame serving, the
legacy single-set state, the config round trip).

Discrete outputs (validity, matched markers, matched point indices,
assignment columns, track slots, seed triples) are exactly equal.  Floats
agree within: translations and positions 1e-5 m, rotation and quaternion
entries 1e-4, rms 1e-6 m.  The port sums its small contractions (einsum,
norms) in another order than XLA, jitted or not: the gaps measured on
these scenes are about 1e-7 (translations) and 1e-6 (rotations).  Inside
the port, batched serving equals per-frame serving bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_cost_mocap_tpu.config import RigConfig as JRigConfig
from low_cost_mocap_tpu.config import load_config as jload_config
from low_cost_mocap_tpu.config import save_config as jsave_config
from low_cost_mocap_tpu.models import pipeline as jpipe
from low_cost_mocap_tpu.ops import assignment as jassign
from low_cost_mocap_tpu.ops import body_tracker as jbt
from low_cost_mocap_tpu.ops import camera as jcam
from low_cost_mocap_tpu.ops import correspond as jcorr
from low_cost_mocap_tpu.ops import kalman as jkalman
from low_cost_mocap_tpu.ops import rigid_general as jrg
from low_cost_mocap_tpu_torch.config import (EngineConfig, RigConfig,
                                             load_config, save_config)
from low_cost_mocap_tpu_torch.models import pipeline
from low_cost_mocap_tpu_torch.ops import assignment, body_tracker, kalman
from low_cost_mocap_tpu_torch.ops import rigid_general as rg
from low_cost_mocap_tpu_torch.utils import synthetic as syn
from low_cost_mocap_tpu_torch.utils.convert import calibration_from_numpy

torch.set_num_threads(1)
T_TOL = dict(atol=1e-5, rtol=0)
R_TOL = dict(atol=1e-4, rtol=0)
RMS_TOL = dict(atol=1e-6, rtol=0)

# two distinct constellations (metres, body frame), as the JAX tests use
TMPL_A = ((0.0, 0.0, 0.0), (0.12, 0.0, 0.0), (0.0, 0.09, 0.0),
          (0.05, 0.04, 0.07))
TMPL_B = ((0.0, 0.0, 0.0), (0.2, 0.0, 0.0), (0.1, 0.16, 0.0),
          (0.02, 0.05, 0.11))
WAND5 = np.array([[0.0, 0.0, 0.0], [0.10, 0.0, 0.0], [0.25, 0.0, 0.0],
                  [0.10, 0.08, 0.0], [0.10, 0.0, 0.05]], np.float32)
SEEDED5 = np.array([[0.00, 0.00, 0.00], [0.30, 0.00, 0.00],
                    [0.10, 0.12, 0.02], [0.18, -0.10, 0.05],
                    [0.14, 0.02, 0.09]], np.float32)
# a square of dyadic side: both diagonals have bitwise equal lengths
SQUARE = np.array([[0.0, 0.0, 0.0], [0.125, 0.0, 0.0], [0.125, 0.125, 0.0],
                   [0.0, 0.125, 0.0]], np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _assert_fit(got, want):
    """A port BodyFit (torch) against a JAX BodyFit."""
    for name in ("valid", "matched", "point_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), **T_TOL)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), **R_TOL)
    np.testing.assert_allclose(got.rms.numpy(), np.asarray(want.rms),
                               **RMS_TOL)


# ----------------------------------------------------------- assignment


@pytest.mark.parametrize("n", range(1, 9))
def test_assign_matches_jax(n):
    rng = np.random.default_rng(n)
    cost = rng.random((n, n)).astype(np.float32)
    # the tracker's shape: a few real distances among large sentinels
    sentinel = np.where(rng.random((n, n)) < 0.4, np.float32(64.0), cost)
    for c in (cost, sentinel):
        jcol, jtot = jassign.assign(jnp.asarray(c))
        col, tot = assignment.assign(_t(c))
        np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
        np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-6)


def test_assign_ties_go_to_the_lowest_permutation_and_nine_raises():
    col, tot = assignment.assign(torch.zeros((4, 4)))
    assert col.tolist() == [0, 1, 2, 3] and float(tot) == 0.0
    with pytest.raises(ValueError, match="N <= 8"):
        assignment.assign(torch.zeros((9, 9)))


# ------------------------------------------------------------ templates


@pytest.mark.parametrize("markers", [
    TMPL_A, TMPL_B, "drone", WAND5, SQUARE, "collinear"])
def test_make_template_matches_jax(markers):
    if isinstance(markers, str) and markers == "drone":
        markers = syn.drone_markers(np.zeros(3), 0.0, RigConfig())
    elif isinstance(markers, str):
        markers = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
        for fn in (rg.make_template, jrg.make_template):
            with pytest.raises(ValueError, match="collinear"):
                fn(markers)
        return
    got, want = rg.make_template(markers), jrg.make_template(markers)
    assert got.seeds == want.seeds
    assert got.markers == want.markers


# ------------------------------------------------------------------ Horn


@pytest.mark.parametrize("thickness", [0.0, 1e-4, 1e-2])
def test_absolute_orientation_on_near_coplanar_sets(thickness):
    rng = np.random.default_rng(7)
    P = rng.normal(size=(6, 6, 3)).astype(np.float32) * 0.1
    P[..., 2] *= thickness
    R = np.stack([_rotation(rng) for _ in range(6)])
    t = rng.normal(size=(6, 3)).astype(np.float32)
    Q = np.einsum("bij,bmj->bmi", R, P) + t[:, None]
    w = rng.random((6, 6)).astype(np.float32) + 0.1
    jR, jt = jrg.weighted_absolute_orientation(jnp.asarray(P), jnp.asarray(Q),
                                               jnp.asarray(w))
    pR, pt = rg.weighted_absolute_orientation(_t(P), _t(Q), _t(w))
    np.testing.assert_allclose(pR.numpy(), np.asarray(jR), **R_TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), **T_TOL)
    np.testing.assert_allclose(pR.numpy(), R, atol=2e-3)


# -------------------------------------------------------------- fit_body


def _scatter(points, rng, n_total=16):
    """Body markers among uniform clutter (tests/test_rigid_general.py)."""
    clutter = rng.uniform(-1.0, 1.0, size=(n_total - len(points), 3)).astype(
        np.float32)
    lo = n_total // 3
    all_pts = np.concatenate([clutter[:lo], points, clutter[lo:]])
    return all_pts, np.ones(len(all_pts), bool)


def _rigid_general_scene(case):
    """The scenes of tests/test_rigid_general.py:83-120."""
    rng = np.random.default_rng({"noise": 2, "missing": 3, "clutter": 4}[
        case])
    if case == "clutter":
        return (rng.uniform(-1, 1, size=(16, 3)).astype(np.float32),
                np.ones(16, bool), WAND5, dict(min_markers=4))
    R = _rotation(rng)
    if case == "noise":
        t = np.array([0.3, -0.2, 1.1], np.float32)
        world = WAND5 @ R.T + t + rng.normal(scale=1e-3, size=WAND5.shape
                                             ).astype(np.float32)
    else:
        t = np.array([-0.5, 0.4, 0.8], np.float32)
        world = (WAND5 @ R.T + t).astype(np.float32)[[0, 1, 2, 4]]
    pts, valid = _scatter(world, rng)
    return pts, valid, WAND5, {}


def _seeded_scene(case):
    """The scenes of tests/test_seeded_fit.py:34-95."""
    tmpl = jrg.make_template(SEEDED5)
    markers = np.asarray(tmpl.markers, np.float32)
    eye = np.eye(3, dtype=np.float32)[None]
    if case == "anchors occluded":
        occluded = sorted({a for (a, b, c) in tmpl.seeds})
        t_true = np.array([0.2, -0.1, 0.3], np.float32)
        pts = np.zeros((8, 3), np.float32)
        valid = np.zeros((8,), bool)
        for s, m in enumerate(m for m in range(5) if m not in occluded):
            pts[s] = markers[m] + t_true
            valid[s] = True
        seeds = (eye, (t_true + 0.01)[None], np.ones((1,), bool))
    elif case.startswith("twins"):
        t_a = np.array([-0.4, 0.0, 0.1], np.float32)
        t_b = np.array([0.5, 0.2, -0.1], np.float32)
        pts = np.concatenate([markers + t_a, markers + t_b])
        valid = np.ones(len(pts), bool)
        target = t_a if case == "twins a" else t_b
        seeds = (eye, (target + 0.02)[None], np.ones((1,), bool))
    else:   # a prediction 0.5 m off loses to the true constellation
        t_true = np.array([0.1, 0.1, 0.1], np.float32)
        pts = markers + t_true
        valid = np.ones(len(pts), bool)
        seeds = (eye, (t_true + 0.5)[None], np.ones((1,), bool))
    return pts, valid, SEEDED5, seeds


@pytest.mark.parametrize("case", [
    "noise", "missing", "clutter", "anchors occluded", "twins a", "twins b",
    "far seed", "square"])
def test_fit_body_matches_jax(case):
    seeds = None
    if case in ("noise", "missing", "clutter"):
        pts, valid, markers, kw = _rigid_general_scene(case)
    elif case == "square":
        # two squares, one turned a quarter: every pair distance ties with
        # another, so the candidate pairs' order decides the hypotheses
        pts = np.concatenate([SQUARE + np.float32(0.5),
                              SQUARE[[1, 2, 3, 0]] - np.float32(0.25)])
        valid = np.ones(len(pts), bool)
        markers, kw = SQUARE, dict(pair_budget=4)
    else:
        pts, valid, markers, seeds = _seeded_scene(case)
        kw = {}
    jt, pt = jrg.make_template(markers), rg.make_template(markers)
    if seeds is not None:
        kw_j = dict(kw, seed_R=jnp.asarray(seeds[0]),
                    seed_t=jnp.asarray(seeds[1]),
                    seed_ok=jnp.asarray(seeds[2]))
        kw_p = dict(kw, seed_R=_t(seeds[0]), seed_t=_t(seeds[1]),
                    seed_ok=_t(seeds[2]))
    else:
        kw_j = kw_p = kw
    want = jrg.fit_body(jnp.asarray(pts), jnp.asarray(valid), jt, **kw_j)
    got = rg.fit_body(_t(pts), _t(valid), pt, **kw_p)
    _assert_fit(got, want)
    if case in ("anchors occluded", "clutter"):
        # without the seed (or in pure clutter) nothing fits
        assert bool(got.valid) == (case != "clutter")
    else:
        assert bool(got.valid)


def test_fit_body_batched_equals_frame_by_frame():
    """The leading batch axis (``learn_template``'s one call) gives each
    frame's own fit, bitwise."""
    rng = np.random.default_rng(11)
    scenes = [_rigid_general_scene(c)[:2] for c in ("noise", "missing")]
    pts = np.stack([s[0] for s in scenes])
    valid = np.stack([s[1] for s in scenes])
    valid[1, 3] = False
    tmpl = rg.make_template(WAND5)
    seed_R = np.stack([_rotation(rng)[None] for _ in range(2)])
    seed_t = rng.normal(size=(2, 1, 3)).astype(np.float32)
    seed_ok = np.array([[True], [False]])
    both = rg.fit_body(_t(pts), _t(valid), tmpl, seed_R=_t(seed_R),
                       seed_t=_t(seed_t), seed_ok=_t(seed_ok))
    for i in range(2):
        one = rg.fit_body(_t(pts[i]), _t(valid[i]), tmpl,
                          seed_R=_t(seed_R[i]), seed_t=_t(seed_t[i]),
                          seed_ok=_t(seed_ok[i]))
        for a, b in zip(both, one):
            assert torch.equal(a[i], b)


def test_locate_bodies_consumes_a_marker_at_the_last_slot():
    """Two instances; one marker's point is slot N-1, which an unmatched
    marker's index must not alias (the scatter's spare slot)."""
    rng = np.random.default_rng(5)
    R1, R2 = _rotation(rng), _rotation(rng)
    t1 = np.array([0.5, 0.0, 1.0], np.float32)
    t2 = np.array([-0.6, 0.3, 1.4], np.float32)
    w1 = (WAND5 @ R1.T + t1).astype(np.float32)
    w2 = (WAND5 @ R2.T + t2).astype(np.float32)[[0, 1, 3, 4, 2]]
    pts = np.concatenate([w1, rng.uniform(-1, 1, (4, 3)).astype(np.float32),
                          w2[:4], np.zeros((2, 3), np.float32), w2[4:]])
    valid = np.ones(len(pts), bool)
    valid[-3:-1] = False
    jt, pt = jrg.make_template(WAND5), rg.make_template(WAND5)
    want, jlive = jrg.locate_bodies(jnp.asarray(pts), jnp.asarray(valid), jt,
                                    max_instances=3, return_live=True)
    got, live = rg.locate_bodies(_t(pts), _t(valid), pt, max_instances=3,
                                 return_live=True)
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), **T_TOL)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), **R_TOL)
    np.testing.assert_allclose(got.rms.numpy(), np.asarray(want.rms),
                               **RMS_TOL)
    assert int(got.valid.sum()) == 2 and not bool(live[-1])


# ---------------------------------------------------------- body tracker


def _fit_sequence(T, F, seed):
    """Per-frame fits of two bodies that cross paths, with a dropout of
    body 0 (frames 20-24), a teleport of body 1 at frame 40 (beyond the
    gate), a low-quality fit and an empty fit slot."""
    rng = np.random.default_rng(seed)
    fit_t = np.zeros((T, F, 3), np.float32)
    fit_R = np.tile(np.eye(3, dtype=np.float32), (T, F, 1, 1))
    fit_rms = np.full((T, F), 0.001, np.float32)
    fit_valid = np.zeros((T, F), bool)
    for k in range(T):
        x = -0.3 + 0.01 * k
        a = np.array([x, 0.0, 0.5], np.float32)
        b = np.array([-x, 0.005, 0.5], np.float32)   # crosses a near k=30
        if k >= 40:
            b = b + np.array([0.0, 0.6, 0.0], np.float32)
        order = (0, 1) if k % 3 else (1, 0)           # fit slots shuffle
        for slot, (pos, ang) in zip(order, ((a, 0.02 * k), (b, -0.03 * k))):
            fit_t[k, slot] = pos + rng.normal(scale=5e-4, size=3)
            fit_R[k, slot] = _rot_z(ang)
            fit_valid[k, slot] = True
        if 20 <= k < 25:
            fit_valid[k, order[0]] = False
        if k == 33:
            fit_rms[k, order[1]] = 0.05                # fails rms_max
    return fit_t, fit_R, fit_rms, fit_valid


@pytest.mark.parametrize("I,F", [(2, 3), (3, 2), (9, 3)])
def test_tracker_update_matches_jax_over_60_frames(I, F):
    """Exact association (max(I, F) <= 8) and the greedy loop (I = 9)."""
    fit_t, fit_R, fit_rms, fit_valid = _fit_sequence(60, F, seed=I)
    jst, st = jbt.init_state(I), body_tracker.init_state(I, device="cpu")
    dt = np.float32(1 / 60)
    for k in range(60):
        jst, (jtr, jm) = jbt.update(
            jst, jnp.asarray(fit_t[k]), jnp.asarray(fit_R[k]),
            jnp.asarray(fit_rms[k]), jnp.asarray(fit_valid[k]), dt,
            return_meas=True)
        st, (tr, m) = body_tracker.update(
            st, _t(fit_t[k]), _t(fit_R[k]), _t(fit_rms[k]),
            _t(fit_valid[k]), dt, return_meas=True)
        np.testing.assert_array_equal(st.active.numpy(),
                                      np.asarray(jst.active))
        np.testing.assert_array_equal(st.missed.numpy(),
                                      np.asarray(jst.missed))
        np.testing.assert_array_equal(m[2].numpy(), np.asarray(jm[2]))
        np.testing.assert_allclose(st.pos.numpy(), np.asarray(jst.pos),
                                   **T_TOL)
        np.testing.assert_allclose(st.vel.numpy(), np.asarray(jst.vel),
                                   atol=1e-3)     # 1e-5 m over dt = 1/60
        np.testing.assert_allclose(st.quat.numpy(), np.asarray(jst.quat),
                                   **R_TOL)
        ok = m[2].numpy()
        np.testing.assert_allclose(m[0].numpy()[ok], np.asarray(jm[0])[ok],
                                   **T_TOL)
    assert int(st.active.sum()) >= 2


def test_smooth_body_sequence_matches_jax_on_the_gap_scene():
    """tests/test_body_smoother.py's scene: one body on an arc, turning,
    occluded for frames 55-64."""
    T, dt = 120, 1.0 / 60.0
    rng = np.random.default_rng(0)
    tt = np.arange(T) * dt
    pos = np.stack([0.4 * np.cos(0.9 * tt), 0.4 * np.sin(0.9 * tt),
                    0.6 + 0.03 * tt], axis=-1).astype(np.float32)
    Rt = np.stack([_rot_z(1.2 * x) for x in tt])
    meas = pos + rng.normal(scale=0.002, size=pos.shape).astype(np.float32)
    fit_t = np.zeros((T, 2, 3), np.float32)
    fit_R = np.tile(np.eye(3, dtype=np.float32), (T, 2, 1, 1))
    fit_rms = np.full((T, 2), 1.0, np.float32)
    fit_valid = np.zeros((T, 2), bool)
    fit_t[:, 0], fit_R[:, 0], fit_rms[:, 0] = meas, Rt, 0.001
    fit_valid[:, 0] = True
    fit_valid[55:65, 0] = False
    dts = np.full((T,), dt, np.float32)
    kw = dict(max_bodies=2, process_noise=1e-6, meas_noise=4e-6)
    want = jbt.smooth_body_sequence(*map(jnp.asarray, (fit_t, fit_R, fit_rms,
                                                       fit_valid, dts)), **kw)
    got = body_tracker.smooth_body_sequence(*map(_t, (fit_t, fit_R, fit_rms,
                                                      fit_valid, dts)), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               **T_TOL)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               atol=1e-3)
    np.testing.assert_allclose(got.quat.numpy(), np.asarray(want.quat),
                               **R_TOL)
    assert got.valid[55:65, 0].all()
    err = np.linalg.norm(got.pos.numpy()[55:65, 0] - pos[55:65], axis=-1)
    assert err.max() < 0.01


def test_learn_template_matches_jax():
    """One body moving and turning among clutter, one marker occluded now
    and then: the learned markers and seed triples equal JAX's."""
    rng = np.random.default_rng(3)
    T, N = 12, 10
    pts = np.zeros((T, N, 3), np.float32)
    vld = np.zeros((T, N), bool)
    for k in range(T):
        world = np.asarray(TMPL_B, np.float32) @ _rot_z(0.15 * k).T \
            + np.array([0.1 + 0.01 * k, 0.0, 0.8], np.float32)
        keep = [m for m in range(4) if not (k % 4 == 1 and m == 2)]
        pts[k, :len(keep)] = world[keep] + rng.normal(
            scale=3e-4, size=(len(keep), 3))
        vld[k, :len(keep)] = True
        pts[k, 8] = rng.uniform(-1, 1, 3)             # a ghost
        vld[k, 8] = True
    want = jrg.learn_template(pts, vld)
    got = rg.learn_template(pts, vld, device="cpu")
    assert got.seeds == want.seeds
    np.testing.assert_allclose(got.marker_array(), want.marker_array(),
                               **T_TOL)
    D = lambda m: np.sort(np.linalg.norm(m[:, None] - m[None], axis=-1),
                          axis=None)
    np.testing.assert_allclose(D(got.marker_array()),
                               D(np.asarray(TMPL_B, np.float32)), atol=2e-3)
    with pytest.raises(ValueError, match=">= 3 valid points"):
        rg.learn_template(pts[:, :2] * 0, vld[:, :2] & False, device="cpu")


# ------------------------------------------------------- the body stage


def _world_markers(tmpl, R, t):
    return np.asarray(tmpl, np.float32) @ np.asarray(R, np.float32).T + t


def _to_tri_frame(Xw):
    """Inverse of ops.world.to_world under an identity matrix: templates
    live in the display world frame ([x, up, z])."""
    Xs = np.asarray(Xw, np.float32)[:, [0, 2, 1]]
    return Xs @ np.diag([-1.0, -1.0, 1.0]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _rig_setup():
    Rs, ts, rig0 = syn.ring_rig(num_cameras=4)
    K, dist = rig0.K_stack(), rig0.dist_stack()
    Ps = np.asarray(jcam.projection_matrix(jnp.asarray(K), jnp.asarray(Rs),
                                           jnp.asarray(ts)))
    Fs = np.asarray(jcorr._pairwise_fundamentals(jnp.asarray(Ps)))
    M = np.eye(4, dtype=np.float32)
    calib = calibration_from_numpy(K, dist, Ps, Fs, M, device="cpu")
    cal = (calib.Ps, calib.K, calib.dist, calib.to_world, calib.Fs)
    jcal = tuple(jnp.asarray(a) for a in (Ps, K, dist, M, Fs))
    tail = dict(gate_px=5.0, max_candidates=2,
                marker_dist1=rig0.marker_dist_short,
                marker_dist2=rig0.marker_dist_long,
                marker_tol=rig0.marker_dist_tol,
                marker_side_min=rig0.marker_side_min)
    return Rs, ts, rig0, cal, jcal, tail


def _body_blobs(n, K=16, drop=()):
    """Blob slots of the two-template scene (tests/test_multi_template.py
    :56-119), moving a little every frame; ``drop``: frames where A's
    markers vanish."""
    Rs, ts, rig0 = _rig_setup()[:3]
    t_a = np.array([-0.25, 0.1, 0.05], np.float32)
    t_b = np.array([0.3, -0.1, 0.12], np.float32)
    blobs = np.zeros((n, 4, K, 2), np.float32)
    ok = np.zeros((n, 4, K), bool)
    for i in range(n):
        parts = [_world_markers(TMPL_B, _rot_z(-0.7 - 0.02 * i),
                                t_b - 0.002 * i)]
        if i not in drop:
            parts.insert(0, _world_markers(TMPL_A, _rot_z(0.4 + 0.03 * i),
                                           t_a + 0.002 * i))
        pts, mask = syn.observe(_to_tri_frame(np.concatenate(parts)), Rs, ts,
                                rig0)
        for c in range(4):
            vis = np.where(mask[:, c])[0]
            blobs[i, c, :len(vis)] = pts[vis, c]
            ok[i, c, :len(vis)] = True
    return blobs, ok


def _two_set_rigs():
    rig0 = _rig_setup()[2]
    rig = dataclasses.replace(rig0, body_markers=TMPL_A, max_bodies=1,
                              body_sets=((TMPL_B, 1),))
    jrig = JRigConfig(num_cameras=4, body_markers=TMPL_A, max_bodies=1,
                      body_sets=((TMPL_B, 1),))
    return rig, jrig


def _assert_body_rows(got, want, I):
    for g, w in zip(pipeline.unpack_outputs_batch(got, 4, 16, 2,
                                                  num_bodies=I),
                    pipeline.unpack_outputs_batch(want, 4, 16, 2,
                                                  num_bodies=I)):
        np.testing.assert_array_equal(g.point_valid, w.point_valid)
        np.testing.assert_array_equal(g.bodies.valid, w.bodies.valid)
        np.testing.assert_array_equal(g.tracked_bodies.valid,
                                      w.tracked_bodies.valid)
        np.testing.assert_allclose(g.object_points, w.object_points,
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.bodies.t, w.bodies.t, **T_TOL)
        np.testing.assert_allclose(g.bodies.R, w.bodies.R, **R_TOL)
        np.testing.assert_allclose(g.tracked_bodies.pos,
                                   w.tracked_bodies.pos, **T_TOL)
        np.testing.assert_allclose(g.tracked_bodies.quat,
                                   w.tracked_bodies.quat, **R_TOL)


def test_track_from_blobs_with_two_sets_matches_jax():
    """Both templates in one scene for a few frames, A missing in one: the
    port's packed rows against JAX's ``track_from_blobs`` rows."""
    _, _, _, cal, jcal, tail = _rig_setup()
    rig, jrig = _two_set_rigs()
    blobs, ok = _body_blobs(5, drop=(3,))
    jstep = jax.jit(lambda st, b, v: (lambda r: (r[0], jpipe.pack_outputs(
        r[1])))(jpipe.track_from_blobs(
            st, b, v, np.float32(1 / 60), *jcal, with_obs=True,
            body_sets=jrig.body_sets_resolved(), **tail)))
    jst = jpipe.make_init_state(jrig)
    st = pipeline.make_init_state(rig, device="cpu")
    got, want = [], []
    for i in range(len(blobs)):
        jst, row = jstep(jst, jnp.asarray(blobs[i]), jnp.asarray(ok[i]))
        want.append(np.asarray(row))
        st, out = pipeline.track_from_blobs(
            st, _t(blobs[i]), _t(ok[i]), np.float32(1 / 60), *cal,
            with_obs=True, body_sets=rig.body_sets_resolved(), **tail)
        got.append(pipeline.pack_outputs(out).numpy())
    got, want = np.stack(got), np.stack(want)
    I = rig.total_body_slots()
    assert got.shape == want.shape == (
        5, pipeline.row_length(4, 16, 2, True, I))
    assert got.shape[1] == pipeline.row_length(4, 16, 2, True) + 25 * I
    _assert_body_rows(got, want, I)
    last = pipeline.unpack_outputs(got[-1], 4, 16, 2, True, I)
    assert last.bodies.valid.all() and last.tracked_bodies.valid.all()
    np.testing.assert_allclose(last.bodies.t[0], [-0.25 + 0.008, 0.1 + 0.008,
                                                  0.05 + 0.008], atol=5e-3)


def test_batched_body_rows_equal_per_frame_rows_bitwise():
    """scan_track_from_blobs with two sets (geometry and the bank batched,
    the body stage frame by frame) against per-frame track_from_blobs."""
    _, _, _, cal, _, tail = _rig_setup()
    rig, _ = _two_set_rigs()
    blobs, ok = _body_blobs(6, drop=(2,))
    dts = torch.full((6,), 1 / 60)
    kw = dict(tail, with_obs=True, body_sets=rig.body_sets_resolved())
    st_b, rows = pipeline.scan_track_from_blobs(
        pipeline.make_init_state(rig, device="cpu"), _t(blobs), _t(ok), dts,
        *cal, **kw)
    st, per = pipeline.make_init_state(rig, device="cpu"), []
    for i in range(6):
        st, out = pipeline.track_from_blobs(st, _t(blobs[i]), _t(ok[i]),
                                            dts[i], *cal, **kw)
        per.append(pipeline.pack_outputs(out))
    assert torch.equal(rows, torch.stack(per))
    for a, b in zip(st_b[1], st[1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_packed_row_layout_equals_jax():
    """The same FrameOutputs leaves packed by both packages, and the
    port's decode of JAX's row."""
    rng = np.random.default_rng(4)
    C, K, O, I = 2, 3, 2, 3
    N = C * K

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def b(*shape):
        return rng.random(shape) < 0.5

    leaves = dict(blob_px=r(C, K, 2), blob_valid=b(C, K),
                  object_points=r(N, 3), point_errors=r(N),
                  point_valid=b(N), point_obs=r(N, C, 2),
                  point_obs_mask=b(N, C))
    objects = (r(N, 3), r(N), r(N), rng.integers(0, O, N).astype(np.int32),
               b(N))
    tracked = (r(O, 3), r(O, 3), r(O), b(O))
    bodies = (r(I, 3, 3), r(I, 3), r(I), b(I))
    tbodies = (r(I, 3), r(I, 3), r(I, 4), b(I))
    want = np.asarray(jpipe.pack_outputs(jpipe.FrameOutputs(
        **{k: jnp.asarray(v) for k, v in leaves.items()},
        objects=jpipe.rigid.LocatedObjects(*map(jnp.asarray, objects)),
        tracked=jkalman.TrackedObjects(*map(jnp.asarray, tracked)),
        bodies=jrg.LocatedBodies(*map(jnp.asarray, bodies)),
        tracked_bodies=jbt.TrackedBodies(*map(jnp.asarray, tbodies)))))
    got = pipeline.pack_outputs(pipeline.FrameOutputs(
        **{k: _t(v) for k, v in leaves.items()},
        objects=pipeline.rigid.LocatedObjects(*map(_t, objects)),
        tracked=kalman.TrackedObjects(*map(_t, tracked)),
        bodies=rg.LocatedBodies(*map(_t, bodies)),
        tracked_bodies=body_tracker.TrackedBodies(*map(_t, tbodies)))).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(got) == pipeline.row_length(C, K, O, True, I)
    dec = pipeline.unpack_outputs(want, C, K, O, True, I)
    jdec = jpipe.unpack_outputs(want, C, K, O, num_bodies=I, with_obs=True)
    for a, b_ in zip((*dec.bodies, *dec.tracked_bodies),
                     (*jdec.bodies, *jdec.tracked_bodies)):
        np.testing.assert_array_equal(a, b_)


def test_legacy_single_set_state_round_trips():
    """A bare BodyTrackState comes back bare (single-set shorthand), and
    its fits equal the sets path's."""
    _, _, _, cal, _, tail = _rig_setup()
    rig0 = _rig_setup()[2]
    rig = dataclasses.replace(rig0, body_markers=TMPL_A, max_bodies=1)
    blobs, ok = _body_blobs(1)
    legacy = (kalman.init_state(2, device="cpu"),
              body_tracker.init_state(1, device="cpu"))
    args = (_t(blobs[0]), _t(ok[0]), np.float32(1 / 60), *cal)
    new, o1 = pipeline.track_from_blobs(legacy, *args,
                                        body_template=rig.body_template(),
                                        max_bodies=1, **tail)
    assert isinstance(new[1], body_tracker.BodyTrackState)
    new2, o2 = pipeline.track_from_blobs(
        pipeline.make_init_state(rig, device="cpu"), *args,
        body_sets=rig.body_sets_resolved(), **tail)
    assert isinstance(new2[1], tuple) and len(new2[1]) == 1
    for a, b in zip((*o1.bodies, *o1.tracked_bodies),
                    (*o2.bodies, *o2.tracked_bodies)):
        assert torch.equal(a, b)
    assert bool(o1.bodies.valid[0])


def test_config_round_trip_with_body_sets(tmp_path):
    rig = RigConfig(num_cameras=2, body_markers=TMPL_A, max_bodies=1,
                    body_sets=((TMPL_B, 2),))
    save_config(str(tmp_path / "c.json"), rig, EngineConfig(max_blobs=16))
    rig2, cfg2 = load_config(str(tmp_path / "c.json"))
    assert rig2 == rig and cfg2.max_blobs == 16
    sets = rig2.body_sets_resolved()
    assert [mi for _, mi in sets] == [1, 2] and rig2.total_body_slots() == 3
    want = JRigConfig(num_cameras=2, body_markers=TMPL_A, max_bodies=1,
                      body_sets=((TMPL_B, 2),)).body_sets_resolved()
    assert [(t.markers, t.seeds, mi) for t, mi in sets] == \
        [(t.markers, t.seeds, mi) for t, mi in want]
    # a file the JAX package wrote loads into the same port config
    from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
    jsave_config(str(tmp_path / "j.json"), JRigConfig(
        num_cameras=2, body_markers=TMPL_A, max_bodies=1,
        body_sets=((TMPL_B, 2),)), JEngineConfig(max_blobs=16))
    assert load_config(str(tmp_path / "j.json"))[0] == rig
    assert jload_config(str(tmp_path / "c.json"))[0].body_sets == \
        rig.body_sets
