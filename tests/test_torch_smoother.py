"""PyTorch port: the offline Kalman options and the RTS smoothers against
the JAX package (``ops/kalman.py``): ``update(advance_on_miss,
return_cov)``, ``track_sequence``, ``rts_smooth``, ``rts_smooth_assoc``
and ``smooth_sequence``, on the scenes of ``tests/test_smoother.py``.

Validity is exactly equal.  The forward chain is the JAX function run op
by op (not jitted), so its floats agree within 1e-5; the smoothers add a
9x9 solve per step (JAX's a LAPACK inverse, the port's written-out LU
solves for ``rts_smooth`` and a LAPACK inverse for ``rts_smooth_assoc``,
summed in another order), so smoothed states agree within 1e-5 and
covariances within 1e-4 absolute.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from low_cost_mocap_tpu.ops import kalman as jk
from low_cost_mocap_tpu_torch.ops import kalman
from test_torch_kalman_forward import forward_case   # tests/ is on the path

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _sim(T=48, dt=1.0 / 60.0, seed=0, noise=0.004):
    rng = np.random.default_rng(seed)
    t = np.arange(T) * dt
    pos = np.stack([0.4 * np.sin(1.8 * t), 0.3 * np.cos(1.3 * t),
                    0.7 + 0.05 * t], axis=-1).astype(np.float32)
    meas = pos + rng.normal(scale=noise, size=pos.shape).astype(np.float32)
    return pos, meas, dt


def _cands(meas, valid):
    T = len(meas)
    return (meas[:, None, :], np.zeros((T, 1), np.float32),
            np.zeros((T, 1), np.int32), valid[:, None])


@pytest.fixture(scope="module")
def forward():
    """The JAX forward pass (advance_on_miss, return_cov) over a track
    with an 8-frame gap, step by step, and the port's."""
    pos, meas, dt = _sim(T=32, seed=6)
    valid = np.ones(len(meas), bool)
    valid[12:20] = False
    cp, ch, ci, cv = _cands(meas, valid)
    kw = dict(report="post", advance_on_miss=True, return_cov=True)
    with jax.disable_jit():
        st = jk.init_state(1)
        jx = []
        for t in range(len(meas)):
            st, (out, x, P) = jk.update(
                st, jnp.asarray(cp[t]), jnp.asarray(ch[t]),
                jnp.asarray(ci[t]), jnp.asarray(cv[t]), jnp.float32(dt), **kw)
            jx.append((np.asarray(out.pos), np.asarray(out.valid),
                       np.asarray(x), np.asarray(P)))
    dts = np.full(len(meas), dt, np.float32)
    st_t, (tr, xs, Ps) = kalman.track_sequence(
        kalman.init_state(1, device="cpu"), torch.tensor(cp), torch.tensor(ch),
        torch.tensor(ci), torch.tensor(cv), torch.tensor(dts), **kw)
    return jx, (tr, xs, Ps), dts, pos


def test_update_advance_on_miss_and_return_cov_match_jax(forward):
    jx, (tr, xs, Ps), _, _ = forward
    for t, (jpos, jvalid, jxx, jP) in enumerate(jx):
        np.testing.assert_array_equal(tr.valid[t].numpy(), jvalid)
        np.testing.assert_allclose(tr.pos[t].numpy(), jpos, **TOL)
        np.testing.assert_allclose(xs[t].numpy(), jxx, **TOL)
        np.testing.assert_allclose(Ps[t].numpy(), jP, **TOL)
    # through the gap the committed covariance grows (advance_on_miss)
    assert float(Ps[19, 0, 0, 0]) > float(Ps[11, 0, 0, 0])
    # without advance_on_miss a miss freezes the state, as in JAX
    st = kalman.init_state(1, device="cpu")
    st, _ = kalman.update(st, torch.zeros(1, 3), torch.zeros(1),
                          torch.zeros(1, dtype=torch.int32),
                          torch.ones(1, dtype=torch.bool), 1 / 60)
    frozen, _ = kalman.update(st, torch.zeros(1, 3), torch.zeros(1),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.bool), 1 / 60)
    assert torch.equal(frozen.P, st.P)


@pytest.mark.parametrize("fn", ["rts_smooth", "rts_smooth_assoc"])
def test_smoothers_match_jax(forward, fn):
    jx, (_, xs, Ps), dts, _ = forward
    jxs = jnp.asarray(np.stack([j[2] for j in jx]))
    jPs = jnp.asarray(np.stack([j[3] for j in jx]))
    jx_s, jP_s = getattr(jk, fn)(jxs, jPs, jnp.asarray(dts))
    x_s, P_s = getattr(kalman, fn)(xs, Ps, torch.tensor(dts))
    np.testing.assert_allclose(x_s.numpy(), np.asarray(jx_s), **TOL)
    np.testing.assert_allclose(P_s.numpy(), np.asarray(jP_s), atol=1e-4)
    # the last frame is the filtered one
    np.testing.assert_array_equal(x_s[-1].numpy(), xs[-1].numpy())


def test_rts_smooth_matches_jax_on_a_long_recording():
    """The port's backward pass (the gains by LU solves, the sweep's sums
    written out in index order) against JAX's einsums and inverse over
    1,500 frames of ``forward_case`` (three objects, gaps past
    ``gap_reset_s``, one 0.7 s interval), filtered by the port's forward
    filter, with the smoothers' tolerances."""
    case = [torch.from_numpy(a) for a in forward_case(3, 1500, 32, 3)]
    _, ((_, xs, Ps), _) = kalman.forward_filter(
        kalman.init_state(3, device="cpu"), *case)
    x_s, P_s = kalman.rts_smooth(xs, Ps, case[4])
    jx_s, jP_s = jk.rts_smooth(jnp.asarray(xs.numpy()),
                               jnp.asarray(Ps.numpy()),
                               jnp.asarray(case[4].numpy()))
    np.testing.assert_allclose(x_s.numpy(), np.asarray(jx_s), **TOL)
    np.testing.assert_allclose(P_s.numpy(), np.asarray(jP_s), atol=1e-4)


def test_rts_assoc_matches_sequential(forward):
    """The log-depth smoother equals the backward loop to float precision
    (the JAX test's tolerance), on the gap track and on a length that is
    not a power of two."""
    _, (_, xs, Ps), dts, _ = forward
    for T in (32, 23, 2):
        a_x, a_P = kalman.rts_smooth(xs[:T], Ps[:T], torch.tensor(dts[:T]))
        b_x, b_P = kalman.rts_smooth_assoc(xs[:T], Ps[:T],
                                           torch.tensor(dts[:T]))
        np.testing.assert_allclose(a_x.numpy(), b_x.numpy(), atol=1e-5)
        np.testing.assert_allclose(a_P.numpy(), b_P.numpy(), atol=1e-5)


def test_smooth_sequence_matches_jax_and_interpolates_gaps():
    pos, meas, dt = _sim(T=60, seed=5)
    T = len(meas)
    valid = np.ones(T, bool)
    valid[30:40] = False                         # occlusion gap
    cp, ch, ci, cv = _cands(meas, valid)
    dts = np.full(T, dt, np.float32)
    js, jxs = jk.smooth_sequence(jk.init_state(1), jnp.asarray(cp),
                                 jnp.asarray(ch), jnp.asarray(ci),
                                 jnp.asarray(cv), jnp.asarray(dts))
    ts, txs = kalman.smooth_sequence(
        kalman.init_state(1, device="cpu"), torch.tensor(cp),
        torch.tensor(ch), torch.tensor(ci), torch.tensor(cv),
        torch.tensor(dts))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    # the jitted JAX forward chain fuses multiply-adds (ROADMAP.md §3)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), atol=1e-4)
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), atol=1e-4)
    assert bool(ts.valid[30:40].all())
    gap = np.linalg.norm(ts.pos[30:40, 0].numpy() - pos[30:40], axis=1)
    assert (gap > 0).all() and gap.mean() < 0.01
