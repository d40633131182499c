"""PyTorch port: the Kalman bank against the JAX package.

The port's plain bank (``kalman.update`` chained — the plain version of the
``kalman_bank`` CUDA kernel) runs the random case of
``tests/test_tracking.py::test_pallas_kalman_scan_matches_xla_chain``
(dropouts, association ties, a gap re-seed) beside the JAX ``kalman.update``
chain and the Pallas ``kalman_scan`` in interpret mode.  Validity flags
are exactly equal.  Against JAX run op by op (``jax.disable_jit``) every
float is bitwise equal: the same float32 operations in the same order.
Against the jitted JAX chain floats agree within atol 5e-5 and rtol 1e-5:
XLA's CPU compiler fuses the multiply-adds of the Butterworth recurrence,
and these random candidates jump ~0.5 m per 1/60 s frame, so the filtered
velocities reach tens of m/s and a filter output near zero carries the
rounding of those large terms (1.3e-5 seen with ``report="post"``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from low_cost_mocap_tpu.ops import kalman as jkalman
from low_cost_mocap_tpu.ops.kalman_pallas import kalman_scan as jkalman_scan
from low_cost_mocap_tpu_torch.ops import kalman, kalman_cuda, native
from low_cost_mocap_tpu_torch.utils.convert import kalman_state_from_numpy

torch.set_num_threads(1)


def _case(seed=3, B=14, M=8, O=2, ties=False):
    rng = np.random.default_rng(seed)
    cand_pos = rng.normal(0, 0.4, (B, M, 3)).astype(np.float32)
    cand_h = rng.normal(0, 1, (B, M)).astype(np.float32)
    cand_i = rng.integers(0, O, (B, M)).astype(np.int32)
    cand_v = rng.random((B, M)) < 0.6
    cand_v[4:8][cand_i[4:8] == 0] = False          # dropout window
    if ties:
        # equidistant candidates: the association must keep the first
        cand_pos[:, M // 2:] = cand_pos[:, :M - M // 2]
    dts = np.full((B,), 1 / 60, np.float32)
    dts[9] = 0.7                                   # trips gap_reset_s
    return cand_pos, cand_h, cand_i, cand_v, dts


def _port_inputs(case):
    cp, ch, ci, cv, dts = case
    return (torch.from_numpy(cp), torch.from_numpy(ch), torch.from_numpy(ci),
            torch.from_numpy(cv), torch.from_numpy(dts))


def _port_state(O):
    st = jkalman.init_state(O)
    return kalman_state_from_numpy(*(np.asarray(leaf) for leaf in st),
                                   device="cpu")


def _assert_tracked(want_t, got, t, tol):
    np.testing.assert_array_equal(np.asarray(want_t.valid),
                                  got.valid[t].numpy())
    for name in ("pos", "vel", "heading"):
        np.testing.assert_allclose(np.asarray(getattr(want_t, name)),
                                   getattr(got, name)[t].numpy(), **tol)


def _assert_state(want, got, tol):
    np.testing.assert_array_equal(np.asarray(want.initialized),
                                  got.initialized.numpy())
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(w, np.float32),
                                   g.numpy().astype(np.float32), **tol)


_JIT_TOL = dict(atol=5e-5, rtol=1e-5)
_EXACT = dict(atol=0, rtol=0)


@pytest.mark.parametrize("jit", [True, False])
@pytest.mark.parametrize("report", ["pre", "post"])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_bank_matches_jax_update_chain(report, ties, jit):
    case = _case(ties=ties)
    cp, ch, ci, cv, dts = case
    st = jkalman.init_state(2)
    want = []
    with jax.disable_jit(not jit):
        for t in range(len(dts)):
            st, tr = jkalman.update(
                st, jnp.asarray(cp[t]), jnp.asarray(ch[t]),
                jnp.asarray(ci[t]), jnp.asarray(cv[t]), jnp.asarray(dts[t]),
                report=report)
            want.append(tr)
    got_st, got = kalman.update_scan(_port_state(2), *_port_inputs(case),
                                     report=report)
    tol = _JIT_TOL if jit else _EXACT
    for t in range(len(dts)):
        _assert_tracked(want[t], got, t, tol)
    _assert_state(st, got_st, tol)


def _nan_case():
    """The random case with one candidate of object 0 at a NaN position,
    behind a finite one of the same object: argmin takes the NaN."""
    case = _case(seed=11)
    cp, _, ci, cv, _ = case
    t = next(t for t in range(len(cp)) if (cv[t] & (ci[t] == 0)).sum() >= 2)
    m = np.flatnonzero(cv[t] & (ci[t] == 0))[1]
    cp[t, m, 0] = np.nan
    return case, t


@pytest.mark.parametrize("jit", [True, False])
@pytest.mark.parametrize("report", ["pre", "post"])
def test_plain_bank_matches_jax_update_chain_with_nan_candidate(report, jit):
    """Association at a NaN distance: the plain chain and JAX's
    ``kalman.update`` both follow argmin (the first NaN wins), and the NaN
    reaches the same outputs and state."""
    case, t_nan = _nan_case()
    cp, ch, ci, cv, dts = case
    st = jkalman.init_state(2)
    want = []
    with jax.disable_jit(not jit):
        for t in range(len(dts)):
            st, tr = jkalman.update(
                st, jnp.asarray(cp[t]), jnp.asarray(ch[t]),
                jnp.asarray(ci[t]), jnp.asarray(cv[t]), jnp.asarray(dts[t]),
                report=report)
            want.append(tr)
    got_st, got = kalman.update_scan(_port_state(2), *_port_inputs(case),
                                     report=report)
    tol = _JIT_TOL if jit else _EXACT
    for t in range(len(dts)):
        _assert_tracked(want[t], got, t, tol)
    _assert_state(st, got_st, tol)
    assert not torch.isnan(got.vel[:t_nan]).any()
    assert torch.isnan(got.vel[t_nan + 1:, 0]).any()


def test_plain_bank_matches_pallas_interpret():
    case = _case(seed=5, B=12, M=6)
    st_p, got_p = jkalman_scan(
        jkalman.init_state(2), *(jnp.asarray(a) for a in case),
        interpret=True)
    got_st, got = kalman.update_scan(_port_state(2), *_port_inputs(case))
    for t in range(len(case[4])):
        _assert_tracked(jax.tree.map(lambda x: x[t], got_p), got, t,
                        _JIT_TOL)
    _assert_state(st_p, got_st, _JIT_TOL)


def test_wrapper_takes_plain_chain_on_cpu():
    case = _port_inputs(_case(seed=7))
    before = kalman_cuda.launches
    st_w, tr_w = kalman_cuda.kalman_scan(_port_state(2), *case)
    st_p, tr_p = kalman.update_scan(_port_state(2), *case)
    assert kalman_cuda.launches == before      # no kernel on the CPU
    for a, b in zip((*st_w, *tr_w), (*st_p, *tr_p)):
        assert torch.equal(a, b)


def test_wrapper_on_card_never_falls_back(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: with no
    kernel built it raises, it does not run the plain chain."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel built")

    monkeypatch.setattr(native, "on_card", lambda t: True)
    monkeypatch.setattr(native, "load", no_kernel)
    before = kalman_cuda.launches
    with pytest.raises(RuntimeError, match="kalman_bank"):
        kalman_cuda.kalman_scan(_port_state(2), *_port_inputs(_case()))
    assert kalman_cuda.launches == before


def test_wrapper_on_card_refuses_other_dtypes(monkeypatch):
    """On the card the wrapper converts nothing: an int64 index is refused
    before any kernel is built."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel built")

    monkeypatch.setattr(native, "on_card", lambda t: True)
    monkeypatch.setattr(native, "load", no_kernel)
    case = list(_port_inputs(_case()))
    case[2] = case[2].to(torch.int64)
    with pytest.raises(ValueError, match="contiguous torch.int32"):
        kalman_cuda.kalman_scan(_port_state(2), *case)


def test_report_must_be_pre_or_post():
    with pytest.raises(ValueError):
        kalman_cuda.kalman_scan(_port_state(1), *_port_inputs(_case(O=1)),
                                report="bogus")
