"""PyTorch port: the RTS smoother's forward filter through
``ops/kalman_cuda.py:forward_scan`` on the CPU, where it is the plain
chain (``kalman.forward_filter``, ``_forward_step`` frame by frame through
the loop runner it is given): bitwise equal to ``update_scan`` with the
forward options, the same checks of its inputs as ``kalman_scan``, and
``smooth_sequence`` with it as the injected forward runner equal to the
default.  The kernel's forward instantiation is held to the same chain on
the card by ``tests/test_torch_cuda_kernels.py``, which takes its cases
from ``forward_case`` here.
"""

import numpy as np
import pytest
import torch

from low_cost_mocap_tpu_torch.ops import kalman, kalman_cuda, native
from low_cost_mocap_tpu_torch.utils import tree

torch.set_num_threads(1)
GAP_RESET_S = 0.5    # kalman.update's default


def forward_case(seed, B, M, O, dt=1 / 60):
    """Candidates (pos, heading, index, valid, dts) of O objects over B
    steps with the gaps the forward filter bridges: objects 1, 2, 4, 5, ...
    miss their first 3 (o % 3) steps, every object has short gaps of 1-4
    steps, and, where B allows, one gap longer than ``GAP_RESET_S``; one
    interval of 0.7 s re-seeds too.  The rest as the bank's cases: random
    slots, association ties, invalid slots, indices of no object."""
    rng = np.random.default_rng(seed)
    cp = rng.normal(0, 0.4, (B, M, 3)).astype(np.float32)
    cp[:, M // 2:] = cp[:, :M - M // 2]                  # association ties
    ch = rng.normal(0, 1, (B, M)).astype(np.float32)
    ci = rng.integers(-1, O, (B, M)).astype(np.int32)    # -1: no object
    cv = rng.random((B, M)) < 0.5
    dts = np.full((B,), dt, np.float32)
    if B > 2:
        dts[B // 2] = 0.7
    long = int(GAP_RESET_S / dt) + 10
    for o in range(O):
        miss = np.zeros(B, bool)
        miss[:3 * (o % 3)] = True            # before the first detection
        for _ in range(B // 25):
            s = rng.integers(0, B)
            miss[s:s + rng.integers(1, 5)] = True
        if B > 3 * long:
            s = rng.integers(B // 4, B // 2)
            miss[s:s + long] = True
        ci[miss[:, None] & (ci == o)] = -1
    return cp, ch, ci, cv, dts


def _case(seed=3, B=150, M=32, O=3):
    return [torch.from_numpy(a) for a in forward_case(seed, B, M, O)]


def test_forward_case_has_its_gaps():
    """Misses before the first detection, short gaps and one longer than
    ``GAP_RESET_S`` (in steps of 1/60 s)."""
    cp, ch, ci, cv, dts = forward_case(3, 150, 32, 3)
    seen = ((ci[:, :, None] == np.arange(3)) & cv[:, :, None]).any(1)
    assert not seen[:3, 1].any() and not seen[:6, 2].any()
    runs = [np.diff(np.flatnonzero(seen[:, o])) - 1 for o in range(3)]
    gaps = np.concatenate(runs)
    assert (gaps > 0).any() and gaps.max() > GAP_RESET_S * 60


def test_forward_scan_on_the_cpu_is_the_plain_chain():
    """Every output and the final state bitwise those of ``update_scan``
    with the forward options, the per-step initialised flags those of the
    steps' states; the runner it is given runs the loop, and no kernel
    launch is counted."""
    case = _case()
    st0 = kalman.init_state(3, device="cpu")
    runs = []
    counts = (kalman_cuda.launches, kalman_cuda.forward_launches)

    def scan(step, carry, *xs):
        runs.append(step.func)
        return tree.scan(step, carry, *xs)

    st, ((tr, xs, Ps), inited) = kalman_cuda.forward_scan(
        st0, *case, meas_noise=1.0, scan=scan)
    assert runs == [kalman._forward_step]
    assert (kalman_cuda.launches, kalman_cuda.forward_launches) == counts
    want_st, (want_tr, want_xs, want_Ps) = kalman.update_scan(
        st0, *case, report="post", advance_on_miss=True, return_cov=True)
    for got, want in zip((*st, *tr, xs, Ps), (*want_st, *want_tr, want_xs,
                                               want_Ps)):
        assert torch.equal(got, want)
    flags, s = [], st0
    for t in range(len(case[4])):
        s, _ = kalman.update(s, *(a[t] for a in case), advance_on_miss=True)
        flags.append(s.initialized)
    assert torch.equal(inited, torch.stack(flags))
    assert not inited[0, 1] and inited[-1].all()


@pytest.mark.parametrize("fault,match", [
    ("shape", "expected shape"), ("dtype", "contiguous torch.int32"),
    ("device", "one device"), ("contiguous", "contiguous torch.float32")])
def test_forward_scan_refuses_what_the_kernel_does_not_take(fault, match):
    """As ``kalman_scan`` refuses it on the card, on either device."""
    case = _case(B=8, M=8, O=2)
    st = kalman.init_state(2, device="cpu")
    if fault == "shape":
        case[1] = case[1][:, :4]
    elif fault == "dtype":
        case[2] = case[2].long()
    elif fault == "device":
        case[4] = case[4].to("meta")
    else:
        st = st._replace(P=st.P.transpose(1, 2))
    with pytest.raises(ValueError, match=match):
        kalman_cuda.forward_scan(st, *case)


def test_smooth_sequence_with_the_kernel_runner_equals_its_default():
    """``smooth_sequence(forward=kalman_cuda.forward_scan)`` on the CPU
    (the offline path's runner) gives the default's smoothed tracks and
    states bitwise, and hands the runner its ``scan``."""
    case = _case(seed=4)
    st0 = kalman.init_state(3, device="cpu")
    kw = dict(process_noise=2e-2, meas_noise=0.5)
    calls = []

    def forward(*a, **k):
        calls.append(k["scan"])
        return kalman_cuda.forward_scan(*a, **k)

    got = kalman.smooth_sequence(st0, *case, forward=forward, **kw)
    want = kalman.smooth_sequence(st0, *case, **kw)
    assert calls == [tree.scan]
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        assert torch.equal(g, w)


def test_forward_scan_on_the_card_never_falls_back(monkeypatch):
    """On a CUDA tensor it launches the kernel or raises: with no kernel
    built it raises, it does not run the plain chain, and counts
    nothing."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel built")

    monkeypatch.setattr(native, "on_card", lambda t: True)
    monkeypatch.setattr(native, "load", no_kernel)
    counts = (kalman_cuda.launches, kalman_cuda.forward_launches)
    with pytest.raises(RuntimeError, match="kalman_bank"):
        kalman_cuda.forward_scan(kalman.init_state(2, device="cpu"),
                                 *_case(B=8, M=8, O=2))
    assert (kalman_cuda.launches, kalman_cuda.forward_launches) == counts
