"""PyTorch port: the RTS smoother's backward pass through
``ops/kalman_cuda.py:backward_scan`` on the CPU, where it is the plain
version (``kalman.rts_smooth``: the gains of every step at once, then the
sweep through the loop runner it is given): bitwise equal to
``rts_smooth``, the same kind of checks of its inputs as ``forward_scan``,
``smooth_sequence`` with it as the injected backward runner equal to the
default, and the gains solving their equation.  The kernels are held to
the same plain version on the card by ``tests/test_torch_cuda_kernels.py``;
``tests/test_torch_smoother.py`` holds ``rts_smooth`` to the JAX package.
"""

import pytest
import torch

from low_cost_mocap_tpu_torch.ops import kalman, kalman_cuda, native
from low_cost_mocap_tpu_torch.utils import tree
from test_torch_kalman_forward import forward_case   # tests/ is on the path

torch.set_num_threads(1)


def _filtered(seed=3, T=150, M=32, O=3):
    """(xs, Ps, dts) of the forward filter over ``forward_case``."""
    case = [torch.from_numpy(a) for a in forward_case(seed, T, M, O)]
    _, ((_, xs, Ps), _) = kalman.forward_filter(
        kalman.init_state(O, device="cpu"), *case)
    return xs, Ps, case[4]


@pytest.mark.parametrize("T,O", [(1, 2), (2, 1), (33, 2), (150, 3)])
def test_backward_scan_on_the_cpu_is_rts_smooth(T, O):
    """Both outputs bitwise those of ``rts_smooth``, the last frame the
    filtered one; the runner it is given runs the sweep (none for one
    frame), and no kernel launch is counted."""
    xs, Ps, dts = _filtered(seed=T + O, T=T, O=O)
    runs = []
    counts = (kalman_cuda.launches, kalman_cuda.backward_launches)

    def scan(step, carry, *xs_k, reverse=False):
        runs.append((step, reverse))
        return tree.scan(step, carry, *xs_k, reverse=reverse)

    got = kalman_cuda.backward_scan(xs, Ps, dts, process_noise=2e-2,
                                    scan=scan)
    assert runs == ([(kalman._rts_step, True)] if T > 1 else [])
    assert (kalman_cuda.launches, kalman_cuda.backward_launches) == counts
    want = kalman.rts_smooth(xs, Ps, dts, process_noise=2e-2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[0][-1], xs[-1]) and torch.equal(got[1][-1],
                                                           Ps[-1])


@pytest.mark.parametrize("fault,match", [
    ("shape", "expected shape"), ("dtype", "contiguous torch.float32"),
    ("device", "one device"), ("contiguous", "contiguous torch.float32")])
def test_backward_scan_refuses_what_the_kernel_does_not_take(fault, match):
    """As it would refuse it on the card, on either device."""
    xs, Ps, dts = _filtered(T=8, O=2)
    if fault == "shape":
        dts = dts[:4]
    elif fault == "dtype":
        xs = xs.double()
    elif fault == "device":
        dts = dts.to("meta")
    else:
        Ps = Ps.transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        kalman_cuda.backward_scan(xs, Ps, dts)


def test_smooth_sequence_with_the_kernel_runners_equals_its_default():
    """``smooth_sequence`` with both kernel runners (the offline path's)
    on the CPU gives the default's smoothed tracks and states bitwise, and
    hands the backward runner its ``scan``."""
    case = [torch.from_numpy(a) for a in forward_case(4, 150, 32, 3)]
    st0 = kalman.init_state(3, device="cpu")
    kw = dict(process_noise=2e-2, meas_noise=0.5)
    calls = []

    def backward(*a, **k):
        calls.append(k["scan"])
        return kalman_cuda.backward_scan(*a, **k)

    got = kalman.smooth_sequence(st0, *case, forward=kalman_cuda.forward_scan,
                                 backward=backward, **kw)
    want = kalman.smooth_sequence(st0, *case, **kw)
    assert calls == [tree.scan]
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        assert torch.equal(g, w)


def test_the_gains_solve_their_equation():
    """C_k P_pred = P_k F' to float32 rounding, with P_pred = F P_k F' + Q
    and x_pred = F x_k as the transition matrix gives them; in float64
    the gains are those of the inverse."""
    xs, Ps, dts = _filtered(seed=5)
    C, x_pred, P_pred = kalman._rts_gains(xs, Ps, dts, process_noise=1e-2)
    F = kalman._transition(dts[1:])[:, None]
    assert torch.allclose(x_pred, (F @ xs[:-1, ..., None])[..., 0],
                          rtol=1e-6, atol=1e-6)
    assert torch.allclose(P_pred, F @ Ps[:-1] @ F.transpose(-1, -2)
                          + 1e-2 * torch.eye(9), rtol=1e-6, atol=1e-6)
    G = Ps[:-1] @ F.transpose(-1, -2)
    assert torch.allclose(C @ P_pred, G, rtol=1e-5, atol=1e-6)
    xs, Ps, dts = xs.double(), Ps.double(), dts.double()
    C, _, P_pred = kalman._rts_gains(xs, Ps, dts, process_noise=1e-2)
    F = kalman._transition(dts[1:])[:, None]
    want = Ps[:-1] @ F.transpose(-1, -2) @ torch.linalg.inv(P_pred)
    assert torch.allclose(C, want, rtol=1e-10, atol=1e-12)


def test_backward_scan_on_the_card_never_falls_back(monkeypatch):
    """On a CUDA tensor it launches the kernels or raises: with no kernel
    built it raises, it does not run the plain version, and counts
    nothing."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel built")

    monkeypatch.setattr(native, "on_card", lambda t: True)
    monkeypatch.setattr(native, "load", no_kernel)
    counts = (kalman_cuda.launches, kalman_cuda.backward_launches)
    with pytest.raises(RuntimeError, match="kalman_bank"):
        kalman_cuda.backward_scan(*_filtered(T=8, O=2))
    assert (kalman_cuda.launches, kalman_cuda.backward_launches) == counts
