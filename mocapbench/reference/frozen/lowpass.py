"""Frozen copy of ``low_cost_mocap_tpu_torch/ops/lowpass.py`` (commit
9b1e9ac), its imports made relative; the benchmark's reference runs it
op by op and never imports the program.

Streaming Butterworth low-pass bank (order-5 IIR, direct form II-T).

Counterpart of ``low_cost_mocap_tpu/ops/lowpass.py``: the 5-element
direct-form-II-transposed state per channel advances in O(order) per
sample — with zero initial state exactly ``scipy.signal.lfilter`` over the
whole history.  ``lpf_scan`` filters a recorded sequence.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .device import resolve_device


@functools.lru_cache(maxsize=16)
def butter_coeffs(order: int = 5, cutoff_hz: float = 20.0,
                  sample_hz: float = 60.0):
    """(b, a) float32 numpy coefficient arrays (scipy design)."""
    from scipy.signal import butter

    b, a = butter(order, cutoff_hz / (sample_hz / 2.0), btype="low")
    return np.asarray(b, np.float32), np.asarray(a, np.float32)


def init_state(shape: tuple, order: int = 5, dtype=torch.float32,
               device=None):
    """Zero filter state for a bank of channels: shape + (order,), on
    ``device`` (CUDA by default)."""
    return torch.zeros(tuple(shape) + (order,), dtype=dtype,
                       device=resolve_device(device))


def lpf_step(state, x, b, a):
    """One direct-form-II-transposed step for a bank of channels.

    state: (..., order); x: (...) new samples; b, a: (order+1,) tensors.
    Returns (new_state, y), the recurrence of ``scipy.signal.lfilter``.
    """
    y = b[0] * x + state[..., 0]
    order = state.shape[-1]
    new = [
        b[i + 1] * x + state[..., i + 1] - a[i + 1] * y
        for i in range(order - 1)
    ]
    new.append(b[order] * x - a[order] * y)
    return torch.stack(new, dim=-1), y


def lpf_scan(x_seq, b, a, state=None):
    """Offline: filter a whole (T, ...) sequence, one ``lpf_step`` per
    sample from ``state`` (zero by default); returns the (T, ...) output.
    ``b``, ``a``: numpy arrays or tensors of the coefficients."""
    b = torch.as_tensor(b, dtype=x_seq.dtype, device=x_seq.device)
    a = torch.as_tensor(a, dtype=x_seq.dtype, device=x_seq.device)
    if state is None:
        state = init_state(x_seq.shape[1:], order=len(b) - 1,
                           dtype=x_seq.dtype, device=x_seq.device)
    ys = []
    for x in x_seq:
        state, y = lpf_step(state, x, b, a)
        ys.append(y)
    return torch.stack(ys)
