"""The Kalman bank over a batch of frames through the ``kalman_bank`` kernel.

Replaces ``low_cost_mocap_tpu/ops/kalman_pallas.py:kalman_scan``.  One
kernel launch runs B sequential bank updates (``csrc/kalman_bank.cu``: one
warp per object, the B loop inside, the step's candidates staged in shared
memory one step ahead) with the serving options; it agrees bitwise with B
chained ``kalman.update`` steps, which are its plain version.  Per-frame
tracking calls it with B = 1, so per-frame and batched serving share one
bank.

``kalman_scan`` takes the plain chain for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  It converts nothing: inputs of
another dtype or layout are refused.  ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from low_cost_mocap_tpu_torch.ops import kalman, lowpass, native
from low_cost_mocap_tpu_torch.ops.kalman import KalmanState, TrackedObjects

NAME = "kalman_bank"
launches = 0

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# dtypes of cand_pos, heading, index, valid, dts, then the KalmanState leaves
_DTYPES = (_F32, _F32, _I32, _BOOL, _F32,
           _F32, _F32, _BOOL, _F32, _F32, _F32, _F32)
# float32 state leaves after the per-step outputs: x, P, prev, lh, lv, age
_STATE_FLOATS = (9, 81, 3, 5, 15, 1)


def _lib():
    lib = native.load(NAME)
    if not getattr(lib, "_lcm_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lcm_kalman_bank.argtypes = [P] * 14 + [I, I, I, Fl, Fl, Fl, I, P]
        lib.lcm_kalman_bank.restype = I
        lib._lcm_typed = True
    return lib


@functools.lru_cache(maxsize=1)
def _butter_host():
    """The (2, 6) float32 Butterworth b; a in host memory, built once; the
    launch passes them by value."""
    b, a = lowpass.butter_coeffs()
    return (ctypes.c_float * 12)(*b.tolist(), *a.tolist())


def kalman_scan(state: KalmanState, cand_pos_seq, cand_heading_seq,
                cand_index_seq, cand_valid_seq, dts, *,
                process_noise: float = 1e-2, meas_noise: float = 1.0,
                gap_reset_s: float = 0.5, report: str = "pre"):
    """B sequential bank updates.

    cand_pos_seq (B, M, 3) f32, cand_heading_seq (B, M) f32,
    cand_index_seq (B, M) int32, cand_valid_seq (B, M) bool, dts (B,) f32;
    on the card all contiguous, as are the state's leaves.
    Returns (new_state, TrackedObjects with (B, O, ...) leaves); on the
    card all of them are views of one allocation.
    """
    global launches
    kw = dict(process_noise=process_noise, meas_noise=meas_noise,
              gap_reset_s=gap_reset_s, report=report)
    if report not in ("pre", "post"):
        raise ValueError(f"report must be 'pre' or 'post', got {report!r}")
    if not native.on_card(cand_pos_seq):
        return kalman.update_scan(state, cand_pos_seq, cand_heading_seq,
                                  cand_index_seq, cand_valid_seq, dts, **kw)
    dev = cand_pos_seq.device
    B, M, _ = cand_pos_seq.shape
    O = state.x.shape[0]
    ins = (cand_pos_seq, cand_heading_seq, cand_index_seq, cand_valid_seq,
           dts, *state)
    shapes = ((B, M, 3), (B, M), (B, M), (B, M), (B,), (O, 9), (O, 9, 9),
              (O,), (O, 3), (O, 5), (O, 3, 5), (O,))
    for t, shape, dtype in zip(ins, shapes, _DTYPES):
        if t.device != dev:
            raise ValueError("kalman_scan: all tensors must be on one device")
        if t.shape != shape:
            raise ValueError(f"kalman_scan: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kalman_scan: expected a contiguous {dtype} "
                             f"tensor, got {t.dtype}")
    lib = _lib()
    BO = B * O
    nf = 7 * BO + O * sum(_STATE_FLOATS)
    out = torch.empty(4 * nf + BO + O, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):   # the C launcher uses the current device
        native.check(lib.lcm_kalman_bank(
            *(t.data_ptr() for t in ins[:5]),
            ctypes.addressof(_butter_host()),
            *(t.data_ptr() for t in ins[5:]), out.data_ptr(),
            B, M, O, process_noise, meas_noise, gap_reset_s,
            report == "post", torch.cuda.current_stream(dev).cuda_stream),
            NAME)
    launches += 1
    fbytes, bbytes = out.split([4 * nf, BO + O])
    pos, vel, heading, x, P, prev, lh, lv, age = fbytes.view(_F32).split(
        [3 * BO, 3 * BO, BO] + [O * n for n in _STATE_FLOATS])
    valid, init = bbytes.view(_BOOL).split([BO, O])
    new = KalmanState(x.view(O, 9), P.view(O, 9, 9), init, prev.view(O, 3),
                      lh.view(O, 5), lv.view(O, 3, 5), age)
    return new, TrackedObjects(pos=pos.view(B, O, 3), vel=vel.view(B, O, 3),
                               heading=heading.view(B, O),
                               valid=valid.view(B, O))
