"""The Kalman bank over a batch of frames through the ``kalman_bank`` kernel.

Replaces ``low_cost_mocap_tpu/ops/kalman_pallas.py:kalman_scan``.  One
kernel launch runs B sequential bank updates (``csrc/kalman_bank.cu``: one
thread per object, the B loop inside, state in registers) with the
serving options; it agrees bitwise with B chained ``kalman.update`` steps,
which are its plain version.  Per-frame tracking calls it with B = 1, so
per-frame and batched serving share one bank.

``kalman_scan`` takes the plain chain for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from low_cost_mocap_tpu_torch.ops import kalman, lowpass, native
from low_cost_mocap_tpu_torch.ops.kalman import KalmanState, TrackedObjects

NAME = "kalman_bank"
launches = 0


def _lib():
    lib = native.load(NAME)
    if not getattr(lib, "_lcm_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lcm_kalman_bank.argtypes = [P] * 24 + [I, I, I, Fl, Fl, Fl, I, P]
        lib.lcm_kalman_bank.restype = I
        lib._lcm_typed = True
    return lib


def kalman_scan(state: KalmanState, cand_pos_seq, cand_heading_seq,
                cand_index_seq, cand_valid_seq, dts, *,
                process_noise: float = 1e-2, meas_noise: float = 1.0,
                gap_reset_s: float = 0.5, report: str = "pre"):
    """B sequential bank updates.

    cand_pos_seq (B, M, 3) f32, cand_heading_seq (B, M) f32,
    cand_index_seq (B, M) int, cand_valid_seq (B, M) bool, dts (B,) f32.
    Returns (new_state, TrackedObjects with (B, O, ...) leaves).
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
    f32 = torch.float32
    shapes = ((cand_pos_seq, (B, M, 3)), (cand_heading_seq, (B, M)),
              (cand_index_seq, (B, M)), (cand_valid_seq, (B, M)), (dts, (B,)),
              *zip(state, ((O, 9), (O, 9, 9), (O,), (O, 3), (O, 5),
                           (O, 3, 5), (O,))))
    for t, shape in shapes:
        if t.device != dev:
            raise ValueError("kalman_scan: all tensors must be on one device")
        if tuple(t.shape) != shape:
            raise ValueError(f"kalman_scan: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
    lib = _lib()
    # host memory: the launch passes the coefficients by value
    ba = np.concatenate(lowpass.butter_coeffs())
    ins = [cand_pos_seq.to(f32).contiguous(),
           cand_heading_seq.to(f32).contiguous(),
           cand_index_seq.to(torch.int32).contiguous(),
           cand_valid_seq.to(torch.bool).contiguous(),
           dts.to(f32).contiguous(),
           state.x.to(f32).contiguous(), state.P.to(f32).contiguous(),
           state.initialized.to(torch.bool).contiguous(),
           state.prev_pos.to(f32).contiguous(),
           state.lpf_heading.to(f32).contiguous(),
           state.lpf_vel.to(f32).contiguous(), state.age.to(f32).contiguous()]
    pos = torch.empty((B, O, 3), dtype=f32, device=dev)
    vel = torch.empty((B, O, 3), dtype=f32, device=dev)
    heading = torch.empty((B, O), dtype=f32, device=dev)
    valid = torch.empty((B, O), dtype=torch.bool, device=dev)
    new = KalmanState(*(torch.empty_like(t) for t in ins[5:]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.check(lib.lcm_kalman_bank(
        *(t.data_ptr() for t in ins[:5]), ba.ctypes.data,
        *(t.data_ptr() for t in ins[5:]),
        pos.data_ptr(), vel.data_ptr(), heading.data_ptr(), valid.data_ptr(),
        *(t.data_ptr() for t in new),
        B, M, O, float(process_noise), float(meas_noise), float(gap_reset_s),
        int(report == "post"), stream), NAME)
    launches += 1
    return new, TrackedObjects(pos=pos, vel=vel, heading=heading, valid=valid)
