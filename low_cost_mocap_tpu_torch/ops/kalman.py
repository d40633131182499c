"""Batched constant-acceleration Kalman bank + low-pass post-filtering.

Counterpart of ``low_cost_mocap_tpu/ops/kalman.py:update`` on the serving
options (``report`` "pre"/"post", no advance on a miss, no covariance
output).  The O objects are one batch axis (the JAX package vmaps them).

This chain is the plain PyTorch version of the bank kernel
(``ops/kalman_cuda.py``, ``csrc/kalman_bank.cu``): the kernel performs the
same float32 operations in the same order, so on the card the two agree
bitwise.  The squared association distance is written out as
``(dx*dx + dy*dy) + dz*dz`` for that reason, instead of a reduction whose
order the library chooses.

Model: 9-state [pos, vel, acc] constant-acceleration filter, 6-dim
[pos, vel] measurement (H = [I6 | 0], R = meas_noise I), Q = process_noise
I; lazy init from the lowest-slot candidate; nearest-candidate
association; velocity measured over the time since the object's last
detection and re-seeded after ``gap_reset_s``; six sequential scalar
updates; a long-gap state re-seed; order-5 Butterworth on heading and
velocity; state committed only on frames with a detection.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.ops import lowpass


class KalmanState(NamedTuple):
    x: torch.Tensor            # (O, 9) statePost
    P: torch.Tensor            # (O, 9, 9) errorCovPost
    initialized: torch.Tensor  # (O,) bool
    prev_pos: torch.Tensor     # (O, 3)
    lpf_heading: torch.Tensor  # (O, 5)
    lpf_vel: torch.Tensor      # (O, 3, 5)
    age: torch.Tensor          # (O,) seconds since the last detection


class TrackedObjects(NamedTuple):
    pos: torch.Tensor       # (..., O, 3)
    vel: torch.Tensor       # (..., O, 3) low-passed
    heading: torch.Tensor   # (..., O) low-passed
    valid: torch.Tensor     # (..., O) bool — detected this frame


def init_state(num_objects: int, device=None,
               dtype=torch.float32) -> KalmanState:
    """A fresh bank of ``num_objects`` on ``device`` (CUDA by default)."""
    O = num_objects
    device = resolve_device(device)
    return KalmanState(
        x=torch.zeros(O, 9, dtype=dtype, device=device),
        P=torch.eye(9, dtype=dtype, device=device).repeat(O, 1, 1),
        initialized=torch.zeros(O, dtype=torch.bool, device=device),
        prev_pos=torch.zeros(O, 3, dtype=dtype, device=device),
        lpf_heading=torch.zeros(O, 5, dtype=dtype, device=device),
        lpf_vel=torch.zeros(O, 3, 5, dtype=dtype, device=device),
        age=torch.zeros(O, dtype=dtype, device=device),
    )


def _f_rows(m, dt, hdt2):
    """F @ m along axis 1 of (O, 9, ...): the CA-model transition as slice
    arithmetic."""
    return torch.cat([
        (m[:, 0:3] + dt * m[:, 3:6]) + hdt2 * m[:, 6:9],
        m[:, 3:6] + dt * m[:, 6:9],
        m[:, 6:9],
    ], dim=1)


def update(state: KalmanState, cand_pos, cand_heading, cand_index,
           cand_valid, dt, *, process_noise: float = 1e-2,
           meas_noise: float = 1.0, gap_reset_s: float = 0.5,
           report: str = "pre"):
    """One tracking step for the whole bank.

    cand_*: (M,) candidates from ``ops.rigid.locate_objects`` (pos (M, 3),
    heading (M,), index (M,) int, valid (M,) bool); dt: float32 0-d tensor
    or float.  Returns (new_state, TrackedObjects).
    """
    if report not in ("pre", "post"):
        raise ValueError(f"report must be 'pre' or 'post', got {report!r}")
    x, P, inited, prev_pos, lh, lv, age = state
    O = x.shape[0]
    dev, dtype = x.device, x.dtype
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    Q = torch.eye(9, dtype=dtype, device=dev) * process_noise
    r = torch.tensor(meas_noise, dtype=dtype, device=dev)
    b_np, a_np = lowpass.butter_coeffs()
    b = torch.from_numpy(b_np).to(dev)
    a = torch.from_numpy(a_np).to(dev)

    ids = torch.arange(O, device=dev)
    mine = cand_valid[None, :] & (cand_index[None, :] == ids[:, None])  # (O,M)
    any_mine = mine.any(dim=-1)

    # lazy init from the first (lowest-slot) candidate
    first = torch.argmax(mine.to(torch.uint8), dim=-1)
    init_pos = cand_pos[first]                                   # (O, 3)
    need_init = any_mine & ~inited
    x = torch.where(need_init[:, None], torch.cat([init_pos, x[:, 3:]], 1), x)
    prev_pos = torch.where(need_init[:, None], init_pos, prev_pos)
    inited = inited | need_init

    # predict
    hdt2 = 0.5 * dt * dt
    x_pre = _f_rows(x, dt, hdt2)
    FP = _f_rows(P, dt, hdt2)                                    # F @ P
    P_pre = torch.cat([
        (FP[:, :, 0:3] + dt * FP[:, :, 3:6]) + hdt2 * FP[:, :, 6:9],
        FP[:, :, 3:6] + dt * FP[:, :, 6:9],
        FP[:, :, 6:9],
    ], dim=2) + Q

    # associate: nearest candidate to the predicted position (first min)
    dp = cand_pos[None, :, :] - x_pre[:, None, 0:3]              # (O, M, 3)
    d2 = (dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]) \
        + dp[..., 2] * dp[..., 2]
    d2 = torch.where(mine, d2, float("inf"))
    ci = torch.argmin(d2, dim=-1)
    new_pos = cand_pos[ci]                                       # (O, 3)
    elapsed = age + dt
    reseed = elapsed > gap_reset_s
    vel_base = torch.where(reseed[:, None], new_pos, prev_pos)
    new_vel = (new_pos - vel_base) / torch.clamp_min(elapsed, 1e-6)[:, None]
    z = torch.cat([new_pos, new_vel], dim=1)                     # (O, 6)

    # correct: six sequential scalar measurement updates
    x_post, P_post = x_pre, P_pre
    for i in range(6):
        Pi = P_post[:, :, i]                                     # (O, 9)
        Kv = Pi / (Pi[:, i:i + 1] + r)
        x_post = x_post + Kv * (z[:, i:i + 1] - x_post[:, i:i + 1])
        P_post = P_post - Kv[:, :, None] * P_post[:, i:i + 1, :]

    # long-gap reacquisition: re-seed from the measurement
    reseed_all = reseed & inited
    x_seed = torch.cat([new_pos, torch.zeros_like(x[:, 3:])], dim=1)
    x_post = torch.where(reseed_all[:, None], x_seed, x_post)
    P_post = torch.where(reseed_all[:, None, None],
                         torch.eye(9, dtype=dtype, device=dev), P_post)

    x_rep = x_pre if report == "pre" else x_post
    x_rep = torch.where(reseed_all[:, None], x_post, x_rep)
    lh2, heading_f = lowpass.lpf_step(lh, cand_heading[ci], b, a)
    lv2, vel_f = lowpass.lpf_step(lv, x_rep[:, 3:6], b, a)

    # commit only when the object had a detection
    def upd(new, old):
        return torch.where(any_mine.reshape((O,) + (1,) * (new.dim() - 1)),
                           new, old)

    new_state = KalmanState(
        x=upd(x_post, x),
        P=upd(P_post, P),
        initialized=inited,
        prev_pos=upd(new_pos, prev_pos),
        lpf_heading=upd(lh2, lh),
        lpf_vel=upd(lv2, lv),
        age=torch.where(any_mine, torch.zeros_like(age), age + dt),
    )
    tracked = TrackedObjects(
        pos=torch.where(any_mine[:, None], x_rep[:, :3], 0.0),
        vel=torch.where(any_mine[:, None], vel_f, 0.0),
        heading=torch.where(any_mine, heading_f, 0.0),
        valid=any_mine,
    )
    return new_state, tracked


def update_scan(state: KalmanState, cand_pos_seq, cand_heading_seq,
                cand_index_seq, cand_valid_seq, dts, **kw):
    """B sequential ``update`` steps over (B, M, ...) candidate sequences;
    returns (new_state, TrackedObjects with (B, O, ...) leaves)."""
    outs = []
    for t in range(cand_pos_seq.shape[0]):
        state, tr = update(state, cand_pos_seq[t], cand_heading_seq[t],
                           cand_index_seq[t], cand_valid_seq[t], dts[t],
                           **kw)
        outs.append(tr)
    return state, TrackedObjects(*(torch.stack(leaf) for leaf in zip(*outs)))
