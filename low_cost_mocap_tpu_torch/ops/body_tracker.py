"""Temporal 6-DoF rigid-body tracking over per-frame fits.

Counterpart of ``low_cost_mocap_tpu/ops/body_tracker.py``: per-frame
6-DoF fits (``ops/rigid_general.py``) are associated to ``max_bodies``
persistent track slots inside a gate around each track's constant-velocity
prediction (which rejects the consistent-but-wrong interpretations a
single frame cannot), then alpha-beta filtered on position/velocity with a
sign-aligned quaternion low-pass on orientation.  Association is exact
(``ops/assignment.py``) when max(slots, fits) <= 8, greedy above.

The offline smoother (``smooth_body_sequence``) runs the same tracker over
a recording for association, then a constant-velocity Kalman forward pass,
an RTS backward pass and quaternion SLERP through occlusion gaps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.ops.assignment import assign
from low_cost_mocap_tpu_torch.ops.rotations import (matrix_to_quat,
                                                    quat_to_matrix)
from low_cost_mocap_tpu_torch.utils import tree


class BodyTrackState(NamedTuple):
    pos: torch.Tensor      # (I, 3)
    vel: torch.Tensor      # (I, 3)
    quat: torch.Tensor     # (I, 4) body->world (w, x, y, z)
    active: torch.Tensor   # (I,) bool
    missed: torch.Tensor   # (I,) int32 consecutive missed frames


class TrackedBodies(NamedTuple):
    pos: torch.Tensor      # (I, 3) filtered positions
    vel: torch.Tensor      # (I, 3)
    quat: torch.Tensor     # (I, 4)
    valid: torch.Tensor    # (I,)


def init_state(max_bodies: int, device=None) -> BodyTrackState:
    """Empty track slots on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    I = max_bodies
    q0 = torch.zeros((I, 4), dtype=torch.float32, device=dev)
    q0[:, 0] = 1.0
    return BodyTrackState(
        pos=torch.zeros((I, 3), dtype=torch.float32, device=dev),
        vel=torch.zeros((I, 3), dtype=torch.float32, device=dev),
        quat=q0,
        active=torch.zeros((I,), dtype=torch.bool, device=dev),
        missed=torch.zeros((I,), dtype=torch.int32, device=dev),
    )


def rot_to_quat(R):
    """(..., 3, 3) rotation -> (..., 4) unit quaternion (w, x, y, z)."""
    return matrix_to_quat(R)


def quat_to_rot(q):
    """(..., 4) unit quaternion -> (..., 3, 3) rotation."""
    return quat_to_matrix(q)


def update(state: BodyTrackState, fit_t, fit_R, fit_rms, fit_valid, dt, *,
           gate_m: float = 0.15, rms_max: float = 0.02,
           max_missed: int = 8, pos_gain: float = 0.6,
           vel_gain: float = 0.4, quat_gain: float = 0.5,
           return_meas: bool = False):
    """One tracker step over a frame's body fits.

    fit_t: (F, 3); fit_R: (F, 3, 3); fit_rms/fit_valid: (F,) — one frame
    of ``rigid_general.locate_bodies``.  Tracks match fits inside a
    ``gate_m`` radius of their prediction; unmatched fits seed tracks in
    inactive slots; tracks coast for up to ``max_missed`` frames.  Returns
    (new_state, TrackedBodies), with ``return_meas`` also each slot's
    associated raw measurement (pos, quat, ok).
    """
    dev = state.pos.device
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    I = state.pos.shape[0]
    F = fit_t.shape[0]
    meas_ok = fit_valid & (fit_rms < rms_max)
    meas_q = rot_to_quat(fit_R)

    pred_pos = state.pos + state.vel * dt
    d = torch.linalg.vector_norm(pred_pos[:, None, :] - fit_t[None, :, :],
                                 dim=-1)
    d = torch.where(meas_ok[None, :], d, float("inf"))          # (I, F)

    if max(I, F) <= 8:
        # globally optimal track<->fit matching; the unmatchable cost must
        # dominate any real total (S * gate_m) and stay small enough that
        # float32 totals keep sub-0.1 mm resolution
        S = max(I, F)
        BIG = max(64.0, 8.0 * S * gate_m)
        cost = torch.full((S, S), BIG, dtype=d.dtype, device=dev)
        cost[:I, :F] = torch.where(torch.isfinite(d) & state.active[:, None]
                                   & (d < gate_m), d, BIG)
        col, _ = assign(cost)
        col = col[:I]
        ok = state.active & (col < F) & (
            cost[torch.arange(I, device=dev), col] < gate_m)
        match_idx = torch.where(ok, col, -1).to(torch.int32)
        # unmatched slots go to a spare column F, which is then cut off
        claimed = torch.zeros(F + 1, dtype=torch.bool, device=dev).index_fill_(
            0, torch.where(ok, col, F), True)[:F]
    else:
        # greedy association, active tracks first (statically unrolled)
        ar = torch.arange(F, device=dev)
        claimed = torch.zeros((F,), dtype=torch.bool, device=dev)
        idx = []
        for i in range(I):
            di = torch.where(claimed, float("inf"), d[i])
            j = torch.argmin(di).reshape(1)     # (1,): no host read
            ok = state.active[i] & (di[j][0] < gate_m)
            idx.append(torch.where(ok, j[0], -1))
            claimed = claimed | ((ar == j) & ok)
        match_idx = torch.stack(idx).to(torch.int32)

    matched = match_idx >= 0
    j_safe = torch.clamp_min(match_idx, 0).to(torch.int64)
    meas_pos = fit_t[j_safe]                             # (I, 3)
    meas_quat = meas_q[j_safe]

    # alpha-beta update on position/velocity
    resid = meas_pos - pred_pos
    new_pos = torch.where(matched[:, None],
                          pred_pos + pos_gain * resid, pred_pos)
    new_vel = torch.where(matched[:, None],
                          state.vel + vel_gain * resid
                          / torch.clamp_min(dt, 1e-4), state.vel)
    # sign-aligned quaternion low-pass (q and -q are the same rotation)
    sign = torch.sign((meas_quat * state.quat).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, 1.0, sign)
    q_mix = state.quat + quat_gain * (sign * meas_quat - state.quat)
    q_mix = q_mix / torch.clamp_min(
        torch.linalg.vector_norm(q_mix, dim=-1, keepdim=True), 1e-12)
    new_quat = torch.where(matched[:, None], q_mix, state.quat)

    new_missed = torch.where(matched, 0, state.missed + 1).to(torch.int32)
    still_active = state.active & (new_missed <= max_missed)

    # spawn unclaimed valid fits into inactive slots (statically unrolled)
    free = ~still_active
    spawnable = meas_ok & ~claimed
    ar = torch.arange(F, device=dev)
    rows = {k: list(v.unbind(0)) for k, v in (
        ("pos", new_pos), ("vel", new_vel), ("quat", new_quat),
        ("active", still_active), ("missed", new_missed))}
    for i in range(I):
        # a (1,) index: indexing with a 0-d one reads it back to the host
        j = torch.argmax(spawnable.to(torch.uint8)).reshape(1)
        do = free[i] & spawnable.any()
        rows["pos"][i] = torch.where(do, fit_t[j][0], rows["pos"][i])
        rows["vel"][i] = torch.where(do, 0.0, rows["vel"][i])
        rows["quat"][i] = torch.where(do, meas_q[j][0], rows["quat"][i])
        rows["active"][i] = rows["active"][i] | do
        rows["missed"][i] = torch.where(do, 0, rows["missed"][i]).to(
            torch.int32)
        spawnable = spawnable & ~((ar == j) & do)
    pos_s, vel_s, quat_s, active_s, missed_s = (
        torch.stack(rows[k]) for k in ("pos", "vel", "quat", "active",
                                       "missed"))

    new_state = BodyTrackState(pos=pos_s, vel=vel_s, quat=quat_s,
                               active=active_s, missed=missed_s)
    tracked = TrackedBodies(pos=pos_s, vel=vel_s, quat=quat_s,
                            valid=active_s)
    if return_meas:
        # the associated raw measurement per slot (offline smoothing
        # input); a spawned slot's first fit counts as its measurement too
        spawn_meas = active_s & (~state.active) & ~matched
        # which fit seeded each spawned slot: the nearest fit to pos_s
        d_sp = torch.linalg.vector_norm(pos_s[:, None, :] - fit_t[None, :, :],
                                        dim=-1)
        j_sp = torch.argmin(torch.where(meas_ok[None, :], d_sp,
                                        float("inf")), dim=1)
        m_ok = matched | spawn_meas
        m_pos = torch.where(matched[:, None], meas_pos, fit_t[j_sp])
        m_quat = torch.where(matched[:, None], meas_quat, meas_q[j_sp])
        return new_state, (tracked, (m_pos, m_quat, m_ok))
    return new_state, tracked


# ---------------------------------------------------------------------------
# Offline fixed-interval smoothing of 6-DoF body tracks
# ---------------------------------------------------------------------------


class SmoothedBodies(NamedTuple):
    pos: torch.Tensor    # (T, I, 3) smoothed positions
    vel: torch.Tensor    # (T, I, 3)
    quat: torch.Tensor   # (T, I, 4) sign-aligned, gap-SLERPed
    valid: torch.Tensor  # (T, I) inside the track's [first, last] sighting


def _F6(dt, dtype, device):
    F = torch.eye(6, dtype=dtype, device=device)
    F[:3, 3:] = dt * torch.eye(3, dtype=dtype, device=device)
    return F


@functools.cache
def _cv_constants(device: torch.device, dtype, meas_noise: float):
    """(I6, H = [I3 | 0], R = meas_noise I3) of the constant-velocity
    filter on ``device``, made once rather than at every frame.  Kept for
    the life of the process: a captured graph reads them by address."""
    H = torch.cat([torch.eye(3, dtype=dtype, device=device),
                   torch.zeros((3, 3), dtype=dtype, device=device)], dim=1)
    R = torch.eye(3, dtype=dtype, device=device) * meas_noise
    return torch.eye(6, dtype=dtype, device=device), H, R


@functools.cache
def _cv_process(device: torch.device, dtype, process_noise: float):
    """Q = process_noise I6 on ``device``, kept as ``_cv_constants``."""
    return torch.eye(6, dtype=dtype, device=device) * process_noise


def _cv_forward_step(carry, zt, okt, dt, *, process_noise, meas_noise):
    """One frame of the constant-velocity filter: carry (x, P, inited)
    -> the same after the frame, as both the carry and the output."""
    x, P, inited = carry
    dtype, dev = zt.dtype, zt.device
    I6, H, R = _cv_constants(dev, dtype, float(meas_noise))
    Q = _cv_process(dev, dtype, float(process_noise))
    F = _F6(dt, dtype, dev)
    x_pre = torch.einsum("ij,oj->oi", F, x)
    P_pre = torch.einsum("ij,ojk,lk->oil", F, P, F) + Q
    need = okt & ~inited
    x_pre = torch.where(need[:, None],
                        torch.cat([zt, torch.zeros_like(zt)], -1), x_pre)
    P_pre = torch.where(need[:, None, None], I6, P_pre)
    inited2 = inited | okt
    S = torch.einsum("ij,ojk,lk->oil", H, P_pre, H) + R
    # inv_ex: no check that reads the result back to the host
    K = torch.einsum("oij,kj,okl->oil", P_pre, H,
                     torch.linalg.inv_ex(S).inverse)
    resid = zt - torch.einsum("ij,oj->oi", H, x_pre)
    x_post = x_pre + torch.einsum("oij,oj->oi", K, resid)
    P_post = P_pre - torch.einsum("oij,jk,okl->oil", K, H, P_pre)
    x_new = torch.where(okt[:, None], x_post, x_pre)
    P_new = torch.where(okt[:, None, None], P_post, P_pre)
    # uninitialised slots stay frozen
    x = torch.where(inited2[:, None], x_new, x)
    P = torch.where(inited2[:, None, None], P_new, P)
    return (x, P, inited2), (x, P, inited2)


def _cv_forward(z, ok, dts, process_noise, meas_noise, scan=tree.scan):
    """Per-slot constant-velocity Kalman filter, one predict per frame.

    z: (T, I, 3) associated measurements; ok: (T, I); dts: (T,).
    Returns (xs (T, I, 6), Ps (T, I, 6, 6), inited (T, I)).
    """
    dtype, dev = z.dtype, z.device
    n_slots = z.shape[1]
    carry = (torch.zeros((n_slots, 6), dtype=dtype, device=dev),
             torch.eye(6, dtype=dtype, device=dev).repeat(n_slots, 1, 1),
             torch.zeros((n_slots,), dtype=torch.bool, device=dev))
    return scan(functools.partial(_cv_forward_step,
                                  process_noise=process_noise,
                                  meas_noise=meas_noise),
                carry, z, ok, dts)[1]


def _cv_rts_step(carry, x_k, P_k, dt, *, process_noise):
    """One step of the constant-velocity RTS recursion, k+1 -> k (``dt``
    the interval after frame k)."""
    x_s, P_s = carry
    dtype, dev = x_k.dtype, x_k.device
    Q = _cv_process(dev, dtype, float(process_noise))
    F = _F6(dt, dtype, dev)
    x_pred = torch.einsum("ij,oj->oi", F, x_k)
    P_pred = torch.einsum("ij,ojk,lk->oil", F, P_k, F) + Q
    C = torch.einsum("oij,kj,okl->oil", P_k, F,
                     torch.linalg.inv_ex(P_pred).inverse)
    x_s = x_k + torch.einsum("oij,oj->oi", C, x_s - x_pred)
    P_s = P_k + torch.einsum("oij,ojk,olk->oil", C, P_s - P_pred, C)
    return (x_s, P_s), (x_s, P_s)


def _cv_rts(xs, Ps, dts, process_noise, scan=tree.scan):
    """RTS backward pass for the constant-velocity model."""
    if xs.shape[0] < 2:
        return xs, Ps
    _, (x_s, P_s) = scan(functools.partial(_cv_rts_step,
                                           process_noise=process_noise),
                         (xs[-1], Ps[-1]), xs[:-1], Ps[:-1], dts[1:],
                         reverse=True)
    return torch.cat([x_s, xs[-1:]]), torch.cat([P_s, Ps[-1:]])


def _slerp(q0, q1, w):
    """Batched SLERP with sign alignment; w broadcastable to (..., 1)."""
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), 0.0, 1.0)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    small = sin_t < 1e-5
    safe = torch.where(small, 1.0, sin_t)
    s0 = torch.where(small, 1.0 - w, torch.sin((1.0 - w) * theta) / safe)
    s1 = torch.where(small, w, torch.sin(w * theta) / safe)
    q = s0 * q0 + s1 * q1
    return q / torch.clamp_min(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)


def _align_step(carry, q, okt):
    """Sign alignment along time (q and -q are the same rotation): the
    frame's quaternion, flipped towards the carried one where measured."""
    s = torch.sign((q * carry).sum(-1, keepdim=True))
    s = torch.where(s == 0, 1.0, s)
    carry = torch.where(okt[:, None], s * q, carry)
    return carry, carry


def _quat_gap_interp(quats, ok, scan=tree.scan):
    """Per-slot time interpolation of measured quaternions: each frame's
    orientation is the SLERP between its nearest measured neighbours
    (clamped at the edges).  quats: (T, I, 4); ok: (T, I)."""
    T = quats.shape[0]
    dev = quats.device
    _, qa = scan(_align_step, quats[0], quats, ok)

    idx = torch.arange(T, device=dev)[:, None]                      # (T, 1)
    prev = torch.cummax(torch.where(ok, idx, -1), dim=0).values     # (T, I)
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(ok, idx, T), [0]),
                                  dim=0).values, [0])
    prev_c = torch.clamp(prev, 0, T - 1)
    nxt_c = torch.clamp(nxt, 0, T - 1)
    q_prev = torch.gather(qa, 0, prev_c[..., None].expand(*prev_c.shape, 4))
    q_next = torch.gather(qa, 0, nxt_c[..., None].expand(*nxt_c.shape, 4))
    has_prev = prev >= 0
    has_next = nxt <= T - 1
    q_prev = torch.where(has_prev[..., None], q_prev, q_next)
    q_next = torch.where(has_next[..., None], q_next, q_prev)
    span = torch.clamp_min((nxt_c - prev_c).to(quats.dtype), 1.0)
    w = torch.where(has_prev & has_next,
                    (idx - prev_c).to(quats.dtype) / span, 0.0)
    return _slerp(q_prev, q_next, w[..., None])


def _associate_step(state, fit_t, fit_R, fit_rms, fit_valid, dt, **kw):
    """One frame of the smoother's association: (state, the slots'
    associated measurements (pos, quat, ok))."""
    state, (_, m) = update(state, fit_t, fit_R, fit_rms, fit_valid, dt,
                           return_meas=True, **kw)
    return state, m


def smooth_body_sequence(fit_t, fit_R, fit_rms, fit_valid, dts,
                         max_bodies: int, *, process_noise: float = 1e-2,
                         meas_noise: float = 1e-4, gate_m: float = 0.15,
                         rms_max: float = 0.02, max_missed: int = 30,
                         scan=tree.scan) -> SmoothedBodies:
    """Offline fixed-interval smoothing of 6-DoF body tracks.

    fit_*: (T, F, ...) per-frame ``locate_bodies`` outputs over a
    recording; dts: (T,).  The causal tracker associates fits to
    ``max_bodies`` slots (``max_missed`` high: offline, coasting through an
    occlusion beats spawning a new slot); a constant-velocity Kalman
    forward and RTS backward pass smooth the associated positions; SLERP
    between the nearest measured orientations fills each frame.  ``valid``
    marks frames within a track's [first, last] sighting.  ``scan``: the
    runner of its four loops (``utils.tree.scan``'s signature).
    """
    dev = fit_t.device
    _, (m_pos, m_quat, m_ok) = scan(
        functools.partial(_associate_step, gate_m=gate_m, rms_max=rms_max,
                          max_missed=max_missed),
        init_state(max_bodies, device=dev), fit_t, fit_R, fit_rms,
        fit_valid, dts)

    m_pos = torch.where(m_ok[..., None], m_pos, 0.0)
    xs, Ps, inited = _cv_forward(m_pos, m_ok, dts, process_noise,
                                 meas_noise, scan)
    xs_s, _ = _cv_rts(xs, Ps, dts, process_noise, scan)
    quat_s = _quat_gap_interp(m_quat, m_ok, scan)

    seen_fwd = inited                                   # first sighting on
    seen_bwd = torch.flip(torch.cumsum(torch.flip(m_ok, [0]).to(torch.int32),
                                       dim=0), [0]) > 0
    valid = seen_fwd & seen_bwd
    return SmoothedBodies(
        pos=torch.where(valid[..., None], xs_s[..., :3], 0.0),
        vel=torch.where(valid[..., None], xs_s[..., 3:], 0.0),
        quat=quat_s,
        valid=valid)
