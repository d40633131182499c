"""Batched constant-acceleration Kalman bank + low-pass post-filtering.

Counterpart of ``low_cost_mocap_tpu/ops/kalman.py``: ``update`` (the O
objects are one batch axis; the JAX package vmaps them), the offline
filter ``track_sequence`` and the fixed-interval Rauch-Tung-Striebel
smoothers ``rts_smooth`` (the gains of every step at once, then a backward
sweep) and ``rts_smooth_assoc`` (the same recursion as affine maps
composed by a log-depth scan), with ``smooth_sequence`` running a forward
pass and the smoother.  The smoothers take their loop runner (``scan``,
``utils.tree.scan`` by default), so the offline path can run each loop as
a replayed graph, and ``smooth_sequence`` takes both passes as runners too
(``forward_filter`` and ``rts_smooth`` by default; the offline path passes
``kalman_cuda.forward_scan``, one kernel launch on the card, and
``kalman_cuda.backward_scan``, two).  ``rts_smooth`` is the plain version
of the backward kernels: the same float32 operations in the same order.

``update`` is the plain PyTorch version of the bank kernel
(``ops/kalman_cuda.py``, ``csrc/kalman_bank.cu``) on the serving options
(``report`` "pre"/"post", no advance on a miss, no covariance output) and
on the smoother's forward options (``advance_on_miss``, ``return_cov``,
``report="post"``: ``forward_filter``), which the kernel runs as another
instantiation: it performs the same float32 operations in the same order,
so on the card the two agree bitwise.  The squared association distance is
written out as ``(dx*dx + dy*dy) + dz*dz`` for that reason, instead of a
reduction whose order the library chooses.

Model: 9-state [pos, vel, acc] constant-acceleration filter, 6-dim
[pos, vel] measurement (H = [I6 | 0], R = meas_noise I), Q = process_noise
I; lazy init from the lowest-slot candidate; nearest-candidate
association; velocity measured over the time since the object's last
detection and re-seeded after ``gap_reset_s``; six sequential scalar
updates; a long-gap state re-seed; order-5 Butterworth on heading and
velocity; state committed only on frames with a detection (or, with
``advance_on_miss``, the prediction committed through a gap).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.ops import lowpass
from low_cost_mocap_tpu_torch.utils import tree


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


@functools.cache
def _constants(device: torch.device, dtype, meas_noise: float):
    """(r, b, a) on ``device``: the measurement noise and the Butterworth
    coefficients, uploaded once a device, so that no step uploads (a CUDA
    graph cannot hold an upload from pageable memory).  Kept for the life
    of the process: a captured graph reads them by address."""
    b_np, a_np = lowpass.butter_coeffs()
    return (torch.tensor(meas_noise, dtype=dtype, device=device),
            torch.from_numpy(b_np).to(device), torch.from_numpy(a_np).to(device))


@functools.cache
def _process(device: torch.device, dtype, process_noise: float):
    """(Q, I9) on ``device``: the process noise ``process_noise * I9`` and
    the identity, made once a device rather than at every frame; kept as
    ``_constants`` is."""
    eye = torch.eye(9, dtype=dtype, device=device)
    return eye * process_noise, eye


def _f_along(m, dt, hdt2, dim):
    """The CA-model transition applied along ``dim`` of ``m`` (9 long
    there) as slice arithmetic: F @ m on rows, m @ F' on columns."""
    a, b, c = m.split(3, dim=dim)
    return torch.cat([(a + dt * b) + hdt2 * c, b + dt * c, c], dim=dim)


def update(state: KalmanState, cand_pos, cand_heading, cand_index,
           cand_valid, dt, *, process_noise: float = 1e-2,
           meas_noise: float = 1.0, gap_reset_s: float = 0.5,
           report: str = "pre", advance_on_miss: bool = False,
           return_cov: bool = False):
    """One tracking step for the whole bank.

    cand_*: (M,) candidates from ``ops.rigid.locate_objects`` (pos (M, 3),
    heading (M,), index (M,) int, valid (M,) bool); dt: float32 0-d tensor
    or float.  Returns (new_state, TrackedObjects).

    ``advance_on_miss``: an initialised object without a detection commits
    its prediction, so every frame carries one predict(dt) step (the
    smoother's precondition).  ``return_cov``: return (new_state,
    (TrackedObjects, committed x (O, 9), committed P (O, 9, 9))).
    """
    if report not in ("pre", "post"):
        raise ValueError(f"report must be 'pre' or 'post', got {report!r}")
    x, P, inited, prev_pos, lh, lv, age = state
    O = x.shape[0]
    dev, dtype = x.device, x.dtype
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    Q, eye9 = _process(dev, dtype, float(process_noise))
    r, b, a = _constants(dev, dtype, float(meas_noise))

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
    x_pre = _f_along(x, dt, hdt2, 1)
    # (F @ P) @ F^T + Q
    P_pre = _f_along(_f_along(P, dt, hdt2, 1), dt, hdt2, 2) + Q

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
    P_post = torch.where(reseed_all[:, None, None], eye9, P_post)

    x_rep = x_pre if report == "pre" else x_post
    x_rep = torch.where(reseed_all[:, None], x_post, x_rep)
    lh2, heading_f = lowpass.lpf_step(lh, cand_heading[ci], b, a)
    lv2, vel_f = lowpass.lpf_step(lv, x_rep[:, 3:6], b, a)

    # commit only when the object had a detection
    def upd(new, old):
        return torch.where(any_mine.reshape((O,) + (1,) * (new.dim() - 1)),
                           new, old)

    if advance_on_miss:
        x_new = torch.where(any_mine[:, None], x_post,
                            torch.where(inited[:, None], x_pre, x))
        P_new = torch.where(any_mine[:, None, None], P_post,
                            torch.where(inited[:, None, None], P_pre, P))
    else:
        x_new, P_new = upd(x_post, x), upd(P_post, P)
    new_state = KalmanState(
        x=x_new,
        P=P_new,
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
    if return_cov:
        return new_state, (tracked, new_state.x, new_state.P)
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
    return state, tree.stack(outs)


def track_sequence(state: KalmanState, cand_pos_seq, cand_heading_seq,
                   cand_index_seq, cand_valid_seq, dts, **kw):
    """Offline filtering of a recorded sequence: ``update`` over (T, M,
    ...) candidates and (T,) dts with ``update``'s options; returns (final
    state, the per-step outputs stacked along T)."""
    return update_scan(state, cand_pos_seq, cand_heading_seq, cand_index_seq,
                       cand_valid_seq, dts, **kw)


def _transition(dt):
    """The CA model's F(dt) as (..., 9, 9) for dt of shape (...)."""
    dt = torch.as_tensor(dt)
    eye3 = torch.eye(3, dtype=dt.dtype, device=dt.device)
    F = torch.eye(9, dtype=dt.dtype, device=dt.device).repeat(
        *dt.shape, 1, 1)
    d = dt[..., None, None]
    F[..., 0:3, 3:6] = d * eye3
    F[..., 3:6, 6:9] = d * eye3
    F[..., 0:3, 6:9] = 0.5 * d * d * eye3
    return F


def _rts_gains(xs, Ps, dts, *, process_noise: float):
    """The backward pass's first phase, every step k = 0 .. T-2 at once
    (nothing in it depends on the smoothed carry): x_pred = F x_k, P_pred =
    F P_k F' + Q and the gain C_k = P_k F' P_pred^-1, with F = F(dts[k+1])
    as slice arithmetic.  C_k comes from a solve, not an inverse: P_pred =
    L U (Doolittle, L unit lower), then row r of C_k solves c P_pred =
    (P_k F')[r], every sum written out in index order.  LU without
    pivoting, which P_pred's positive definiteness makes stable, and not
    Cholesky: the filtered covariances are symmetric only to rounding, and
    a factor read from one triangle solves another system, which moves the
    smoothed states past the JAX package's tolerance after a long
    interval.  The ``kalman_bank_rts_gains`` kernel performs these float32
    operations in this order.  Returns (C, x_pred, P_pred) with leading
    (T-1, O)."""
    Q = _process(xs.device, xs.dtype, float(process_noise))[0]
    dt = dts[1:, None, None]
    hdt2 = 0.5 * dt * dt
    x, P, dt4, hdt4 = xs[:-1], Ps[:-1], dt[..., None], hdt2[..., None]
    x_pred = _f_along(x, dt, hdt2, -1)
    A = _f_along(_f_along(P, dt4, hdt4, -2), dt4, hdt4, -1) + Q
    G = _f_along(P, dt4, hdt4, -1)                            # P_k F'
    # U[j]: row j of U from the diagonal on; L[j]: column j of L below it
    U, L = [], []
    for j in range(9):
        u, l = A[..., j, j:], A[..., j + 1:, j]
        for k in range(j):
            u = u - L[k][..., j - k - 1:j - k] * U[k][..., j - k:]
            l = l - L[k][..., j - k:] * U[k][..., j - k:j - k + 1]
        U.append(u)
        L.append(l / u[..., :1])
    # all nine rows of C at once: w U = G[r], then c L = w
    w = []
    for m in range(9):
        t = G[..., m]
        for k in range(m):
            t = t - w[k] * U[k][..., m - k:m - k + 1]
        w.append(t / U[m][..., :1])
    c = [None] * 9
    for m in range(8, -1, -1):
        t = w[m]
        for k in range(m + 1, 9):
            t = t - c[k] * L[m][..., k - m - 1:k - m]
        c[m] = t
    return torch.stack(c, dim=-1), x_pred, A


def _rts_step(carry, x_k, P_k, C, x_pred, P_pred):
    """One step of the backward sweep with its gain from ``_rts_gains``:
    (x_s, P_s) at k+1 -> at k, as both the carry and the output.  x_s[k] =
    x_k + C (x_s[k+1] - x_pred); P_s[k] = P_k + (C (P_s[k+1] - P_pred)) C',
    each sum written out in index order, as the ``kalman_bank_rts_sweep``
    kernel computes it."""
    x_s, P_s = carry
    dx = x_s - x_pred
    acc = C[..., 0] * dx[..., 0:1]
    for j in range(1, 9):
        acc = acc + C[..., j] * dx[..., j:j + 1]
    x_s = x_k + acc
    D = P_s - P_pred
    U = C[..., 0:1] * D[..., 0:1, :]                          # C D
    for j in range(1, 9):
        U = U + C[..., j:j + 1] * D[..., j:j + 1, :]
    acc = U[..., 0:1] * C[..., None, :, 0]                    # (C D) C'
    for m in range(1, 9):
        acc = acc + U[..., m:m + 1] * C[..., None, :, m]
    P_s = P_k + acc
    return (x_s, P_s), (x_s, P_s)


def rts_smooth(xs, Ps, dts, *, process_noise: float = 1e-2,
               scan=tree.scan):
    """Fixed-interval Rauch-Tung-Striebel smoother over filtered states.

    xs: (T, O, 9) filtered means, Ps: (T, O, 9, 9) filtered covariances,
    from a forward pass that made one predict(dts[k]) a frame
    (``advance_on_miss=True``, ``return_cov=True``); dts[k] is the interval
    between frames k-1 and k.  Returns (xs_smooth, Ps_smooth), the last
    frame the filtered one.  Two phases, batched over the objects: the
    gains C_k = P_k F' P_pred^-1 (P_pred = F P_k F' + Q), which do not
    depend on the carry, for every k at once (``_rts_gains``); then the
    sweep k = T-2 .. 0: x_s[k] = x[k] + C_k (x_s[k+1] - F x[k]), P_s[k] =
    P_k + C_k (P_s[k+1] - P_pred) C_k' (``_rts_step``).  ``scan``: the
    sweep's loop runner, ``utils.tree.scan``'s signature (the offline path
    passes a compiled one).  The plain version of
    ``kalman_cuda.backward_scan``: the same float32 operations in the same
    order.
    """
    if xs.shape[0] < 2:
        return xs, Ps
    gains = _rts_gains(xs, Ps, dts, process_noise=process_noise)
    _, (x_s, P_s) = scan(_rts_step, (xs[-1], Ps[-1]), xs[:-1], Ps[:-1],
                         *gains, reverse=True)
    return torch.cat([x_s, xs[-1:]]), torch.cat([P_s, Ps[-1:]])


def rts_elements(xs, Ps, dts, *, process_noise: float = 1e-2):
    """The backward recursion's affine maps a_k, k = 0 .. T-2, as (E, g, L)
    with leading (T-1, O): x_s[k] = E_k x_s[k+1] + g_k (noise L_k), with
    E_k = C_k, g_k = x[k] - C_k F_k x[k], L_k = P_k - C_k P_pred C_k'
    (``rts_smooth``'s quantities; dts[k] is the interval before frame
    k)."""
    Q = torch.eye(9, dtype=xs.dtype, device=xs.device) * process_noise
    F = _transition(dts[1:])                                  # (T-1, 9, 9)
    x_pred = torch.einsum("tij,toj->toi", F, xs[:-1])
    P_pred = torch.einsum("tij,tojk,tlk->toil", F, Ps[:-1], F) + Q
    # inv_ex: no check that reads the result back to the host
    C = torch.einsum("toij,tkj,tokl->toil", Ps[:-1], F,
                     torch.linalg.inv_ex(P_pred).inverse)
    g = xs[:-1] - torch.einsum("toij,toj->toi", C, x_pred)
    L = Ps[:-1] - torch.einsum("toij,tojk,tolk->toil", C, P_pred, C)
    return C, g, L


def compose_maps(a, b):
    """a o b of two (E, g, L) affine maps with leading (t, O): the earlier
    map ``a`` outermost, (a o b)(x) = a(b(x))."""
    Ea, ga, La = a
    Eb, gb, Lb = b
    return (torch.einsum("toij,tojk->toik", Ea, Eb),
            torch.einsum("toij,toj->toi", Ea, gb) + ga,
            torch.einsum("toij,tojk,tolk->toil", Ea, Lb, Ea) + La)


def suffix_compose(E, g, L):
    """Every suffix composition a_k o ... o a_{n-1} of n maps, in
    ceil(log2 n) rounds of batched products (a Hillis-Steele scan)."""
    n, step = E.shape[0], 1
    while step < n:
        # element t composes with the suffix starting at t + step
        c = compose_maps((E[:-step], g[:-step], L[:-step]),
                         (E[step:], g[step:], L[step:]))
        E, g, L = (torch.cat([x, y[-step:]]) for x, y in zip(c, (E, g, L)))
        step *= 2
    return E, g, L


def rts_smooth_assoc(xs, Ps, dts, *, process_noise: float = 1e-2):
    """``rts_smooth`` in log depth (Sarkka and Garcia-Fernandez, IEEE TAC
    2021).  The backward recursion applies per-step affine maps
    (``rts_elements``); composition is associative, so every suffix
    composition a_k o ... o a_{T-2} comes from ``suffix_compose``.  Equal
    to ``rts_smooth`` to float precision."""
    E, g, L = suffix_compose(*rts_elements(xs, Ps, dts,
                                           process_noise=process_noise))
    xs_s = torch.einsum("toij,oj->toi", E, xs[-1]) + g
    Ps_s = torch.einsum("toij,ojk,tolk->toil", E, Ps[-1], E) + L
    return (torch.cat([xs_s, xs[-1:]]), torch.cat([Ps_s, Ps[-1:]]))


def _forward_step(state, cand_pos, cand_heading, cand_index, cand_valid,
                  dt, **kw):
    """One frame of the smoother's forward filter: (state, ((tracked, x,
    P), initialised))."""
    state, out = update(state, cand_pos, cand_heading, cand_index,
                        cand_valid, dt, report="post", advance_on_miss=True,
                        return_cov=True, **kw)
    return state, (out, state.initialized)


def forward_filter(state: KalmanState, cand_pos_seq, cand_heading_seq,
                   cand_index_seq, cand_valid_seq, dts, *, scan=tree.scan,
                   **kw):
    """The smoother's forward filter (``_forward_step``) over a recorded
    sequence through the loop runner ``scan``, with ``update``'s noise
    options.  Returns (the final state, None from a runner that returns no
    carry; ((TrackedObjects, committed xs (T, O, 9), Ps (T, O, 9, 9)),
    initialized (T, O)))."""
    return scan(functools.partial(_forward_step, **kw), state, cand_pos_seq,
                cand_heading_seq, cand_index_seq, cand_valid_seq, dts)


def smooth_sequence(state: KalmanState, cand_pos_seq, cand_heading_seq,
                    cand_index_seq, cand_valid_seq, dts, *,
                    process_noise: float = 1e-2, scan=tree.scan,
                    forward=forward_filter, backward=rts_smooth, **kw):
    """Forward filter (``advance_on_miss``, ``report="post"``, covariances
    kept) and the RTS backward pass over a recorded sequence.  Returns
    (TrackedObjects (T, O, ...) of smoothed positions and velocities, the
    forward pass's filtered headings, and ``valid`` = the track is
    initialised — gap frames carry interpolated states; xs_smooth
    (T, O, 9)).  ``scan``: the loop runner of both passes
    (``utils.tree.scan``'s signature); ``forward``: the forward pass,
    ``forward_filter``'s signature, which gets ``scan``; ``backward``: the
    backward pass, ``rts_smooth``'s signature, which gets it too."""
    _, ((tracked, xs, Ps), inited) = forward(
        state, cand_pos_seq, cand_heading_seq, cand_index_seq,
        cand_valid_seq, dts, process_noise=process_noise, scan=scan, **kw)
    xs_s, _ = backward(xs, Ps, dts, process_noise=process_noise,
                       scan=scan)
    smoothed = TrackedObjects(
        pos=torch.where(inited[..., None], xs_s[..., :3], 0.0),
        vel=torch.where(inited[..., None], xs_s[..., 3:6], 0.0),
        heading=tracked.heading,
        valid=inited)
    return smoothed, xs_s
