"""Frozen copy of ``low_cost_mocap_tpu_torch/ops/correspond.py`` (commit
9b1e9ac), its imports made relative; the benchmark's reference runs it
op by op and never imports the program.

Cross-view correspondence: epipolar gating + hypothesis scoring.

Counterpart of ``low_cost_mocap_tpu/ops/correspond.py`` in its three modes.
Roots are camera 0's points and every later point that is no earlier
root's nearest gated candidate.  Exact mode (up to five cameras) enumerates,
per root and later camera, the ``max_candidates`` nearest gated candidates
plus a "missing" option, triangulates every (root, hypothesis) in one
batched DLT and keeps the minimum selection score per root; a camera-0 root
whose winner duplicates a better camera-0 winner re-selects its best
qualifying non-duplicate hypothesis.  Beam mode grows those hypotheses one
camera at a time and keeps the best ``beam_width``.  Assoc mode (large
rigs) seeds each root from its best gated pair and converges by reproject,
associate, re-triangulate.  A ghost dedupe pass then drops points that a
better point already explains.

Every function here takes an explicit leading batch axis of frames
(``(B, C, K, ...)``), so batched serving and the per-frame step (B = 1) run
the same code.

Ties: ``jax.lax.top_k`` returns the lowest index first among equal values,
and most gated distances and dead beam partials are +inf, so ties are the
common case.  ``torch.topk`` promises no order among ties, so candidates
and beam survivors come from stable ascending sorts instead.
``torch.argmin``/``argmax`` return the first extremum, as JAX's do.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from . import epipolar as epi
from . import triangulate as tri

_INF = float("inf")


def _pairwise_fundamentals(Ps):
    """F[a, b]: lines in image b for points in image a.  (C, C, 3, 3)."""
    C = Ps.shape[0]
    Pa = Ps[:, None].expand(C, C, 3, 4)
    Pb = Ps[None, :].expand(C, C, 3, 4)
    return epi.fundamental_from_projections(Pa, Pb)


def _epipolar_distances(pts, valid, gate_px, Fs):
    """d[z, a, k, b, j] = distance of point (b, j) to the epiline of point
    (a, k) in frame z.  Returns (d, gated), both (B, C, K, C, K)."""
    C = pts.shape[1]
    # the products written out (no matmul, whose summation order would
    # change with the batch size on the card)
    p = pts[:, :, :, None, None, :]                                # (B,C,K,1,1,2)
    F = Fs[None, :, None]                                          # (1,C,1,C,3,3)
    lines = F[..., 0] * p[..., 0] + F[..., 1] * p[..., 1] + F[..., 2]
    n = torch.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    lines = lines / torch.clamp_min(n[..., None], 1e-12)           # (B,C,K,C,3)
    q = pts[:, None, None]                                         # (B,1,1,C,K,2)
    d = torch.abs(lines[..., 0:1] * q[..., 0] + lines[..., 1:2] * q[..., 1]
                  + lines[..., 2:3])                               # (B,C,K,C,K)
    # F[a, a] is built from duplicated projection rows, so the same-camera
    # block is masked explicitly
    same_cam = torch.eye(C, dtype=torch.bool, device=pts.device)[:, None, :, None]
    gated = ((d < gate_px) & ~same_cam
             & valid[:, None, None, :, :] & valid[:, :, :, None, None])
    return d, gated


def _compute_roots(d, gated, valid):
    """(B, C, K) bool: which points seed tracks.  Camera 0's valid points
    always do; a later camera's point does unless it is the closest gated
    candidate of some earlier root."""
    C, K = valid.shape[1:]
    slots = torch.arange(K, device=valid.device)
    root = [valid[:, 0]] + [None] * (C - 1)
    for b in range(1, C):
        claimed = torch.zeros_like(valid[:, 0])
        for a in range(b):
            g = gated[:, a, :, b, :]                                # (B, K, K)
            da = torch.where(g, d[:, a, :, b, :], _INF)
            jstar = torch.argmin(da, dim=-1)                        # (B, K)
            has = g.any(dim=-1) & root[a]
            claim_a = ((jstar[..., None] == slots) & has[..., None]).any(dim=-2)
            claimed = claimed | claim_a
        root[b] = valid[:, b] & ~claimed
    return torch.stack(root, dim=1)


@functools.lru_cache(maxsize=32)
def _combo_table(num_later: int, n_opt: int, h_max: int) -> np.ndarray:
    """(h_max, num_later) table of candidate choices, padded.
    Choice values: 0..n_opt-2 = candidate rank, n_opt-1 = missing."""
    combos = list(itertools.product(range(n_opt), repeat=num_later))
    out = np.full((h_max, max(num_later, 1)), n_opt - 1, dtype=np.int32)
    for i, c in enumerate(combos):
        out[i, : len(c)] = c
    return out


@functools.lru_cache(maxsize=32)
def _hypothesis_tables(C: int, n_opt: int):
    """Ragged hypothesis tables of the all-roots one-hot matcher: hypotheses
    of every root camera flattened into one axis of length
    H = sum_rc n_opt^(C-1-rc), in ``itertools.product`` order per root
    camera.  Returns (onehot (H, C, C, R) f32, use_tab (H, C) bool,
    self_tab (H, C) bool, rc_onehot (C, H) f32, rc_of_h (H,) int32)."""
    R = n_opt - 1
    counts = [n_opt ** (C - 1 - rc) for rc in range(C)]
    H_tot = sum(counts)
    onehot = np.zeros((H_tot, C, C, R), np.float32)
    use_tab = np.zeros((H_tot, C), bool)
    self_tab = np.zeros((H_tot, C), bool)
    rc_of_h = np.zeros((H_tot,), np.int32)
    h0 = 0
    for rc in range(C):
        later = list(range(rc + 1, C))
        n_h = counts[rc]
        combos = _combo_table(len(later), n_opt, n_h)
        sl = slice(h0, h0 + n_h)
        rc_of_h[sl] = rc
        self_tab[sl, rc] = True
        for li, b in enumerate(later):
            choice = combos[:, li]
            miss = choice == n_opt - 1
            use_tab[sl, b] = ~miss
            rank = np.minimum(choice, R - 1)
            onehot[h0 + np.arange(n_h), rc, b, rank] = \
                (~miss).astype(np.float32)
        h0 += n_h
    rc_onehot = np.zeros((C, H_tot), np.float32)
    rc_onehot[rc_of_h, np.arange(H_tot)] = 1.0
    return onehot, use_tab, self_tab, rc_onehot, rc_of_h


@functools.cache
def _hypothesis_tables_on(C: int, n_opt: int, device: torch.device):
    """``_hypothesis_tables`` on ``device``, built once per (C, n_opt,
    device): (onehot, self_tab, msk_tab = self | use, rc_onehot, n_later
    (H,) f32, the later cameras of each hypothesis' root camera).  An
    upload per call would be a host-to-device copy on every served frame,
    which a CUDA graph cannot capture; kept for the life of the process,
    since a captured graph reads them by address."""
    onehot, use_np, self_np, rc_oh, rc_of_h = _hypothesis_tables(C, n_opt)
    n_later = (C - 1 - rc_of_h).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (
        onehot, self_np, self_np | use_np, rc_oh, n_later))


def _take(x, idx):
    """x (B, K, H, ...) at idx (B, K) along axis 2 -> (B, K, ...)."""
    shape = idx.shape + (1,) + x.shape[3:]
    g = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 2, g)[:, :, 0]


def match_points(pts, valid, Ps, gate_px: float = 5.0,
                 max_candidates: int = 2, dedupe_eps: float = 0.02,
                 mode: str = "auto", beam_width: int = 0,
                 miss_penalty_px: float = -1.0, Fs=None,
                 with_obs: bool = False):
    """Full-frame correspondence + triangulation.

    pts: (C, K, 2) or (B, C, K, 2) undistorted blob centroids; valid: the
    matching (C, K) or (B, C, K); Ps: (C, 3, 4).  Returns a dict with
    ``object_points`` (..., C*K, 3), ``errors`` (..., C*K) and ``valid``
    (..., C*K): one output slot per potential root.  ``with_obs`` adds the
    winners' per-camera observations, ``obs`` (..., C*K, C, 2) and
    ``obs_mask`` (..., C*K, C), zero where masked: the correspondence-
    resolved measurements live recalibration refines from.

    ``mode``: "exact" enumerates every candidate combination; "assoc" seeds
    each root from its best gated pair over all cameras and converges by
    two reproject-associate-retriangulate rounds (the large-rig path);
    "beam" grows hypotheses camera by camera, keeping the ``beam_width``
    (default ``(max_candidates + 1)^2``) lowest-scoring partial assemblies;
    "auto" is exact for up to five cameras, else assoc.  Selection scores
    a missing later view as a ``miss_penalty_px`` residual (default, < 0:
    the gate); 0 is the reference's bare mean-error rule.
    """
    if mode == "auto":
        mode = "exact" if pts.shape[-3] <= 5 else "assoc"
    if mode not in ("exact", "assoc", "beam"):
        raise ValueError(f"mode must be auto/exact/assoc/beam: {mode!r}")
    squeeze = pts.dim() == 3
    if squeeze:
        pts, valid = pts[None], valid[None]
    if Fs is None:
        Fs = _pairwise_fundamentals(Ps)
    n_opt = max_candidates + 1
    if beam_width <= 0:
        beam_width = n_opt * n_opt
    if miss_penalty_px < 0:
        miss_penalty_px = gate_px
    tau2 = miss_penalty_px * miss_penalty_px

    d, gated = _epipolar_distances(pts, valid, gate_px, Fs)
    root_mask = _compute_roots(d, gated, valid)
    if mode == "assoc":
        out = _match_assoc(pts, valid, Ps, d, gated, root_mask, gate_px,
                           dedupe_eps, with_obs)
    else:
        # the max_candidates nearest gated candidates per (root, later
        # camera); a stable sort keeps the lowest index first among ties,
        # as top_k does
        d_sorted, order = torch.sort(torch.where(gated, d, _INF), dim=-1,
                                     stable=True)
        cand_idx = order[..., :max_candidates]                  # (B,C,K,C,R)
        cand_valid = torch.isfinite(d_sorted[..., :max_candidates])
        args = (pts, Ps, root_mask, cand_idx, cand_valid, gate_px,
                max_candidates, tau2, dedupe_eps, with_obs)
        out = (_match_exact(*args) if mode == "exact"
               else _match_beam(*args, beam_width))
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return out


def _selection_score(err, n_vis, n_later, tau2):
    """Raw mean squared error with every missing later view counted as a
    ``tau2`` residual."""
    n_miss = torch.clamp_min(n_later - (n_vis - 1.0), 0.0)
    return (err * n_vis + n_miss * tau2) / torch.clamp_min(n_vis + n_miss,
                                                           1.0)


def _match_exact(pts, Ps, root_mask, cand_idx, cand_valid, gate_px,
                 max_candidates, tau2, dedupe_eps, with_obs):
    """Every (root, hypothesis) triangulated in one batched DLT; the
    minimum selection score wins per root.  A camera-0 root whose winner
    duplicates a better camera-0 winner re-selects its best qualifying
    non-duplicate hypothesis before the ghost dedupe."""
    Bz, C, K, _ = pts.shape
    dev, f32 = pts.device, pts.dtype
    n_opt = max_candidates + 1
    # (H, C, C, R), (H, C), (H, C), (C, H), (H,)
    onehot, self_tab, msk_tab, rc_onehot, n_later = _hypothesis_tables_on(
        C, n_opt, dev)
    H = onehot.shape[0]

    # candidate observations: obs_cand[z, a, k, b, r] = pts[z, b, cand_idx]
    zi = torch.arange(Bz, device=dev)[:, None, None, None, None]
    bi = torch.arange(C, device=dev)[None, None, None, :, None]
    obs_cand = pts[zi, bi, cand_idx]                            # (B,C,K,C,R,2)

    # hypothesis selections by one-hot contraction (exact: one nonzero term)
    obs = torch.einsum("habr,zakbrx->zkhbx", onehot, obs_cand)
    cv_miss = torch.einsum("habr,zakbr->zkhb", onehot,
                           (~cand_valid).to(f32))
    self_pts = torch.einsum("ah,zakx->zkhx", rc_onehot, pts)    # (B, K, H, 2)
    sel = torch.where(self_tab[None, None, :, :, None],
                      self_pts[:, :, :, None, :], obs)          # (B,K,H,C,2)
    msk = msk_tab[None, None].expand(Bz, K, H, C)
    ok = cv_miss.sum(dim=-1) < 0.5                              # (B, K, H)

    X, _ = tri.triangulate_points(sel.reshape(-1, C, 2), Ps,
                                  msk.reshape(-1, C))
    err = tri.reprojection_errors(sel.reshape(-1, C, 2), X, Ps,
                                  msk.reshape(-1, C))
    X = X.reshape(Bz, K, H, 3)
    err = torch.where(ok, err.reshape(Bz, K, H), _INF)

    # selection score with the per-root-camera miss penalty
    n_vis = msk.sum(dim=-1).to(f32)                             # (B, K, H)
    score = torch.where(ok, _selection_score(err, n_vis,
                                             n_later[None, None], tau2),
                        _INF)

    # per-root-camera winner over each root camera's contiguous slice
    out_pts, out_err, out_obs, out_om = [], [], [], []
    h0 = 0
    for rc in range(C):
        n_h = n_opt ** (C - 1 - rc)
        best = torch.argmin(score[:, :, h0:h0 + n_h], dim=-1)  # (B, K)
        out_pts.append(_take(X[:, :, h0:h0 + n_h], best))
        out_err.append(_take(err[:, :, h0:h0 + n_h], best))
        if with_obs:
            out_obs.append(_take(sel[:, :, h0:h0 + n_h], best))
            out_om.append(_take(msk[:, :, h0:h0 + n_h], best))
        h0 += n_h
    object_points = torch.cat(out_pts, dim=1)                   # (B, C*K, 3)
    errors = torch.cat(out_err, dim=1)
    obs = torch.cat(out_obs, dim=1) if with_obs else None       # (B,C*K,C,2)
    obs_mask = torch.cat(out_om, dim=1) if with_obs else None   # (B, C*K, C)
    ok = torch.isfinite(errors) & root_mask.reshape(Bz, C * K)
    errors = torch.where(ok, errors, _INF)

    if dedupe_eps > 0:
        # camera-0 re-selection (see the JAX package's inline notes): a
        # camera-0 root killed by a better camera-0 winner falls back to its
        # best hypothesis that is >= 3-view, below the gate and not near any
        # better winner.  The gate on use0 is the raw a_err, as in the JAX
        # package (correspond.py:373).
        N = C * K
        i_idx = torch.arange(N, device=dev)
        eps2 = dedupe_eps ** 2
        btr = (((errors[:, None, :] < errors[:, :, None])
                | ((errors[:, None, :] == errors[:, :, None])
                   & (i_idx[None, :] < i_idx[:, None])))
               & ok[:, None, :])                                # (B, N, N)
        dW = ((object_points[:, :, None] - object_points[:, None]) ** 2
              ).sum(dim=-1)
        clash = (dW < eps2) & btr
        cam0 = i_idx < K
        killed0 = ok & cam0 & (clash & cam0[None, :]).any(dim=-1)  # (B, N)
        H0 = n_opt ** (C - 1)
        near0 = (((X[:, :, :H0, None, :]
                   - object_points[:, None, None]) ** 2).sum(dim=-1)
                 < eps2)                                        # (B,K,H0,N)
        bad0 = (near0 & btr[:, :K, None, :]).any(dim=-1)        # (B, K, H0)
        qual0 = (torch.isfinite(err[:, :, :H0]) & (n_vis[:, :, :H0] >= 3.0)
                 & (err[:, :, :H0] < gate_px * gate_px) & ~bad0)
        s2 = torch.where(qual0, score[:, :, :H0], _INF)
        best2 = torch.argmin(s2, dim=-1)                        # (B, K)
        a_pts = _take(X[:, :, :H0], best2)
        a_err = _take(err[:, :, :H0], best2)
        use0 = killed0[:, :K] & torch.isfinite(a_err)
        use_alt = torch.cat(
            [use0, torch.zeros(Bz, N - K, dtype=torch.bool, device=dev)], 1)
        object_points = torch.where(
            use_alt[..., None],
            torch.cat([a_pts, torch.zeros(Bz, N - K, 3, dtype=f32,
                                          device=dev)], 1),
            object_points)
        errors = torch.where(
            use_alt,
            torch.cat([a_err, torch.full((Bz, N - K), _INF, dtype=f32,
                                         device=dev)], 1),
            errors)
        if with_obs:
            a_obs = _take(sel[:, :, :H0], best2)                # (B, K, C, 2)
            a_om = _take(msk[:, :, :H0], best2)
            obs = torch.where(use_alt[..., None, None],
                              torch.cat([a_obs, torch.zeros_like(obs[:, K:])],
                                        1), obs)
            obs_mask = torch.where(
                use_alt[..., None],
                torch.cat([a_om, torch.zeros_like(obs_mask[:, K:])], 1),
                obs_mask)

    return _finalize(object_points, errors, ok, dedupe_eps, obs, obs_mask)


def _match_beam(pts, Ps, root_mask, cand_idx, cand_valid, gate_px,
                max_candidates, tau2, dedupe_eps, with_obs, beam_width):
    """Per root, hypotheses grow one later camera at a time (each of the
    ``max_candidates`` candidates or "missing"), and the ``beam_width``
    lowest-scoring partial assemblies survive each camera.  Every root of
    one root camera, in every frame, advances together."""
    Bz, C, K, _ = pts.shape
    dev, f32 = pts.device, pts.dtype
    n_opt = max_candidates + 1
    Bw = beam_width
    choice = torch.arange(n_opt, device=dev)
    is_miss = choice == n_opt - 1                               # (n_opt,)
    rank = torch.clamp_max(choice, max_candidates - 1)
    zi = torch.arange(Bz, device=dev)[:, None, None]
    ki = torch.arange(K, device=dev)[None, :, None]
    out_pts, out_err, out_ok, out_obs, out_om = [], [], [], [], []
    for rc in range(C):
        n_later = float(C - rc - 1)
        sel = torch.zeros(Bz, K, Bw, C, 2, dtype=f32, device=dev)
        sel[:, :, :, rc] = pts[:, rc, :, None, :]
        msk = torch.zeros(Bz, K, Bw, C, dtype=torch.bool, device=dev)
        msk[:, :, :, rc] = True
        ok = torch.zeros(Bz, K, Bw, dtype=torch.bool, device=dev)
        ok[:, :, 0] = True                                      # one live seed
        for b in range(rc + 1, C):
            j = cand_idx[:, rc, :, b][:, :, rank]               # (B, K, n_opt)
            cv = cand_valid[:, rc, :, b][:, :, rank]
            sel_e = sel[:, :, :, None].expand(Bz, K, Bw, n_opt, C, 2).clone()
            sel_e[:, :, :, :, b] = pts[:, b][zi, j][:, :, None]
            msk_e = msk[:, :, :, None].expand(Bz, K, Bw, n_opt, C).clone()
            msk_e[:, :, :, :, b] = ~is_miss
            ok_e = ok[..., None] & (is_miss | cv)[:, :, None, :]
            sel_f = sel_e.reshape(Bz, K, Bw * n_opt, C, 2)
            msk_f = msk_e.reshape(Bz, K, Bw * n_opt, C)
            ok_f = ok_e.reshape(Bz, K, Bw * n_opt)
            X, _ = tri.triangulate_points(sel_f.reshape(-1, C, 2), Ps,
                                          msk_f.reshape(-1, C))
            err = tri.reprojection_errors(sel_f.reshape(-1, C, 2), X, Ps,
                                          msk_f.reshape(-1, C))
            err = err.reshape(ok_f.shape)
            n_vis = msk_f.sum(dim=-1)
            # partials with < 2 views rank at zero raw error
            err = torch.where(n_vis >= 2, err, 0.0)
            score = torch.where(
                ok_f, _selection_score(err, n_vis.to(f32), n_later, tau2),
                _INF)
            # top_k(-score)'s order: ascending, lowest index first in ties
            keep = torch.sort(score, dim=-1, stable=True)[1][..., :Bw]
            sel = sel_f[zi, ki, keep]
            msk = msk_f[zi, ki, keep]
            ok = ok_f[zi, ki, keep]
        X, _ = tri.triangulate_points(sel.reshape(-1, C, 2), Ps,
                                      msk.reshape(-1, C))
        err = tri.reprojection_errors(sel.reshape(-1, C, 2), X, Ps,
                                      msk.reshape(-1, C)).reshape(ok.shape)
        err = torch.where(ok, err, _INF)
        score = torch.where(
            ok, _selection_score(err, msk.sum(dim=-1).to(f32), n_later,
                                 tau2), _INF)
        best = torch.argmin(score, dim=-1)                      # (B, K)
        err_b = _take(err, best)
        out_pts.append(_take(X.reshape(Bz, K, Bw, 3), best))
        out_err.append(err_b)
        out_ok.append(torch.isfinite(err_b) & root_mask[:, rc])
        out_obs.append(_take(sel, best))
        out_om.append(_take(msk, best))
    ok = torch.cat(out_ok, dim=1)
    errors = torch.where(ok, torch.cat(out_err, dim=1), _INF)
    return _finalize(torch.cat(out_pts, dim=1), errors, ok, dedupe_eps,
                     torch.cat(out_obs, dim=1) if with_obs else None,
                     torch.cat(out_om, dim=1) if with_obs else None)


def _match_assoc(pts, valid, Ps, d, gated, root_mask, gate_px, dedupe_eps,
                 with_obs):
    """Constant-depth large-rig matcher.  Each root seeds a 2-view DLT with
    its nearest gated candidate over every other camera (the first flat
    (camera, blob) index among ties), then two rounds reproject every
    point, take each camera's nearest valid blob within the gate and
    re-triangulate.  Association may use earlier cameras too; coincident
    duplicates die in the dedupe pass."""
    Bz, C, K, _ = pts.shape
    N = C * K
    dev = pts.device
    cams = torch.arange(C, device=dev)
    zi = torch.arange(Bz, device=dev)

    # seed pair: the best gated candidate over all (camera, blob)
    d_flat = torch.where(gated, d, _INF).reshape(Bz, C, K, N)
    best = torch.argmin(d_flat, dim=-1)                         # (B, C, K)
    has_seed = torch.isfinite(torch.amin(d_flat, dim=-1))
    b_star = best // K
    seed_obs = pts.reshape(Bz, N, 2)[zi[:, None, None], best]   # (B, C, K, 2)

    own_oh = cams[:, None, None] == cams[None, None, :]         # (C, 1, C)
    seed_oh = b_star[..., None] == cams                         # (B, C, K, C)
    sel0 = torch.where(own_oh[..., None], pts[:, :, :, None, :], 0.0)
    sel0 = torch.where(seed_oh[..., None], seed_obs[:, :, :, None, :], sel0)
    msk0 = (own_oh | (seed_oh & has_seed[..., None])).reshape(Bz * N, C)
    own_row = own_oh.expand(C, K, C).reshape(N, C)
    own_pts = pts[:, :, :, None, :].expand(Bz, C, K, C, 2).reshape(Bz, N, C, 2)
    X, _ = tri.triangulate_points(sel0.reshape(Bz * N, C, 2), Ps, msk0)

    for _ in range(2):
        uv = tri.reproject(X, Ps).reshape(Bz, N, C, 1, 2)
        diff = uv - pts[:, None]                                # (B,N,C,K,2)
        dist2 = (diff * diff).sum(dim=-1)
        dist2 = torch.where(valid[:, None], dist2, _INF)
        nd2 = torch.amin(dist2, dim=-1)                         # (B, N, C)
        nearest = torch.argmin(dist2, dim=-1)
        # the blob lookup is a gather (JAX contracts a one-hot: exact too)
        obs = pts[zi[:, None, None], cams[None, None, :], nearest]
        sel = torch.where(own_row[..., None], own_pts, obs)     # (B, N, C, 2)
        msk = (nd2 < gate_px * gate_px) | own_row
        X, _ = tri.triangulate_points(sel.reshape(Bz * N, C, 2), Ps,
                                      msk.reshape(Bz * N, C))

    err = tri.reprojection_errors(sel.reshape(Bz * N, C, 2), X, Ps,
                                  msk.reshape(Bz * N, C)).reshape(Bz, N)
    ok = (torch.isfinite(err) & root_mask.reshape(Bz, N)
          & has_seed.reshape(Bz, N))
    err = torch.where(ok, err, _INF)
    return _finalize(X.reshape(Bz, N, 3), err, ok, dedupe_eps,
                     *((sel, msk) if with_obs else (None, None)))


def _finalize(object_points, errors, ok, dedupe_eps, obs=None,
              obs_mask=None):
    """Ghost dedupe: drop a point when a strictly better (or equal-error,
    lower-index) valid point lies within ``dedupe_eps``.  (B, N, ...).
    The winners' observations, when given, keep only surviving points'."""
    if dedupe_eps > 0:
        diff = object_points[:, :, None, :] - object_points[:, None, :, :]
        d2 = (diff * diff).sum(dim=-1)
        n = errors.shape[1]
        i_idx = torch.arange(n, device=errors.device)
        better = (errors[:, None, :] < errors[:, :, None]) | (
            (errors[:, None, :] == errors[:, :, None])
            & (i_idx[None, :] < i_idx[:, None]))
        clash = (d2 < dedupe_eps ** 2) & ok[:, None, :] & better
        ok = ok & ~clash.any(dim=-1)
        errors = torch.where(ok, errors, _INF)
    object_points = torch.where(ok[..., None], object_points, 0.0)
    out = {"object_points": object_points, "errors": errors, "valid": ok}
    if obs is not None:
        obs_mask = obs_mask & ok[..., None]
        out["obs"] = torch.where(obs_mask[..., None], obs, 0.0)
        out["obs_mask"] = obs_mask
    return out
