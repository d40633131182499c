"""Generalised rigid-body tracking: arbitrary M-marker templates.

Counterpart of ``low_cost_mocap_tpu/ops/rigid_general.py``, with the same
fixed-shape hypothesis search:

  1. anchor enumeration: for each seed edge of the template, the
     ``pair_budget`` point pairs whose distance is closest to the edge's;
  2. a third anchor completes each pair by the smallest distance-signature
     deviation;
  3. each anchor triple gives a closed-form pose (Horn's quaternion
     method: Newton on the quartic characteristic polynomial, then the
     eigenvector as an adjugate column);
  4. every template marker is associated to its nearest point, the worst
     distance-inconsistent marker is trimmed, the pose is refit on the
     matched markers, and the lowest score wins.

``fit_body`` takes an optional leading batch axis, so ``learn_template``
fits every frame of a capture in one call and the live path calls it at
one frame.  Candidate pairs come from a stable ascending sort, which keeps
the lowest flat index first among equal deviations, as ``jax.lax.top_k``
does (``torch.topk`` promises no order among ties).  ``argmin``/``argmax``
take the first extremum and count NaN as JAX does.  Each template's marker
and distance tensors are built once per device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.ops.rotations import quat_to_matrix
from low_cost_mocap_tpu_torch.ops.triangulate import _adjugate4


class BodyTemplate(NamedTuple):
    """Static description of a rigid marker constellation.

    markers: ((x, y, z), ...) — marker positions in the body frame, nested
        tuples so that the template is hashable (``marker_array()`` gives
        the (M, 3) array).
    seeds: ((a, b, c), ...) — anchor triples for hypothesis seeding, chosen
        by ``make_template``.
    """

    markers: tuple
    seeds: tuple[tuple[int, int, int], ...]

    def marker_array(self) -> np.ndarray:
        return np.asarray(self.markers, np.float32)


def make_template(markers, n_alt_anchors: int = 2) -> BodyTemplate:
    """Build a template; picks the seed triples (numpy).

    Seed edges: the most-separated marker pair, plus — when M >= 4 — the
    longest edge disjoint from it, so losing any single marker still leaves
    a complete seed edge.  Per edge, up to ``n_alt_anchors`` third anchors
    in decreasing triangle area.
    """
    markers = np.asarray(markers, np.float32)
    M = markers.shape[0]
    if M < 3:
        raise ValueError(f"a rigid body needs >= 3 markers, got {M}")
    D = np.linalg.norm(markers[:, None] - markers[None, :], axis=-1)
    a, b = map(int, np.unravel_index(np.argmax(D), D.shape))
    edges = [(a, b)]
    if M >= 4:
        D2 = D.copy()
        D2[[a, b], :] = -1.0
        D2[:, [a, b]] = -1.0
        a2, b2 = map(int, np.unravel_index(np.argmax(D2), D2.shape))
        if D2[a2, b2] > 0:
            edges.append((a2, b2))

    seeds = []
    for (ea, eb) in edges:
        ab = markers[eb] - markers[ea]
        area = np.linalg.norm(np.cross(ab[None], markers - markers[ea]),
                              axis=-1)
        area[[ea, eb]] = -1.0
        order = np.argsort(-area)
        seeds += [(ea, eb, int(c)) for c in order[:n_alt_anchors]
                  if area[c] > 1e-9]
    if not seeds:
        raise ValueError("template markers are collinear; pose would be "
                         "ambiguous about the axis")
    return BodyTemplate(markers=tuple(map(tuple, markers.tolist())),
                        seeds=tuple(seeds))


class BodyFit(NamedTuple):
    R: torch.Tensor          # (..., 3, 3) body->world rotation
    t: torch.Tensor          # (..., 3) body->world translation
    rms: torch.Tensor        # (...,) RMS residual over matched markers (m)
    matched: torch.Tensor    # (..., M) bool — template markers with a point
    point_idx: torch.Tensor  # (..., M) int32 — matched point per marker or -1
    valid: torch.Tensor      # (...,) bool


class LocatedBodies(NamedTuple):
    R: torch.Tensor          # (I, 3, 3)
    t: torch.Tensor          # (I, 3)
    rms: torch.Tensor        # (I,)
    valid: torch.Tensor      # (I,)


@functools.cache
def _template_on(template: BodyTemplate, device: torch.device):
    """The template's (M, 3) markers, (M, M) distances and (S, 3, 3) seed
    anchor triples on ``device``, kept for the life of the process (a
    captured graph reads them by address)."""
    tmpl = torch.tensor(template.markers, dtype=torch.float32, device=device)
    Dt = torch.linalg.vector_norm(tmpl[:, None] - tmpl[None, :], dim=-1)
    anchors = torch.stack([tmpl[list(abc)] for abc in template.seeds])
    return tmpl, Dt, anchors


def _largest_eigvec_sym4(K, newton_iters: int = 30):
    """Largest-eigenvalue eigenvector of symmetric (..., 4, 4), QCP-style:
    Newton on det(K - x I) = x^4 + c2 x^2 + c1 x + c0 (trace(K) = 0 for
    Horn matrices) from the Frobenius norm, then the largest column of
    adj(K - x* I)."""
    K2 = K @ K
    p2 = torch.diagonal(K2, dim1=-2, dim2=-1).sum(-1)
    p3 = (K2 * K.transpose(-1, -2)).sum((-2, -1))
    p4 = (K2 * K2.transpose(-1, -2)).sum((-2, -1))
    c2 = -p2 / 2.0                       # e2
    c1 = -p3 / 3.0                       # -e3
    c0 = (p2 * p2 / 2.0 - p4) / 4.0      # e4

    x = torch.sqrt(torch.clamp_min(p2, 0.0))   # >= lambda_max
    for _ in range(newton_iters):
        f = ((x * x + c2) * x + c1) * x + c0
        df = (4.0 * x * x + 2.0 * c2) * x + c1
        x = x - f / torch.where(torch.abs(df) < 1e-20, 1e-20, df)

    M = K - x[..., None, None] * torch.eye(4, dtype=K.dtype, device=K.device)
    adj = _adjugate4(M)                  # columns span the null space
    norms = (adj * adj).sum(-2)          # (..., 4) column norms
    pick = torch.argmax(norms, dim=-1)
    v = torch.gather(adj, -1, pick[..., None, None].expand(
        *pick.shape, 4, 1))[..., 0]
    # degenerate fallback (eigenvalue multiplicity): any unit vector works
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    e0 = torch.zeros_like(v)
    e0[..., 0] = 1.0
    return torch.where(n > 1e-20, v / torch.clamp_min(n, 1e-30), e0)


def weighted_absolute_orientation(P, Q, w):
    """Closed-form weighted Kabsch: R, t minimising
    sum_i w_i |R p_i + t - q_i|^2 (Horn's quaternion method).

    P: (..., M, 3) body-frame points; Q: (..., M, 3) world points;
    w: (..., M) non-negative weights.
    """
    wsum = torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)
    wn = w / wsum
    pc = torch.einsum("...m,...mi->...i", wn, P)
    qc = torch.einsum("...m,...mi->...i", wn, Q)
    Pc = P - pc[..., None, :]
    Qc = Q - qc[..., None, :]
    S = torch.einsum("...mi,...mj->...ij", wn[..., None] * Pc, Qc)

    def s(i, j):
        return S[..., i, j]

    K = torch.stack([
        torch.stack([s(0, 0) + s(1, 1) + s(2, 2), s(1, 2) - s(2, 1),
                     s(2, 0) - s(0, 2), s(0, 1) - s(1, 0)], dim=-1),
        torch.stack([s(1, 2) - s(2, 1), s(0, 0) - s(1, 1) - s(2, 2),
                     s(0, 1) + s(1, 0), s(2, 0) + s(0, 2)], dim=-1),
        torch.stack([s(2, 0) - s(0, 2), s(0, 1) + s(1, 0),
                     -s(0, 0) + s(1, 1) - s(2, 2), s(1, 2) + s(2, 1)],
                    dim=-1),
        torch.stack([s(0, 1) - s(1, 0), s(2, 0) + s(0, 2), s(1, 2) + s(2, 1),
                     -s(0, 0) - s(1, 1) + s(2, 2)], dim=-1),
    ], dim=-2)
    R = quat_to_matrix(_largest_eigvec_sym4(K))
    t = qc - torch.einsum("...ij,...j->...i", R, pc)
    return R, t


def _rows(x, idx):
    """x (L, N, ...) gathered along axis 1 by idx (L, ...) -> (L, ..., ...)."""
    lead = torch.arange(x.shape[0], device=x.device).reshape(
        -1, *([1] * (idx.dim() - 1)))
    return x[lead, idx]


def fit_body(points, valid, template: BodyTemplate, *,
             edge_tol: float = 0.02, assoc_tol: float = 0.03,
             pair_budget: int = 8, refine_iters: int = 2,
             min_markers: int = 3, seed_R=None, seed_t=None,
             seed_ok=None, seed_weight: float = 1e-4) -> BodyFit:
    """Fit ONE instance of ``template`` to triangulated points.

    points: (N, 3) or (L, N, 3) world points; valid: (N,) or (L, N) bool.
    ``edge_tol`` gates anchor edges (m), ``assoc_tol`` marker-to-point
    association (m); a fit is valid when >= ``min_markers`` markers
    matched.  ``seed_R``/``seed_t``/``seed_ok`` ((S, 3, 3), (S, 3), (S,),
    with the points' leading axis if they have one): predicted poses that
    enter as extra hypotheses at the associate-refit stage, with a
    ``seed_weight`` tie-break on the distance to the nearest valid seed.
    """
    batched = points.dim() == 3
    if not batched:
        points, valid = points[None], valid[None]
        if seed_t is not None:
            seed_R, seed_t = seed_R[None], seed_t[None]
            seed_ok = None if seed_ok is None else seed_ok[None]
    dev = points.device
    tmpl, Dt, anchors = _template_on(template, dev)
    M = tmpl.shape[0]
    L, N = points.shape[0], points.shape[1]
    inf = float("inf")

    diff = points[:, :, None, :] - points[:, None, :, :]
    D = torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 0.0))    # (L,N,N)
    vv = valid[:, :, None] & valid[:, None, :]
    off_diag = ~torch.eye(N, dtype=torch.bool, device=dev)
    ar = torch.arange(N, device=dev)

    # 1+2. per seed triple (a, b, c): the candidate (i, j) pairs closest to
    #    the (a, b) edge length (ordered pairs, so both orientations are
    #    hypotheses), each completed by the minimum-signature third point
    pair_cache: dict = {}   # edge -> (pi, pj, pair_ok, k_bad)
    pi_l, pj_l, pk_l, ok_l, P3_l = [], [], [], [], []
    for si, (a, b, c) in enumerate(template.seeds):
        if (a, b) not in pair_cache:
            pair_dev = torch.where(vv & off_diag, torch.abs(D - Dt[a, b]),
                                   inf)
            dev_sorted, flat_idx = torch.sort(pair_dev.reshape(L, N * N),
                                              dim=-1, stable=True)
            flat_idx = flat_idx[:, :pair_budget]
            pi = flat_idx // N                        # (L, Bp)
            pj = flat_idx % N
            k_bad = (~valid[:, None, :]) | (ar == pi[..., None]) \
                | (ar == pj[..., None])
            pair_cache[(a, b)] = (pi, pj, dev_sorted[:, :pair_budget]
                                  < edge_tol, k_bad)
        pi, pj, pair_ok, k_bad = pair_cache[(a, b)]
        k_dev = torch.abs(_rows(D, pi) - Dt[a, c]) \
            + torch.abs(_rows(D, pj) - Dt[b, c])
        k_dev = torch.where(k_bad, inf, k_dev)       # (L, Bp, N)
        pk = torch.argmin(k_dev, dim=-1)             # (L, Bp)
        k_ok = torch.gather(k_dev, -1, pk[..., None])[..., 0] \
            < 2.0 * edge_tol
        pi_l.append(pi)
        pj_l.append(pj)
        pk_l.append(pk)
        ok_l.append(pair_ok & k_ok)
        P3_l.append(anchors[si].expand(L, pi.shape[1], 3, 3))
    pi = torch.cat(pi_l, dim=1)                      # (L, B)
    pj = torch.cat(pj_l, dim=1)
    pk = torch.cat(pk_l, dim=1)
    hyp_ok = torch.cat(ok_l, dim=1)
    P3 = torch.cat(P3_l, dim=1)                      # (L, B, 3, 3)
    B = P3.shape[1]

    # 3. seed pose from each anchor triple (batched quaternion Kabsch)
    Q3 = _rows(points, torch.stack([pi, pj, pk], dim=-1))   # (L, B, 3, 3)
    R, t = weighted_absolute_orientation(
        P3, Q3, torch.ones((L, B, 3), dtype=tmpl.dtype, device=dev))

    # 3b. track-prediction hypotheses: enter at the associate-refit stage
    if seed_t is not None:
        seed_R = seed_R.to(tmpl.dtype)
        seed_t = seed_t.to(tmpl.dtype)
        if seed_ok is None:
            seed_ok = torch.ones(seed_t.shape[:2], dtype=torch.bool,
                                 device=dev)
        R = torch.cat([R, seed_R], dim=1)
        t = torch.cat([t, seed_t], dim=1)
        hyp_ok = torch.cat([hyp_ok, seed_ok], dim=1)
        B = B + seed_t.shape[1]

    not_eye_m = ~torch.eye(M, dtype=torch.bool, device=dev)
    tmpl_b = tmpl.expand(L, B, M, 3)

    # 4. associate every template marker, trim, re-fit, iterate
    def assoc_and_fit(R, t):
        Y = torch.einsum("lbij,mj->lbmi", R, tmpl) + t[:, :, None, :]
        d2 = ((Y[:, :, :, None, :] - points[:, None, None, :, :]) ** 2
              ).sum(-1)                                       # (L,B,M,N)
        d2 = torch.where(valid[:, None, None, :], d2, inf)
        nearest = torch.argmin(d2, dim=-1)                   # (L, B, M)
        nd2 = torch.amin(d2, dim=-1)
        matched = nd2 < assoc_tol * assoc_tol
        Q = _rows(points, nearest)                           # (L,B,M,3)

        # distance-consistency trim: drop the single worst-mean-deviation
        # marker; the next associate pass re-homes the freed point
        Dp = torch.linalg.vector_norm(
            Q[:, :, :, None, :] - Q[:, :, None, :, :] + 1e-12, dim=-1)
        both = matched[..., :, None] & matched[..., None, :] & not_eye_m
        dev_ = torch.where(both, torch.abs(Dp - Dt), 0.0)
        n_part = torch.clamp_min(both.sum(-1), 1)
        mean_dev = dev_.sum(-1) / n_part                     # (L, B, M)
        max_dev = torch.amax(dev_, dim=-1)
        worst = torch.amax(torch.where(matched, mean_dev, -1.0), dim=-1,
                           keepdim=True)
        drop = matched & (mean_dev >= worst) & (max_dev > edge_tol)
        matched = matched & ~drop

        w = matched.to(tmpl.dtype)
        # fewer than 3 matches make the solve degenerate: keep the anchors
        enough = matched.sum(-1) >= 3
        R2, t2 = weighted_absolute_orientation(tmpl_b, Q, w + 1e-9)
        R2 = torch.where(enough[..., None, None], R2, R)
        t2 = torch.where(enough[..., None], t2, t)
        return R2, t2, matched, nearest, Q

    for _ in range(max(refine_iters, 1)):
        R, t, matched, nearest, Q = assoc_and_fit(R, t)

    # 5. score: RMS over matched markers + penalty per unmatched marker
    Y = torch.einsum("lbij,mj->lbmi", R, tmpl) + t[:, :, None, :]
    res2 = ((Y - Q) ** 2).sum(-1)                    # (L, B, M)
    w = matched.to(res2.dtype)
    n_match = w.sum(-1)
    mse = (res2 * w).sum(-1) / torch.clamp_min(n_match, 1.0)
    n_miss = M - n_match
    score = ((res2 * w).sum(-1) + n_miss * assoc_tol ** 2) \
        / torch.clamp_min(n_match + n_miss, 1.0)
    if seed_t is not None and seed_weight > 0:
        d2s = ((t[:, :, None, :] - seed_t[:, None, :, :]) ** 2).sum(-1)
        d2s = torch.where(seed_ok[:, None, :], d2s, inf)
        d2min = torch.amin(d2s, dim=-1)
        score = score + torch.where(torch.isfinite(d2min),
                                    seed_weight * d2min, 0.0)
    score = torch.where(hyp_ok & (n_match >= min_markers), score, inf)

    best = torch.argmin(score, dim=-1)               # (L,)
    lb = torch.arange(L, device=dev)
    ok = torch.isfinite(score[lb, best])
    m_best = matched[lb, best] & ok[:, None]
    fit = BodyFit(
        R=torch.where(ok[:, None, None], R[lb, best],
                      torch.eye(3, dtype=tmpl.dtype, device=dev)),
        t=torch.where(ok[:, None], t[lb, best], 0.0),
        rms=torch.where(ok, torch.sqrt(mse[lb, best]), inf),
        matched=m_best,
        point_idx=torch.where(m_best, nearest[lb, best], -1).to(torch.int32),
        valid=ok,
    )
    return fit if batched else BodyFit(*(x[0] for x in fit))


def locate_bodies(points, valid, template: BodyTemplate, *,
                  max_instances: int = 2, edge_tol: float = 0.02,
                  assoc_tol: float = 0.03, pair_budget: int = 8,
                  refine_iters: int = 2, min_markers: int = 3,
                  return_live: bool = False, seed_R=None, seed_t=None,
                  seed_ok=None, seed_weight: float = 1e-4):
    """Greedily extract up to ``max_instances`` bodies of one template from
    (N, 3) points, or from each of L frames' (L, N, 3); each accepted fit
    consumes its matched points.

    ``return_live=True`` also returns the (N,) (or (L, N)) mask of points
    no accepted fit consumed (the multi-template path chains templates
    over it).  ``seed_*``: track-prediction hypotheses handed to every
    instance's ``fit_body``.  Outputs are (I, ...), or (L, I, ...).
    """
    N = points.shape[-2]
    live = valid
    Rs, ts, rms, ok = [], [], [], []
    for _ in range(max_instances):
        fit = fit_body(points, live, template, edge_tol=edge_tol,
                       assoc_tol=assoc_tol, pair_budget=pair_budget,
                       refine_iters=refine_iters, min_markers=min_markers,
                       seed_R=seed_R, seed_t=seed_t, seed_ok=seed_ok,
                       seed_weight=seed_weight)
        # unmatched markers go to a spare slot N, which is then cut off
        idx = torch.where(fit.matched, fit.point_idx.to(torch.int64), N)
        used = torch.zeros(idx.shape[:-1] + (N + 1,), dtype=torch.bool,
                           device=points.device).scatter_(-1, idx, True)
        live = live & ~(used[..., :N] & fit.valid[..., None])
        Rs.append(fit.R)
        ts.append(fit.t)
        rms.append(fit.rms)
        ok.append(fit.valid)
    axis = points.dim() - 2
    out = LocatedBodies(*(torch.stack(x, dim=axis) for x in (Rs, ts, rms,
                                                              ok)))
    return (out, live) if return_live else out


def learn_template(points_seq, valid_seq, *, edge_tol: float = 0.02,
                   assoc_tol: float = 0.03, refine_rounds: int = 2,
                   min_frames: int = 3, device=None) -> BodyTemplate:
    """Learn a rigid-body template from a capture of one body moving.

    points_seq: (T, N, 3) triangulated world points; valid_seq: (T, N).
    The frame with the most valid points seeds a template (centred,
    principal-axes aligned); every frame is then fit against it in one
    batched ``fit_body`` call on ``device`` (CUDA unless the caller asks
    for the CPU) and each matched marker's body-frame coordinate
    R^T (p - t) is averaged across frames.  Two rounds converge.  Raises
    if fewer than ``min_frames`` frames fit.
    """
    dev = resolve_device(device)
    pts = np.asarray(points_seq, np.float32)
    vld = np.asarray(valid_seq, bool)
    T = pts.shape[0]

    # ---- seed: most-visible frame, canonicalised for determinism
    t0 = int(np.argmax(vld.sum(axis=1)))
    seed = pts[t0][vld[t0]]
    if seed.shape[0] < 3:
        raise ValueError("no frame with >= 3 valid points to seed from")
    seed = seed - seed.mean(axis=0)
    cov = seed.T @ seed
    _, eigvecs = np.linalg.eigh(cov)
    axes = eigvecs[:, ::-1]                  # principal axes, major first
    if np.linalg.det(axes) < 0:
        axes[:, 2] = -axes[:, 2]
    seed = seed @ axes
    tmpl = make_template(seed)

    pts_d = torch.as_tensor(pts, device=dev)
    vld_d = torch.as_tensor(vld, device=dev)
    for _ in range(max(refine_rounds, 1)):
        fits = BodyFit(*(x.cpu().numpy() for x in fit_body(
            pts_d, vld_d, tmpl, edge_tol=edge_tol, assoc_tol=assoc_tol)))
        ok = fits.valid
        if ok.sum() < min_frames:
            raise ValueError(
                f"only {int(ok.sum())}/{T} frames fit the template — "
                "is the capture a single rigid body?")
        R = fits.R[ok]                      # (F, 3, 3)
        tr = fits.t[ok]
        matched = fits.matched[ok]          # (F, M)
        pidx = fits.point_idx[ok]           # (F, M)
        frame_pts = pts[ok]                 # (F, N, 3)
        M = matched.shape[1]
        acc = np.zeros((M, 3), np.float64)
        counts = np.zeros((M,), np.int64)
        for f in range(matched.shape[0]):
            for m in range(M):
                if matched[f, m]:
                    body_p = R[f].T @ (frame_pts[f, pidx[f, m]] - tr[f])
                    acc[m] += body_p
                    counts[m] += 1
        keep = counts >= min_frames
        if keep.sum() < 3:
            raise ValueError("fewer than 3 markers observed consistently")
        markers = (acc[keep] / counts[keep, None]).astype(np.float32)
        tmpl = make_template(markers)
    return tmpl
