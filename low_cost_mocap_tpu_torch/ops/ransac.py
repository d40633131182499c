"""Vectorised RANSAC fundamental-matrix estimation (normalised 8-point).

Counterpart of ``low_cost_mocap_tpu/ops/ransac.py``: a fixed number of
trials evaluated as one batch — (iters, 8) correspondence subsets, every
8-point system solved as a batched 9x9 symmetric eigenproblem, every
candidate F scored against every point, the most inliers win, then a refit
on the winner's inliers.

The random draw is split from the solve.  ``ransac_fundamental`` takes the
(iters, 8) index table itself, or a ``torch.Generator`` to draw one with
``torch.multinomial``; the JAX package draws with ``jax.random.choice``, a
different stream, so tests feed the port JAX's own tables.
"""

from __future__ import annotations

import math

import torch

from low_cost_mocap_tpu_torch.ops.epipolar import sampson_distance


def _normalise(pts, mask):
    """Hartley normalisation: zero mean, sqrt(2) RMS distance over the
    valid points.  Returns (pts_n, T)."""
    m = mask.to(pts.dtype)[:, None]
    n = torch.clamp_min(m.sum(), 1.0)
    mean = (pts * m).sum(dim=0) / n
    d = torch.sqrt(((pts - mean) ** 2).sum(dim=-1))
    scale = math.sqrt(2.0) / torch.clamp_min((d * mask).sum() / n, 1e-12)
    zero = torch.zeros_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -mean[0] * scale]),
        torch.stack([zero, scale, -mean[1] * scale]),
        torch.stack([zero, zero, torch.ones_like(scale)]),
    ])
    return (pts - mean) * scale, T


def _eight_point(p1, p2, w):
    """Weighted 8-point F from (..., M, 2) correspondences and (..., M)
    weights (a 0/1 mask works): the smallest eigenvector of AᵀA, projected
    to rank 2.  Returns (..., 3, 3)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
                    dim=-1) * w[..., None]                     # (..., M, 9)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    F = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    U, s, Vh = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (U * s[..., None, :]) @ Vh


def draw_samples(mask, iters: int, generator=None):
    """(iters, 8) indices drawn with replacement from the valid points,
    each with equal probability."""
    probs = mask.to(torch.float32)
    probs = probs / torch.clamp_min(probs.sum(), 1.0)
    return torch.multinomial(probs, iters * 8, replacement=True,
                             generator=generator).reshape(iters, 8)


def ransac_fundamental(pts1, pts2, mask, iters: int = 512,
                       threshold_px: float = 1.0, *, idx=None,
                       generator=None):
    """Robust F between two views.

    pts1, pts2: (N, 2) correspondences; mask: (N,) validity.  ``idx``: the
    (iters, 8) sample table; without it one is drawn from ``generator``.
    Returns (F (3, 3) with F[2, 2] = 1, inliers (N,) bool).
    """
    p1n, T1 = _normalise(pts1, mask)
    p2n, T2 = _normalise(pts2, mask)
    if idx is None:
        idx = draw_samples(mask, iters, generator)
    idx = idx.to(device=pts1.device, dtype=torch.long)
    samp_w = torch.ones(idx.shape, dtype=pts1.dtype, device=pts1.device)
    Fs = _eight_point(p1n[idx], p2n[idx], samp_w)               # (I, 3, 3)

    # every candidate against every point, in normalised coordinates (the
    # threshold maps through image 2's normalisation scale)
    d = sampson_distance(p1n, p2n, Fs)                          # (I, N)
    thr = (threshold_px * T2[0, 0]) ** 2
    inl = (d < thr) & mask[None, :]
    best = torch.argmax(inl.sum(dim=1))
    w = inl.index_select(0, best.reshape(1))[0].to(pts1.dtype)

    F = T2.T @ _eight_point(p1n, p2n, w) @ T1
    inliers = (sampson_distance(pts1, pts2, F) < threshold_px ** 2) & mask
    F = F / torch.where(torch.abs(F[2, 2]) < 1e-12,
                        torch.ones_like(F[2, 2]), F[2, 2])
    return F, inliers
