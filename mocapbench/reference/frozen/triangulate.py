"""Frozen copy of ``low_cost_mocap_tpu_torch/ops/triangulate.py`` (commit
9b1e9ac), its imports made relative; the benchmark's reference runs it
op by op and never imports the program.

Batched masked DLT triangulation + reprojection errors.

Counterpart of ``low_cost_mocap_tpu/ops/triangulate.py``.  Masked camera
rows of the DLT system are zeroed (identical to deleting them), and the
smallest eigenvector of the 4x4 normal matrix comes from inverse iteration
with the closed-form adjugate — the same arithmetic as the JAX package, not
``torch.linalg.eigh``, whose iterative solver would change the numerics.

The small products here (A^T A, the adjugate times a vector, P X) are
written out as elementwise sums in a fixed order instead of batched
matmuls: cuBLAS picks its kernel, and with it the summation order, by the
batch size, and a frame set must get the same bits whether it is served
alone, in a batch, or in an offline chunk.
"""

from __future__ import annotations

import torch


def _dlt_system(points_px, Ps, mask):
    """Masked A^T A of the DLT system.

    points_px: (..., C, 2); Ps: (..., C, 3, 4); mask: (..., C) bool.
    Returns (..., 4, 4).
    """
    x = points_px[..., 0:1]
    y = points_px[..., 1:2]
    P0 = Ps[..., 0, :]
    P1 = Ps[..., 1, :]
    P2 = Ps[..., 2, :]
    r1 = y * P2 - P1
    r2 = P0 - x * P2
    m = mask[..., None].to(Ps.dtype)
    A = torch.cat([r1 * m, r2 * m], dim=-2)  # (..., 2C, 4)
    out = A[..., 0, :, None] * A[..., 0, None, :]
    for r in range(1, A.shape[-2]):
        out = out + A[..., r, :, None] * A[..., r, None, :]
    return out


def _adjugate4(A):
    """Closed-form adjugate of (..., 4, 4) — elementwise arithmetic only."""
    a = [[A[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (a[r0][c0] * (a[r1][c1] * a[r2][c2] - a[r1][c2] * a[r2][c1])
                - a[r0][c1] * (a[r1][c0] * a[r2][c2] - a[r1][c2] * a[r2][c0])
                + a[r0][c2] * (a[r1][c0] * a[r2][c1] - a[r1][c1] * a[r2][c0]))

    rows = [0, 1, 2, 3]
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        ri = [r for r in rows if r != i]
        for j in range(4):
            cj = [c for c in rows if c != j]
            m = det3(ri[0], ri[1], ri[2], cj[0], cj[1], cj[2])
            cof[i][j] = m if (i + j) % 2 == 0 else -m
    # adj = cofactor^T
    return torch.stack(
        [torch.stack([cof[i][j] for i in range(4)], dim=-1) for j in range(4)],
        dim=-2)


def smallest_eigvec_sym4(B, iters: int = 3):
    """Unit eigenvector of the smallest eigenvalue of PSD (..., 4, 4), by
    inverse iteration v <- adj(B + mu I) v."""
    tr = B[..., 0, 0] + B[..., 1, 1] + B[..., 2, 2] + B[..., 3, 3]
    mu = (1e-6 * tr + 1e-30)[..., None, None]
    A = B + mu * torch.eye(4, dtype=B.dtype, device=B.device)
    adj = _adjugate4(A)
    v = torch.ones(B.shape[:-2] + (4,), dtype=B.dtype, device=B.device)
    for _ in range(iters):
        v = (adj[..., 0] * v[..., 0:1] + adj[..., 1] * v[..., 1:2]
             + adj[..., 2] * v[..., 2:3] + adj[..., 3] * v[..., 3:4])
        sq = v * v
        n = torch.sqrt(sq[..., 0:1] + sq[..., 1:2] + sq[..., 2:3]
                       + sq[..., 3:4])
        v = v / torch.clamp_min(n, 1e-30)
    return v


def triangulate_points(points_px, Ps, mask):
    """Triangulate a batch of points from multi-camera observations.

    points_px: (N, C, 2), Ps: (C, 3, 4), mask: (N, C) bool.
    Returns (X (N, 3), zeros where invalid; valid (N,) — >= 2 views).
    """
    B = _dlt_system(points_px, Ps[None], mask)
    h = smallest_eigvec_sym4(B)
    w = h[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.ones_like(w), w)
    X = h[..., :3] / w_safe[..., None]
    valid = mask.sum(dim=-1) >= 2
    return torch.where(valid[..., None], X, torch.zeros_like(X)), valid


def _project(X, Ps):
    """Homogeneous projections P [X; 1]: (N, 3) points through (C, 3, 4)
    -> (N, C, 3)."""
    x = X[:, None, None]
    return (Ps[..., 0] * x[..., 0] + Ps[..., 1] * x[..., 1]
            + Ps[..., 2] * x[..., 2] + Ps[..., 3])


def reprojection_errors(points_px, X, Ps, mask):
    """Mean squared pixel residual per point; +inf for < 2 views.

    points_px: (N, C, 2); X: (N, 3); Ps: (C, 3, 4); mask: (N, C).
    """
    proj = _project(X, Ps)                                      # (N, C, 3)
    z = proj[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    uv = proj[..., :2] / z_safe[..., None]
    sq = ((uv - points_px) ** 2).sum(dim=-1)                    # (N, C)
    m = mask.to(sq.dtype)
    n_vis = m.sum(dim=-1)
    err = (sq * m).sum(dim=-1) / torch.clamp_min(2.0 * n_vis, 1.0)
    valid = n_vis >= 2
    return torch.where(valid, err, torch.full_like(err, float("inf")))


def reproject(X, Ps):
    """Project (N, 3) world points through (C, 3, 4) -> (N, C, 2) pixels."""
    proj = _project(X, Ps)
    z = proj[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    return proj[..., :2] / z_safe[..., None]
