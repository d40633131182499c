"""Frozen copy of ``low_cost_mocap_tpu_torch/ops/epipolar.py`` (commit
9b1e9ac), its imports made relative; the benchmark's reference runs it
op by op and never imports the program.

Epipolar geometry: F/E relations, epilines, motion from essential.

Counterpart of ``low_cost_mocap_tpu/ops/epipolar.py``.  Everything here
runs once per calibration (or once per pose set), so the 4x4 determinants
and the SVD go to ``torch.linalg``.
"""

from __future__ import annotations

import torch


def fundamental_from_projections(P1, P2):
    """F mapping points in image 1 to epilines in image 2.

    With X_j the cyclic row pair of P1 omitting row j and Y_i likewise for
    P2, F[i, j] = det([X_j; Y_i]) (the construction of
    ``cv.sfm.fundamentalFromProjections``).  P1, P2: (..., 3, 4).
    Returns (..., 3, 3).
    """
    def pairs(P):
        return torch.stack(
            [
                torch.stack([P[..., 1, :], P[..., 2, :]], dim=-2),
                torch.stack([P[..., 2, :], P[..., 0, :]], dim=-2),
                torch.stack([P[..., 0, :], P[..., 1, :]], dim=-2),
            ],
            dim=-3,
        )  # (..., 3, 2, 4)

    X = pairs(P1)
    Y = pairs(P2)
    Xb = X[..., None, :, :, :].expand(*X.shape[:-3], 3, 3, 2, 4)
    Yb = Y[..., :, None, :, :].expand(*Y.shape[:-3], 3, 3, 2, 4)
    M = torch.cat([Xb, Yb], dim=-2)  # (..., 3, 3, 4, 4)
    return torch.linalg.det(M)


def epiline(points_px, F):
    """Epipolar lines (a, b, c) with a² + b² = 1 in image 2 for (..., 2)
    points of image 1 (``cv.computeCorrespondEpilines``'s normalisation)."""
    ph = torch.cat([points_px, torch.ones_like(points_px[..., :1])], dim=-1)
    line = torch.einsum("...ij,...j->...i", F, ph)
    n = torch.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2)
    return line / torch.clamp_min(n[..., None], 1e-12)


def point_line_distance(points_px, line):
    """|a x + b y + c| / sqrt(a² + b²)."""
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    d = torch.abs(a * points_px[..., 0] + b * points_px[..., 1] + c)
    return d / torch.clamp_min(torch.sqrt(a * a + b * b), 1e-12)


def essential_from_fundamental(F, K1, K2):
    """E = K2^T F K1."""
    return K2.transpose(-1, -2) @ F @ K1


def motion_from_essential(E):
    """The four (R, t) candidates of an essential matrix: (4, 3, 3) and
    (4, 3), in the JAX package's order.  U and Vh are made proper
    rotations by their determinants' signs first."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vh
    Rb = U @ W.T @ Vh
    t = U[..., :, 2]
    return torch.stack([Ra, Ra, Rb, Rb]), torch.stack([t, -t, t, -t])


def sampson_distance(pts1, pts2, F):
    """Squared Sampson distance of (..., 2) correspondences under F, which
    is (3, 3) or carries leading batch axes of its own ahead of the
    points' (``(I, 3, 3)`` against ``(N, 2)`` gives ``(I, N)``)."""
    p1 = torch.cat([pts1, torch.ones_like(pts1[..., :1])], dim=-1)
    p2 = torch.cat([pts2, torch.ones_like(pts2[..., :1])], dim=-1)
    lead = F.shape[:-2]
    Fb = F.reshape(lead + (1,) * (p1.dim() - 1) + (3, 3))
    Fp1 = (Fb @ p1[..., None])[..., 0]
    Ftp2 = (Fb.transpose(-1, -2) @ p2[..., None])[..., 0]
    num = (p2 * Fp1).sum(dim=-1) ** 2
    den = (Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2
           + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2)
    return num / torch.clamp_min(den, 1e-12)
