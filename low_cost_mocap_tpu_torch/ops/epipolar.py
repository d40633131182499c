"""Epipolar geometry: the fundamental matrix of a camera pair.

Counterpart of ``low_cost_mocap_tpu/ops/epipolar.py:fundamental_from_projections``.
It runs once per calibration, so the 4x4 determinants go to
``torch.linalg.det``.
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
