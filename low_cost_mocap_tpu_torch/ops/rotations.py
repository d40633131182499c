"""Rotation parameterisations: rotation vector, matrix, quaternion.

Counterpart of ``low_cost_mocap_tpu/ops/rotations.py``.  Every function is
out of place and free of data-dependent Python branches, so
``torch.func.jacfwd`` differentiates ``rotvec_to_matrix`` inside bundle
adjustment.  The small-angle limits use the Taylor-safe ``where`` forms of
the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-12


def _sinc(x):
    """sin(x)/x, safe at 0."""
    small = torch.abs(x) < 1e-6
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


def _cosc(x):
    """(1 - cos(x)) / x**2, safe at 0."""
    small = torch.abs(x) < 1e-6
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x * x / 24.0,
                       (1.0 - torch.cos(safe)) / (safe * safe))


def hat(v):
    """Skew-symmetric cross-product matrix [v]_x of (..., 3) vectors."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def rotvec_to_matrix(rvec):
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix,
    R = I + sinc(θ)·[v]x + cosc(θ)·[v]x².  The angle is a clamped sqrt of
    the squared norm, not a norm, so the Jacobian at a zero vector is
    finite (dR = hat(dv))."""
    sq = (rvec * rvec).sum(dim=-1, keepdim=True)[..., None]   # (..., 1, 1)
    theta = torch.sqrt(torch.clamp_min(sq, _EPS * _EPS))
    V = hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + _sinc(theta) * V + _cosc(theta) * (V @ V)


def matrix_to_rotvec(R):
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector; the axis
    near θ = π comes from the diagonal of (R + I)/2, signed by the row of
    its largest component."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)                              # [0, pi]
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)       # 2 sin θ a
    s = _sinc(theta)[..., None]
    generic = w / (2.0 * torch.clamp_min(s, _EPS))

    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) / 2.0
    diag = torch.clamp_min(torch.diagonal(B, dim1=-2, dim2=-1), 0.0)
    axis_pi = torch.sqrt(diag)
    # B[k, j] = a_k a_j with a_k > 0 chosen: sign(a_j) = sign(B[k, j])
    k = torch.argmax(axis_pi, dim=-1)                            # (...,)
    row = torch.gather(B, -2, k[..., None, None].expand(
        *k.shape, 1, 3))[..., 0, :]                              # B[..., k, :]
    axis_signed = axis_pi * torch.where(row < 0, -1.0, 1.0)
    near_pi = (math.pi - theta) < 1e-3
    axis_norm = axis_signed / torch.clamp_min(
        torch.linalg.vector_norm(axis_signed, dim=-1, keepdim=True), _EPS)
    return torch.where(near_pi[..., None], axis_norm * theta[..., None],
                       generic)


def _quat_to_matrix(xp, q):
    """Shared formula; ``xp`` is torch or numpy."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    stack = torch.stack if xp is torch else np.stack
    rows = [
        stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
               2 * (x * z + w * y)], -1),
        stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
               2 * (y * z - w * x)], -1),
        stack([2 * (x * z - w * y), 2 * (y * z + w * x),
               1 - 2 * (x * x + y * y)], -1),
    ]
    return stack(rows, -2)


def quat_to_matrix(q):
    """(..., 4) unit quaternion (w, x, y, z) -> (..., 3, 3)."""
    return _quat_to_matrix(torch, q)


def quat_to_matrix_np(q):
    """numpy variant for host-side consumers."""
    return _quat_to_matrix(np, np.asarray(q))


def matrix_to_quat(R):
    """(..., 3, 3) rotation -> (..., 4) unit quaternion (w, x, y, z) by
    branchless Shepperd: all four constructions, keyed by the largest of
    (trace, R00, R11, R22)."""
    def r(i, j):
        return R[..., i, j]

    tr = r(0, 0) + r(1, 1) + r(2, 2)
    m = torch.stack([1.0 + tr,
                     1.0 + r(0, 0) - r(1, 1) - r(2, 2),
                     1.0 - r(0, 0) + r(1, 1) - r(2, 2),
                     1.0 - r(0, 0) - r(1, 1) + r(2, 2)], dim=-1)
    k = torch.argmax(m, dim=-1)
    s = 2.0 * torch.sqrt(torch.clamp_min(
        torch.gather(m, -1, k[..., None])[..., 0], 1e-12))
    q_w = torch.stack([0.25 * s, (r(2, 1) - r(1, 2)) / s,
                       (r(0, 2) - r(2, 0)) / s, (r(1, 0) - r(0, 1)) / s], -1)
    q_x = torch.stack([(r(2, 1) - r(1, 2)) / s, 0.25 * s,
                       (r(0, 1) + r(1, 0)) / s, (r(0, 2) + r(2, 0)) / s], -1)
    q_y = torch.stack([(r(0, 2) - r(2, 0)) / s, (r(0, 1) + r(1, 0)) / s,
                       0.25 * s, (r(1, 2) + r(2, 1)) / s], -1)
    q_z = torch.stack([(r(1, 0) - r(0, 1)) / s, (r(0, 2) + r(2, 0)) / s,
                       (r(1, 2) + r(2, 1)) / s, 0.25 * s], -1)
    kk = k[..., None]
    q = torch.where(kk == 0, q_w, torch.where(
        kk == 1, q_x, torch.where(kk == 2, q_y, q_z)))
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, 1e-12)
