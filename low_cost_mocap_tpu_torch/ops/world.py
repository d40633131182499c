"""World-frame tools: camera->world transform, floor fit, origin, scale.

Counterpart of ``low_cost_mocap_tpu/ops/world.py``.  ``to_world`` applies
the reference's conversion: flip x and y, homogenise, multiply by the 4x4
to-world matrix in full float32, dehomogenise, swap y and z.
``fit_floor`` levels the floor plane, ``set_origin`` moves the origin and
``determine_scale`` takes the metric scale from the wand.

``fit_floor``'s plane fit is the SVD minimum-norm least-squares solve of
``jnp.linalg.lstsq(..., rcond=None)``, written out (``_lstsq_min_norm``)
because ``torch.linalg.lstsq`` has only ``gels`` on CUDA, which needs a
full-rank system: on fewer than three floor points, or collinear ones, the
levelling matrix stays finite and equal to the JAX package's.
"""

from __future__ import annotations

import torch

from low_cost_mocap_tpu_torch.ops.rotations import hat


def to_world(points, to_world_matrix):
    """points: (..., 3) triangulated points; to_world_matrix: (4, 4)."""
    # x and y flipped by negation (the bits of a product with -1), and the
    # components taken by slices: no constant is uploaded, so the
    # compiled step's CUDA graph can capture it
    p0, p1, p2 = -points[..., 0:1], -points[..., 1:2], points[..., 2:3]
    M = to_world_matrix.to(points.dtype)
    # M [p; 1] written out: a matmul's kernel, and its summation order,
    # would change with the batch size on the card
    w = p0 * M[:, 0] + p1 * M[:, 1] + p2 * M[:, 2] + M[:, 3]
    w = w[..., :3] / w[..., 3:4]
    return torch.cat([w[..., 0:1], w[..., 2:3], w[..., 1:2]], dim=-1)


def _lstsq_min_norm(A, b):
    """Minimum-norm least-squares solution of A x = b through the SVD, with
    singular values below eps * max(M, N) * s_max dropped: the solve and
    cut-off of ``jnp.linalg.lstsq(A, b, rcond=None)``."""
    u, s, vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return vh.T @ (s_inv[:, None] * (u.T @ b))


def fit_floor(object_points, to_world_matrix):
    """The to-world matrix that makes the plane of (N, 3) world-frame floor
    points (display convention: height is component 1) level: the
    levelling rotation, found and applied in the pre-swap frame, composed
    onto the current matrix."""
    dtype, dev = object_points.dtype, object_points.device
    q = object_points[:, [0, 2, 1]]                     # pre-swap frame
    A = torch.stack([q[:, 0], q[:, 1], torch.ones_like(q[:, 0])], dim=-1)
    fit = _lstsq_min_norm(A, q[:, 2:3])
    a, b = fit[0, 0], fit[1, 0]
    n = torch.stack([-a, -b, torch.ones_like(a)])
    n = n / torch.linalg.vector_norm(n)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    # Rodrigues rotation taking n to up
    v = torch.linalg.cross(n, up)
    s2 = (v * v).sum()
    c = torch.dot(n, up)
    V = hat(v)
    eye = torch.eye(3, dtype=dtype, device=dev)
    R = eye + V + V @ V * (1.0 - c) / torch.clamp_min(s2, 1e-12)
    R = torch.where(s2 < 1e-12, eye, R)
    T = torch.eye(4, dtype=dtype, device=dev)
    T = torch.cat([torch.cat([R, T[:3, 3:]], dim=1), T[3:]], dim=0)
    return T @ to_world_matrix.to(dtype)


def set_origin(object_point, to_world_matrix):
    """Shift the world origin to the (3,) world-frame ``object_point``,
    which is swapped y/z back into the pre-swap frame first."""
    p = object_point[[0, 2, 1]]
    T = torch.eye(4, dtype=to_world_matrix.dtype, device=to_world_matrix.device)
    T = torch.cat([torch.cat([T[:3, :3], -p[:, None].to(T.dtype)], dim=1),
                   T[3:]], dim=0)
    return T @ to_world_matrix


def determine_scale(pair_points, ts, wand_length: float = 0.15):
    """Metric scale from observed wand marker pairs.

    pair_points: (F, 2, 3), the two wand markers over F frames; ts: (C, 3)
    camera translations.  Returns (scale_factor, scaled ts).
    """
    d = torch.linalg.vector_norm(pair_points[:, 0] - pair_points[:, 1],
                                 dim=-1)
    scale = wand_length / d.mean()
    return scale, ts * scale
