"""Camera-frame -> world-frame transform of triangulated points.

Counterpart of ``low_cost_mocap_tpu/ops/world.py:to_world``: flip x and y,
homogenise, multiply by the 4x4 to-world matrix in full float32,
dehomogenise, swap y and z.
"""

from __future__ import annotations

import torch


def to_world(points, to_world_matrix):
    """points: (..., 3) triangulated points; to_world_matrix: (4, 4)."""
    flip = torch.tensor([-1.0, -1.0, 1.0], dtype=points.dtype,
                        device=points.device)
    p = points * flip
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    w = ph @ to_world_matrix.to(points.dtype).T
    w = w[..., :3] / w[..., 3:4]
    return w[..., [0, 2, 1]]
