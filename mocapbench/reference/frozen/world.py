"""Frozen copy of ``to_world`` from ``low_cost_mocap_tpu_torch/ops/world.py``
(commit 9b1e9ac): triangulated points into the engine's world frame."""

from __future__ import annotations

import torch


def to_world(points, to_world_matrix):
    """points: (..., 3) triangulated points; to_world_matrix: (4, 4)."""
    p0, p1, p2 = -points[..., 0:1], -points[..., 1:2], points[..., 2:3]
    M = to_world_matrix.to(points.dtype)
    w = p0 * M[:, 0] + p1 * M[:, 1] + p2 * M[:, 2] + M[:, 3]
    w = w[..., :3] / w[..., 3:4]
    return torch.cat([w[..., 0:1], w[..., 2:3], w[..., 1:2]], dim=-1)
