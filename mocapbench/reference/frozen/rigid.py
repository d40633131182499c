"""Frozen copy of ``low_cost_mocap_tpu_torch/ops/rigid.py`` (commit
9b1e9ac), its imports made relative; the benchmark's reference runs it
op by op and never imports the program.

Drone locator: marker-triple fit on triangulated points.

Counterpart of ``low_cost_mocap_tpu/ops/rigid.py``.  A drone is a root
point with two neighbours at ``dist1`` whose pair sits ``dist2`` apart; the
first qualifying (j, k) pair in row-major order of the (N, N, N) candidate
tensor wins, roots are taken greedily in index order, and an accepted
triple consumes its three markers as roots.  Every input carries a leading
batch axis of frames (B, N, ...).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LocatedObjects(NamedTuple):
    pos: torch.Tensor       # (..., N, 3) midpoint of the arm pair
    heading: torch.Tensor   # (..., N)
    error: torch.Tensor     # (..., N) mean reprojection error of the triple
    index: torch.Tensor     # (..., N) int32 drone index, -1 when empty
    valid: torch.Tensor     # (..., N) bool


def locate_objects(points, errors, valid, dist1: float = 0.095,
                   dist2: float = 0.15, tol: float = 0.025, ax_h1: int = 0,
                   ax_h2: int = 1, side_min: float = 0.0) -> LocatedObjects:
    """Find drone marker triples among triangulated points.

    points: (B, N, 3); errors: (B, N); valid: (B, N) bool.  ``ax_h1`` /
    ``ax_h2`` select the components for heading and the third-LED side
    test; ``side_min`` rejects a third LED that sits on the arm axis.
    """
    Bz, N, _ = points.shape
    dev = points.device
    diff = points[:, :, None, :] - points[:, None, :, :]
    D = torch.sqrt(torch.clamp_min((diff * diff).sum(dim=-1), 0.0))

    vv = valid[:, :, None] & valid[:, None, :]
    near1 = (torch.abs(D - dist1) < tol) & vv
    pair_ok = torch.abs(D - dist2) <= tol
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    cand = (near1[:, :, :, None] & near1[:, :, None, :]
            & pair_ok[:, None, :, :] & ~eye[None, None])        # (B,N,N,N)

    flat = cand.reshape(Bz, N, N * N)
    hit0 = flat.any(dim=-1) & valid
    jk = torch.argmax(flat.to(torch.uint8), dim=-1)             # first True
    j = jk // N
    k = jk % N

    pj = torch.gather(points, 1, j[..., None].expand(Bz, N, 3))
    pk = torch.gather(points, 1, k[..., None].expand(Bz, N, 3))
    loc = (pj + pk) / 2.0
    hv = pj - pk
    hv = hv / torch.clamp_min(
        torch.linalg.vector_norm(hv, dim=-1, keepdim=True), 1e-12)
    heading = torch.atan2(hv[..., ax_h2], hv[..., ax_h1])
    heading = torch.where(heading > math.pi / 2, heading - math.pi, heading)
    heading = torch.where(heading < -math.pi / 2, heading + math.pi, heading)
    err = (errors + torch.gather(errors, 1, j)
           + torch.gather(errors, 1, k)) / 3.0
    side = (points - loc)[..., ax_h2]
    drone_idx = torch.where(side > 0, 0, 1).to(torch.int32)
    hit0 = hit0 & (torch.abs(side) >= side_min)

    # greedy pass in root order: only the consumed-root test is sequential
    iN = torch.arange(N, device=dev)
    triple = ((iN[None, None, :] == iN[None, :, None])
              | (iN[None, None, :] == j[..., None])
              | (iN[None, None, :] == k[..., None]))            # (B, N, N)
    consumed = torch.zeros(Bz, N, dtype=torch.bool, device=dev)
    accept = []
    for i in range(N):
        take = hit0[:, i] & ~consumed[:, i]
        consumed = consumed | (take[:, None] & triple[:, i])
        accept.append(take)
    accept = torch.stack(accept, dim=1)

    return LocatedObjects(
        pos=torch.where(accept[..., None], loc, 0.0),
        heading=torch.where(accept, -heading, 0.0),
        error=torch.where(accept, err, float("inf")),
        index=torch.where(accept, drone_idx, -1).to(torch.int32),
        valid=accept,
    )
