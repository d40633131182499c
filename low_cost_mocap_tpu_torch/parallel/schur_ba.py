"""Free-point bundle adjustment with a distributed Schur complement.

Counterpart of ``low_cost_mocap_tpu/parallel/schur_ba.py``.  The 3D points
are free variables, and the sparse structure of BA is used explicitly:

- the per-point landmark blocks Hpp are 3x3 and block-diagonal: each
  shard damps and inverts its own, on its device;
- the camera system is reduced by the Schur complement
  S = Hcc - Hcp Hpp^-1 Hpc; the shards' parts of S and of its right-hand
  side are gathered and summed in shard order (JAX's one ``psum``), S
  being small: (1 + 7(C-1))^2;
- the reduced solve runs on every process from the same numbers; each
  shard then back-substitutes its landmarks,
  dX_i = -Hpp_i^-1 (gp_i + Hcp_iᵀ dc), with no further communication.

The per-point Jacobians come from ``torch.func.vmap`` of
``torch.func.jacfwd`` of one landmark's residual (``_point_residual``),
which has no data-dependent branch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from low_cost_mocap_tpu_torch.ops import ba as ba_ops
from low_cost_mocap_tpu_torch.ops import triangulate as tri
from low_cost_mocap_tpu_torch.ops.camera import projection_matrix
from low_cost_mocap_tpu_torch.parallel.dist_ba import lm_step, robust_cost
from low_cost_mocap_tpu_torch.parallel.mesh import Mesh, shard_along


class SchurBAResult(NamedTuple):
    Rs: torch.Tensor
    ts: torch.Tensor
    focals: torch.Tensor
    points: torch.Tensor     # (N, 3) refined landmarks
    cost: torch.Tensor
    n_iters: torch.Tensor


def _point_residual(cam_p, X_i, obs_i, mask_i, K_stack, num_cameras: int):
    """Masked pixel residual of one landmark: (2C,)."""
    Rs, ts, focals = ba_ops.unpack_params(cam_p, num_cameras)
    K = ba_ops._apply_focals(K_stack, focals)
    Ps = projection_matrix(K, Rs, ts)                          # (C, 3, 4)
    proj = (Ps[..., 0] * X_i[0] + Ps[..., 1] * X_i[1]
            + Ps[..., 2] * X_i[2] + Ps[..., 3])                # (C, 3)
    z = proj[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uv = proj[:, :2] / z_safe[:, None]
    r = (uv - obs_i) * mask_i[:, None].to(uv.dtype)
    return r.reshape(-1)


def schur_bundle_adjust(mesh: Mesh, pts, mask, K_stack, Rs0, ts0, *,
                        axis: str = "point", max_iters: int = 64,
                        ftol: float = 1e-2, cauchy_c: float = 1.0,
                        stats: dict | None = None) -> SchurBAResult:
    """Distributed free-point BA.

    pts: (N, C, 2), N divisible by the ``axis`` size; mask: (N, C).
    Landmarks start from DLT triangulation under the initial poses.
    Returns the cameras and cost on the tail device, and this process's
    landmarks gathered there in point order (in one process, all of
    them).  ``stats``, when given, gets ``iterations``: the steps run.
    """
    tail = mesh.tail_device
    num_cameras = pts.shape[1]
    K_stack = torch.as_tensor(K_stack).to(tail)
    Rs0 = torch.as_tensor(Rs0).to(tail)
    ts0 = torch.as_tensor(ts0).to(tail)
    cam_p = ba_ops.pack_params(Rs0, ts0, K_stack[:, 0, 0])
    nparam = cam_p.shape[0]
    Ps0 = projection_matrix(K_stack, Rs0, ts0)
    # each shard's observations, mask, intrinsics and landmarks on its
    # device
    shards = []
    for sp, sm in zip(shard_along(mesh, axis, pts),
                      shard_along(mesh, axis, mask)):
        X0, _ = tri.triangulate_points(sp, Ps0.to(sp.device), sm)
        shards.append([sp, sm, K_stack.to(sp.device), X0])

    def res_one(p, x, o, m, K):
        return _point_residual(p, x, o, m, K, num_cameras)

    def local_cost(p, X, sp, sm, sK):
        r = vmap(res_one, in_dims=(None, 0, 0, 0, None))(p, X, sp, sm, sK)
        return robust_cost(r, cauchy_c)

    def global_cost(p, Xs):
        return mesh.sum_shards([
            local_cost(p.to(sp.device), X, sp, sm, sK)
            for (sp, sm, sK, _), X in zip(shards, Xs)])

    def blocks_one(p, x, o, m, K):
        r = res_one(p, x, o, m, K)
        Jc = jacfwd(res_one, argnums=0)(p, x, o, m, K)          # (2C, P)
        Jp = jacfwd(res_one, argnums=1)(p, x, o, m, K)          # (2C, 3)
        w = 1.0 / (1.0 + (r / cauchy_c) ** 2)
        Jcw = Jc * w[:, None]
        Jpw = Jp * w[:, None]
        return (Jcw.T @ Jc, Jpw.T @ Jp, Jcw.T @ Jp, Jcw.T @ r, Jpw.T @ r)

    blocks = vmap(blocks_one, in_dims=(None, 0, 0, 0, None))
    lam = torch.tensor(1e-3, dtype=cam_p.dtype, device=tail)
    cost = global_cost(cam_p, [s[3] for s in shards])
    n_acc = torch.zeros((), dtype=torch.int64, device=tail)
    steps = 0
    eye = torch.eye(nparam, dtype=cam_p.dtype, device=tail)
    for _ in range(max_iters):
        parts, local = [], []
        for sp, sm, sK, X in shards:
            p_s = cam_p.to(sp.device)
            Hcc, Hpp, Hcp, gc, gp = blocks(p_s, X, sp, sm, sK)
            lam_s = lam.to(sp.device)
            Hpp_inv = torch.linalg.inv(
                Hpp + lam_s * torch.eye(3, dtype=X.dtype, device=X.device))
            S = Hcc.sum(dim=0) - torch.einsum("nij,njk,nlk->il", Hcp,
                                              Hpp_inv, Hcp)
            rhs = gc.sum(dim=0) - torch.einsum("nij,njk,nk->i", Hcp,
                                               Hpp_inv, gp)
            # S and its right-hand side side by side: one gather a step
            parts.append(torch.cat([S, rhs[:, None]], dim=1))
            local.append((Hcp, Hpp_inv, gp))
        Sr = mesh.sum_shards(parts)
        dc = torch.linalg.solve_ex(Sr[:, :nparam] + lam * eye,
                                   -Sr[:, nparam])[0]
        X1s = []
        for (sp, _, _, X), (Hcp, Hpp_inv, gp) in zip(shards, local):
            dc_s = dc.to(sp.device)
            dX = -torch.einsum("nij,nj->ni", Hpp_inv,
                               gp + torch.einsum("nij,i->nj", Hcp, dc_s))
            X1s.append(X + dX)
        cam_p1 = cam_p + dc
        accept, done, lam, cost = lm_step(lam, cost,
                                          global_cost(cam_p1, X1s), ftol)
        cam_p = torch.where(accept, cam_p1, cam_p)
        for s, X1 in zip(shards, X1s):
            s[3] = torch.where(accept.to(X1.device), X1, s[3])
        n_acc = n_acc + accept
        steps += 1
        if bool(done):       # the loop's one read from the device
            break
    if stats is not None:
        stats["iterations"] = steps
    Rs, ts, focals = ba_ops.unpack_params(cam_p, num_cameras)
    points = torch.cat([s[3].to(tail) for s in shards])
    return SchurBAResult(Rs, ts, focals, points, cost, n_acc)
