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
which has no data-dependent branch.  The LM loop is ``ops/ba.py``'s chunk
over a frozen carry, which here holds each shard's landmarks too, in the
layouts of ``dist_ba.run`` (one graph, a graph per device and phase, or op
by op across processes); each shard is padded to ``ba.bucket`` of its size
with masked points (zero residuals and Jacobians: their blocks add
nothing).  The landmark blocks are inverted with ``torch.linalg.inv_ex``,
which does not read its result back to check it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from low_cost_mocap_tpu_torch.ops import ba as ba_ops
from low_cost_mocap_tpu_torch.ops import triangulate as tri
from low_cost_mocap_tpu_torch.ops.ba import robust_cost
from low_cost_mocap_tpu_torch.ops.camera import projection_matrix
from low_cost_mocap_tpu_torch.parallel import dist_ba
from low_cost_mocap_tpu_torch.parallel.mesh import Mesh
from low_cost_mocap_tpu_torch.runtime import compiled

_STEPS = compiled.GraphCache()


class SchurBAResult(NamedTuple):
    Rs: torch.Tensor
    ts: torch.Tensor
    focals: torch.Tensor
    points: torch.Tensor     # (N, 3) refined landmarks
    cost: torch.Tensor
    n_iters: torch.Tensor


def cached_steps() -> list:
    """The compiled steps of the LM chunks the cache holds."""
    return [st for s in _STEPS.values()
            for st in getattr(s.step, "steps", (s.step,))]


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


def _costs(p, Xs, shards, *, num_cameras, cauchy_c):
    """Each shard's robust cost at cameras ``p`` and landmarks ``Xs``."""
    def res_one(q, x, o, m, K):
        return _point_residual(q, x, o, m, K, num_cameras)

    return tuple(robust_cost(vmap(res_one, in_dims=(None, 0, 0, 0, None))(
        p.to(sp.device), X, sp, sm, sK), cauchy_c)
        for (sp, sm, sK), X in zip(shards, Xs))


def _head(p, lam, Xs, shards, *, num_cameras, cauchy_c):
    """Each shard's Schur complement and right-hand side [S | rhs], and
    what its back-substitution needs: (Hcp, Hpp^-1, gp)."""
    def res_one(q, x, o, m, K):
        return _point_residual(q, x, o, m, K, num_cameras)

    def blocks_one(q, x, o, m, K):
        r = res_one(q, x, o, m, K)
        Jc = jacfwd(res_one, argnums=0)(q, x, o, m, K)          # (2C, P)
        Jp = jacfwd(res_one, argnums=1)(q, x, o, m, K)          # (2C, 3)
        w = 1.0 / (1.0 + (r / cauchy_c) ** 2)
        Jcw = Jc * w[:, None]
        Jpw = Jp * w[:, None]
        return (Jcw.T @ Jc, Jpw.T @ Jp, Jcw.T @ Jp, Jcw.T @ r, Jpw.T @ r)

    blocks = vmap(blocks_one, in_dims=(None, 0, 0, 0, None))
    parts, local = [], []
    for (sp, sm, sK), X in zip(shards, Xs):
        Hcc, Hpp, Hcp, gc, gp = blocks(p.to(sp.device), X, sp, sm, sK)
        Hpp_inv = torch.linalg.inv_ex(Hpp + lam.to(sp.device) * torch.eye(
            3, dtype=X.dtype, device=X.device))[0]
        S = Hcc.sum(dim=0) - torch.einsum("nij,njk,nlk->il", Hcp, Hpp_inv,
                                          Hcp)
        rhs = gc.sum(dim=0) - torch.einsum("nij,njk,nk->i", Hcp, Hpp_inv, gp)
        # S and its right-hand side side by side: one gather a step
        parts.append(torch.cat([S, rhs[:, None]], dim=1))
        local.append((Hcp, Hpp_inv, gp))
    return tuple(parts), tuple(local)


def _reduce(st, Sr):
    """The reduced camera solve: (trial cameras, their step dc)."""
    nparam = st.p.shape[0]
    eye = torch.eye(nparam, dtype=st.p.dtype, device=st.p.device)
    dc = torch.linalg.solve_ex(Sr[:, :nparam] + st.lam * eye,
                               -Sr[:, nparam])[0]
    return st.p + dc, dc


def _trial(moves, Xs, local, shards, **kw):
    """Each shard's landmarks back-substituted, and its cost there."""
    p1, dc = moves
    X1s = []
    for X, (Hcp, Hpp_inv, gp) in zip(Xs, local):
        dX = -torch.einsum("nij,nj->ni", Hpp_inv, gp + torch.einsum(
            "nij,i->nj", Hcp, dc.to(X.device)))
        X1s.append(X + dX)
    return _costs(p1, X1s, shards, **kw), tuple(X1s)


def _keep(Xs, take, X1s):
    """The landmarks of a taken step."""
    return tuple(torch.where(take.to(X1.device), X1, X)
                 for X1, X in zip(X1s, Xs))


def schur_bundle_adjust(mesh: Mesh, pts, mask, K_stack, Rs0, ts0, *,
                        axis: str = "point", max_iters: int = 64,
                        ftol: float = 1e-2, cauchy_c: float = 1.0,
                        stats: dict | None = None) -> SchurBAResult:
    """Distributed free-point BA.

    pts: (N, C, 2), N divisible by the ``axis`` size; mask: (N, C).
    Landmarks start from DLT triangulation under the initial poses.
    Returns the cameras and cost on the tail device, and this process's
    landmarks gathered there in point order (in one process, all of
    them).  ``stats``, when given, gets ``iterations`` (the LM iterations
    run until ``done``, the one that set it included, at most
    ``max_iters``), ``chunks`` and ``reads`` (``ops.ba.lm_run``).
    """
    tail = mesh.tail_device
    num_cameras = pts.shape[1]
    K_stack = torch.as_tensor(K_stack).to(tail)
    Rs0 = torch.as_tensor(Rs0).to(tail)
    ts0 = torch.as_tensor(ts0).to(tail)
    cam_p = ba_ops.pack_params(Rs0, ts0, K_stack[:, 0, 0])
    Ps0 = projection_matrix(K_stack, Rs0, ts0)
    shards, n = dist_ba.padded_shards(mesh, axis, pts, mask, K_stack)
    # each shard's landmarks on its device (a padded point's are zero)
    Xs = tuple(tri.triangulate_points(sp, Ps0.to(sp.device), sm)[0]
               for sp, sm, _ in shards)
    kw = dict(num_cameras=num_cameras, cauchy_c=cauchy_c)
    phases = (functools.partial(_head, **kw), _reduce,
              functools.partial(_trial, **kw), _keep)
    lay = dist_ba.layout(mesh, axis)
    devices = tuple(d for _, d in mesh.axis_shards(axis))
    key = (lay, shards[0][0].shape[0], num_cameras, float(ftol),
           float(cauchy_c), ba_ops.CHUNK, devices, cam_p.device, cam_p.dtype)
    with ba_ops._LOCK:
        c0 = mesh.sum_shards(list(_costs(cam_p, Xs, shards, **kw)))
        st, Xs = dist_ba.run(
            key, (ba_ops.lm_start(cam_p, c0, max_iters), Xs), shards,
            devices, max_iters, mesh=mesh, lay=lay, phases=phases,
            tol=ftol * 1e-2, cache=_STEPS, stats=stats,
            name="schur_bundle_adjust")
    Rs, ts, focals = ba_ops.unpack_params(st.p, num_cameras)
    points = torch.cat([X[:n].to(tail) for X in Xs])
    return SchurBAResult(Rs, ts, focals, points, st.cost, st.n_acc)
