"""Mesh-distributed bundle adjustment: point-sharded normal equations.

Counterpart of ``low_cost_mocap_tpu/parallel/dist_ba.py``.  The residual
and Jacobian work distributes over the mesh's ``point`` axis:

- each shard holds a slice of the captured image points on its device;
- per LM iteration every shard computes its residuals r_i, its Jacobian
  block J_i (``torch.func.jacfwd`` of ``ops.ba.residuals``; the parameter
  dimension is small), the Cauchy weights and its part of the normal
  equations, H_i = J_iᵀ W J_i, g_i = J_iᵀ W r_i;
- the parts are gathered and summed in shard order (JAX's one ``psum``),
  so one mesh in one process and the same shards split over processes give
  the same bits; the trial step's cost is reduced the same way;
- the small damped solve and the LM accept/reject run on every process
  from the same reduced numbers, in lockstep.

Points are re-triangulated from the camera parameters at every evaluation,
as in ``ops/ba.py``: the point blocks are eliminated implicitly, and the
camera system that remains is what the shards sum.  The loop stops at the
first converged step (one device read an iteration), which is where the
JAX package's fixed-length scan stops changing its carry.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from low_cost_mocap_tpu_torch.ops import ba as ba_ops
from low_cost_mocap_tpu_torch.parallel.mesh import Mesh, shard_along


def robust_cost(r, cauchy_c: float):
    return 0.5 * cauchy_c ** 2 * torch.log1p((r / cauchy_c) ** 2).sum()


def lm_step(lam, cost, c1, ftol: float):
    """The LM damping and acceptance of one step from the reduced costs:
    (accept, done, new lambda, new cost)."""
    accept = c1 < cost
    rel = (cost - c1) / torch.clamp_min(cost, 1e-12)
    done = accept & (rel < ftol * 1e-2)
    lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-10), lam * 4.0)
    return accept, done, lam, torch.where(accept, c1, cost)


def dist_bundle_adjust(mesh: Mesh, pts, mask, K_stack, Rs0, ts0, *,
                       axis: str = "point", max_iters: int = 64,
                       ftol: float = 1e-2, cauchy_c: float = 1.0,
                       mode: str = "pixel", stats: dict | None = None
                       ) -> ba_ops.BAResult:
    """Distributed BA over a device mesh.

    pts: (N, C, 2) with N divisible by the mesh ``axis`` size; mask:
    (N, C).  ``K_stack``, ``Rs0`` and ``ts0`` are moved to the tail device.
    Returns the single-device solver's ``BAResult`` there.  ``stats``,
    when given, gets ``iterations``: the steps run, accepted or not.
    """
    tail = mesh.tail_device
    num_cameras = pts.shape[1]
    K_stack = torch.as_tensor(K_stack).to(tail)
    p = ba_ops.pack_params(torch.as_tensor(Rs0).to(tail),
                           torch.as_tensor(ts0).to(tail), K_stack[:, 0, 0])
    # each shard's points, mask and intrinsics on its device
    shards = [(sp, sm, K_stack.to(sp.device)) for sp, sm in zip(
        shard_along(mesh, axis, pts), shard_along(mesh, axis, mask))]

    def res_fn(params, sp, sm, sK):
        return ba_ops.residuals(params, sp, sm, sK, num_cameras, mode)

    def global_cost(params):
        return mesh.sum_shards([
            robust_cost(res_fn(params.to(sp.device), sp, sm, sK), cauchy_c)
            for sp, sm, sK in shards])

    def normal_parts(params):
        parts = []
        for sp, sm, sK in shards:
            ps = params.to(sp.device)
            J, r = jacfwd(lambda q: (res_fn(q, sp, sm, sK),) * 2,
                          has_aux=True)(ps)
            w = 1.0 / (1.0 + (r / cauchy_c) ** 2)
            Jw = J * w[:, None]
            # H and g side by side: one tensor a shard to gather
            parts.append(torch.cat([Jw.T @ J, (Jw.T @ r)[:, None]], dim=1))
        return parts

    nparam = p.shape[0]
    eye = torch.eye(nparam, dtype=p.dtype, device=tail)
    lam = torch.tensor(1e-3, dtype=p.dtype, device=tail)
    cost = global_cost(p)
    n_acc = torch.zeros((), dtype=torch.int64, device=tail)
    steps = 0
    for _ in range(max_iters):
        Hg = mesh.sum_shards(normal_parts(p))
        H, g = Hg[:, :nparam], Hg[:, nparam]
        delta = torch.linalg.solve_ex(H + lam * eye, -g)[0]
        p1 = p + delta
        accept, done, lam, cost_new = lm_step(lam, cost, global_cost(p1),
                                              ftol)
        p = torch.where(accept, p1, p)
        cost = cost_new
        n_acc = n_acc + accept
        steps += 1
        if bool(done):       # the loop's one read from the device
            break
    if stats is not None:
        stats["iterations"] = steps
    Rs, ts, focals = ba_ops.unpack_params(p, num_cameras)
    return ba_ops.BAResult(Rs, ts, focals, cost, n_acc)
