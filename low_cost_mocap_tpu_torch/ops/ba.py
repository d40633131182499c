"""Bundle adjustment: robust Levenberg–Marquardt, written out explicitly.

Counterpart of ``low_cost_mocap_tpu/ops/ba.py``.  Camera 0 is the gauge,
fixed at identity; the parameter vector is
``[f_0, (f_i, rotvec_i(3), t_i(3)) for i = 1..C-1]``.  Points are
re-triangulated from the current poses at every residual evaluation.  Two
residual modes: ``"reference"`` (one residual per point, its mean squared
pixel error) and ``"pixel"`` (one per observed pixel coordinate).
Robustness is a Cauchy loss through IRLS weights in the normal equations.

The Jacobian is ``torch.func.jacfwd`` of the residual function, so every
function on that path is out of place and free of data-dependent Python
branches.  The JAX package's fixed-length ``lax.scan`` with a frozen carry
becomes a Python loop that stops at the first converged step: once
``done`` is set the carry never changes, so stopping there is exact.  The
loop reads one flag from the device per iteration; the damped solve uses
``torch.linalg.solve_ex``, which does not check for a singular system on
the host (a failed solve gives non-finite values, whose cost is rejected).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from low_cost_mocap_tpu_torch.ops import rotations as rot
from low_cost_mocap_tpu_torch.ops import triangulate as tri
from low_cost_mocap_tpu_torch.ops.camera import projection_matrix


class BAResult(NamedTuple):
    Rs: torch.Tensor          # (C, 3, 3)
    ts: torch.Tensor          # (C, 3)
    focals: torch.Tensor      # (C,)
    cost: torch.Tensor        # final robust cost
    n_iters: torch.Tensor     # accepted iterations


def pack_params(Rs, ts, focals):
    """Poses -> parameter vector."""
    rvecs = rot.matrix_to_rotvec(Rs[1:])
    parts = [focals[:1]]
    for i in range(Rs.shape[0] - 1):
        parts += [focals[i + 1:i + 2], rvecs[i], ts[i + 1]]
    return torch.cat(parts)


def unpack_params(params, num_cameras: int):
    """Parameter vector -> (Rs, ts, focals)."""
    focals = [params[0]]
    Rs = [torch.eye(3, dtype=params.dtype, device=params.device)]
    ts = [torch.zeros(3, dtype=params.dtype, device=params.device)]
    for i in range(num_cameras - 1):
        base = 1 + i * 7
        focals.append(params[base])
        Rs.append(rot.rotvec_to_matrix(params[base + 1:base + 4]))
        ts.append(params[base + 4:base + 7])
    return torch.stack(Rs), torch.stack(ts), torch.stack(focals)


def _apply_focals(K_stack, focals):
    """K with fx and fy replaced by each camera's focal (out of place)."""
    f = focals[:, None, None]
    diag = torch.eye(3, dtype=torch.bool, device=K_stack.device)[:2]
    diag = torch.cat([diag, torch.zeros_like(diag[:1])])[None]   # (1, 3, 3)
    return torch.where(diag, f, K_stack)


def residuals(params, pts, mask, K_stack, num_cameras: int, mode: str):
    """BA residual vector.  pts: (N, C, 2); mask: (N, C)."""
    Rs, ts, focals = unpack_params(params, num_cameras)
    Ps = projection_matrix(_apply_focals(K_stack, focals), Rs, ts)
    X, _ = tri.triangulate_points(pts, Ps, mask)
    n_vis = mask.sum(dim=-1)
    if mode == "reference":
        err = tri.reprojection_errors(pts, X, Ps, mask)
        return torch.where(n_vis >= 2, err, torch.zeros_like(err))
    uv = tri.reproject(X, Ps)                                 # (N, C, 2)
    r = (uv - pts) * mask[..., None]
    # points seen by fewer than two views are masked with where: their
    # tangents may be non-finite, and 0 * inf in a multiply is not 0
    r = torch.where((n_vis >= 2)[:, None, None], r, torch.zeros_like(r))
    return r.reshape(-1)


def bundle_adjust(pts, mask, K_stack, Rs0, ts0, *, num_cameras: int,
                  max_iters: int = 64, ftol: float = 1e-2,
                  cauchy_c: float = 1.0, mode: str = "pixel",
                  freeze_focals: bool = False, stats: dict | None = None
                  ) -> BAResult:
    """Robust LM bundle adjustment from an initial pose chain.

    ``freeze_focals`` keeps the focal lengths at K_stack's (extrinsics-only
    refinement, as live recalibration needs).  ``stats``, when given, gets
    ``iterations``: the steps run, accepted or not, each with one read
    from the device.
    """
    dev, dt = pts.device, pts.dtype
    p0 = pack_params(Rs0, ts0, K_stack[:, 0, 0])
    nparam = p0.shape[0]
    free_mask = torch.ones(nparam, dtype=dt, device=dev)
    if freeze_focals:
        focal_pos = [0] + [1 + i * 7 for i in range(num_cameras - 1)]
        free_mask[focal_pos] = 0.0

    def res_fn(p):
        return residuals(p, pts, mask, K_stack, num_cameras, mode)

    def res_with_aux(p):
        r = res_fn(p)
        return r, r

    def robust_cost(r):
        return 0.5 * cauchy_c ** 2 * torch.log1p((r / cauchy_c) ** 2).sum()

    eye = torch.eye(nparam, dtype=dt, device=dev)
    p = p0
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    cost = robust_cost(res_fn(p0))
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    steps = 0
    for _ in range(max_iters):
        J, r = jacfwd(res_with_aux, has_aux=True)(p)           # (M, P)
        w = 1.0 / (1.0 + (r / cauchy_c) ** 2)
        Jw = J * w[:, None]
        H = Jw.T @ J
        g = Jw.T @ r
        if freeze_focals:
            # constrain before the solve: frozen rows/cols of H become the
            # identity and their gradient 0, so the step is the true
            # constrained Newton step
            H = H * (free_mask[:, None] * free_mask[None, :]) \
                + torch.diag(1.0 - free_mask)
            g = g * free_mask
        delta = torch.linalg.solve_ex(H + lam * eye, -g)[0] * free_mask
        p1 = p + delta
        c1 = robust_cost(res_fn(p1))
        accept = c1 < cost
        rel = (cost - c1) / torch.clamp_min(cost, 1e-12)
        done = accept & (rel < ftol * 1e-2)
        p = torch.where(accept, p1, p)
        lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-10), lam * 4.0)
        cost = torch.where(accept, c1, cost)
        n_acc = n_acc + accept
        steps += 1
        if bool(done):       # the loop's one read from the device
            break
    if stats is not None:
        stats["iterations"] = steps
    Rs, ts, focals = unpack_params(p, num_cameras)
    return BAResult(Rs, ts, focals, cost, n_acc)
