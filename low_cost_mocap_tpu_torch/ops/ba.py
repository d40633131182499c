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
is kept: one LM iteration is a step over a carry of device tensors
(``LMState``: the parameters, the damping, the cost, ``done``, the
accepted steps, the iteration counter and the budget), which freezes once
``done`` is set or the budget is spent.  ``CHUNK`` iterations are one
``runtime.compiled.ChunkedScan`` step, a CUDA graph on the card (op by op
on the CPU and inside ``compiled.disable_graphs()``), replayed
``ceil(max_iters / CHUNK)`` times with one read of ``done`` between two
chunks.  Because the carry is frozen, the iterations a chunk runs past
``done`` change nothing: the result is the one of a loop that stops at
the first converged step, over the same buffers.

The graphs are kept per bucket of the point count: the points are padded
with masked points (zero residuals, zero Jacobian rows) to the next power
of two up to ``BUCKET`` and the next multiple of ``BUCKET`` above it
(``bucket``), so a new wand capture of another size reuses the graph of
its bucket.  The damped solve uses ``torch.linalg.solve_ex``,
which does not check for a singular system on the host (a failed solve
gives non-finite values, whose cost is rejected).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple

import torch
from torch.func import jacfwd

from low_cost_mocap_tpu_torch.ops import rotations as rot
from low_cost_mocap_tpu_torch.ops import triangulate as tri
from low_cost_mocap_tpu_torch.ops.camera import projection_matrix
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.utils.tree import tree_map

CHUNK = 8        # LM iterations a graph holds (the Engine's progress_chunk)
BUCKET = 512     # point counts above it pad to a multiple of it (bucket)
# the LM chunks by (bucket, cameras, options, device); _LOCK lets one call
# at a time use them and their buffers
_STEPS = compiled.GraphCache()
_LOCK = threading.RLock()


class BAResult(NamedTuple):
    Rs: torch.Tensor          # (C, 3, 3)
    ts: torch.Tensor          # (C, 3)
    focals: torch.Tensor      # (C,)
    cost: torch.Tensor        # final robust cost
    n_iters: torch.Tensor     # accepted iterations


class LMState(NamedTuple):
    """The carry of one LM iteration, all device tensors."""
    p: torch.Tensor           # (P,) parameters
    lam: torch.Tensor         # () damping
    cost: torch.Tensor        # () robust cost at p
    done: torch.Tensor        # () bool: converged
    n_acc: torch.Tensor       # () int64: accepted steps
    it: torch.Tensor          # () int64: iterations run before stopping
    budget: torch.Tensor      # () int64: max_iters


def lm_start(p, cost, max_iters: int, lam: float = 1e-3) -> LMState:
    """The carry before the first iteration."""
    dev = p.device
    return LMState(p, torch.tensor(lam, dtype=p.dtype, device=dev), cost,
                   torch.zeros((), dtype=torch.bool, device=dev),
                   torch.zeros((), dtype=torch.int64, device=dev),
                   torch.zeros((), dtype=torch.int64, device=dev),
                   torch.tensor(int(max_iters), device=dev))


def lm_advance(st: LMState, p1, c1, *, tol: float, lam_min: float = 1e-10,
               lam_up: float = 4.0, cost_min: float = 1e-12):
    """The accept/reject of one LM iteration from the trial parameters
    ``p1`` and their cost ``c1``: the step is taken when the cost falls,
    the damping shrinks 0.3x (down to ``lam_min``) or grows ``lam_up``x,
    and ``done`` is set by an accepted step whose relative decrease is
    under ``tol``.  Nothing changes once the loop has stopped (``done``,
    or ``it`` at the budget), as the JAX package's scan freezes its carry.
    Returns (the new carry, the step taken)."""
    live = ~(st.done | (st.it >= st.budget))
    accept = c1 < st.cost
    rel = (st.cost - c1) / torch.clamp_min(st.cost, cost_min)
    lam = torch.where(accept, torch.clamp_min(st.lam * 0.3, lam_min),
                      st.lam * lam_up)
    take = accept & live
    return LMState(torch.where(take, p1, st.p), torch.where(live, lam, st.lam),
                   torch.where(take, c1, st.cost),
                   st.done | (live & accept & (rel < tol)),
                   st.n_acc + take, st.it + live, st.budget), take


def stopped(carry):
    """An LM loop's stop flag, ``done`` (the ``ChunkedScan`` ``stop`` of
    the solvers; the Schur solver's carry holds its landmarks too)."""
    return _lm(carry).done


def lm_run(key, build, carry: LMState, max_iters: int, consts, *,
           cache: compiled.GraphCache, stats: dict | None = None,
           graphs: bool = True):
    """Run an LM loop from ``carry``: the chunk of ``key`` (built by
    ``build()`` as a ``ChunkedScan`` with ``stop=stopped`` at its first
    use, kept in ``cache``) replayed until ``done`` or ``max_iters``
    iterations.  ``graphs=False``
    runs it op by op (a mesh whose shards span processes or devices).
    Returns a copy of the final carry.  ``stats``, when given, gets
    ``iterations`` (the iterations run until ``done``, the one that set it
    included, at most ``max_iters``), ``chunks`` (the chunks run) and
    ``reads`` (the reads of ``done`` between them)."""
    loop = cache.get(key, build) if graphs else build()
    chunks, reads = loop.chunks, loop.reads
    with contextlib.nullcontext() if graphs else compiled.disable_graphs():
        st = loop.run_until(carry, max_iters, *consts)
    st = tree_map(torch.clone, st)
    if stats is not None:
        stats["iterations"] = int(_lm(st).it)
        stats["chunks"] = loop.chunks - chunks
        stats["reads"] = loop.reads - reads
    return st


def _lm(carry) -> LMState:
    """The LM state of a carry (the Schur solver's holds its landmarks
    too)."""
    return carry if isinstance(carry, LMState) else carry[0]


def bucket(n: int) -> int:
    """The padded count of ``n`` points: the next power of two up to
    ``BUCKET``, the next multiple of ``BUCKET`` above it."""
    n = max(int(n), 1)
    if n <= BUCKET:
        return 1 << (n - 1).bit_length()
    return -(-n // BUCKET) * BUCKET


def pad_points(pts, mask, n: int):
    """(N, C, 2) points and (N, C) mask padded to ``n`` points with
    masked zeros."""
    N = pts.shape[0]
    if N == n:
        return pts, mask
    pp = pts.new_zeros((n,) + tuple(pts.shape[1:]))
    pm = mask.new_zeros((n,) + tuple(mask.shape[1:]))
    pp[:N], pm[:N] = pts, mask
    return pp, pm


def cached_steps() -> list:
    """The compiled LM chunks the cache holds."""
    return [s.step for s in _STEPS.values()]


def clear_cache() -> None:
    """Drop every cached LM chunk and its graph."""
    with _LOCK:
        _STEPS.clear()


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


def robust_cost(r, cauchy_c: float):
    """Cauchy cost: sum c^2/2 log(1 + (r/c)^2)."""
    return 0.5 * cauchy_c ** 2 * torch.log1p((r / cauchy_c) ** 2).sum()


def _iteration(st: LMState, pts, mask, K_stack, free_mask, *,
               num_cameras: int, mode: str, cauchy_c: float, tol: float,
               freeze_focals: bool) -> LMState:
    """One LM iteration over the (padded) points."""
    def res_with_aux(q):
        r = residuals(q, pts, mask, K_stack, num_cameras, mode)
        return r, r

    J, r = jacfwd(res_with_aux, has_aux=True)(st.p)            # (M, P)
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
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    delta = torch.linalg.solve_ex(H + st.lam * eye, -g)[0] * free_mask
    p1 = st.p + delta
    c1 = robust_cost(residuals(p1, pts, mask, K_stack, num_cameras, mode),
                     cauchy_c)
    return lm_advance(st, p1, c1, tol=tol)[0]


def bundle_adjust(pts, mask, K_stack, Rs0, ts0, *, num_cameras: int,
                  max_iters: int = 64, ftol: float = 1e-2,
                  cauchy_c: float = 1.0, mode: str = "pixel",
                  freeze_focals: bool = False, stats: dict | None = None
                  ) -> BAResult:
    """Robust LM bundle adjustment from an initial pose chain.

    ``freeze_focals`` keeps the focal lengths at K_stack's (extrinsics-only
    refinement, as live recalibration needs).  The points are padded to
    ``bucket(N)``; the LM chunk of that bucket runs ``ceil(max_iters /
    CHUNK)`` times at most, and a call at a bucket no call has used runs
    its first chunk op by op (its graph is captured at the next call).
    ``stats``, when given, gets ``iterations``: the LM iterations run
    until ``done``, accepted or not, the one that set it included, at most
    ``max_iters`` (the same in every solver of the port); and ``chunks``
    and ``reads`` (``lm_run``).
    """
    dev, dt = pts.device, pts.dtype
    nb = bucket(pts.shape[0])
    pts_b, mask_b = pad_points(pts, mask, nb)
    p0 = pack_params(Rs0, ts0, K_stack[:, 0, 0])
    nparam = p0.shape[0]
    free_mask = torch.ones(nparam, dtype=dt, device=dev)
    if freeze_focals:
        focal_pos = [0] + [1 + i * 7 for i in range(num_cameras - 1)]
        free_mask[focal_pos] = 0.0
    consts = (pts_b, mask_b, K_stack, free_mask)
    key = (nb, num_cameras, mode, bool(freeze_focals), float(ftol),
           float(cauchy_c), CHUNK, dev, dt)
    with _LOCK:
        carry = lm_start(p0, robust_cost(residuals(
            p0, pts_b, mask_b, K_stack, num_cameras, mode), cauchy_c),
            max_iters)
        st = lm_run(key, lambda: compiled.ChunkedScan(
            functools.partial(_iteration, num_cameras=num_cameras, mode=mode,
                              cauchy_c=cauchy_c, tol=ftol * 1e-2,
                              freeze_focals=freeze_focals),
            carry, (), CHUNK, consts=consts, stop=stopped, lazy=True,
            name="bundle_adjust"), carry, max_iters, consts, cache=_STEPS,
            stats=stats)
    Rs, ts, focals = unpack_params(st.p, num_cameras)
    return BAResult(Rs, ts, focals, st.cost, st.n_acc)
