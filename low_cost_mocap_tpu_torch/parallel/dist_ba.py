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
camera system that remains is what the shards sum.  The LM loop is
``ops/ba.py``'s: a chunk of ``ba.CHUNK`` iterations over a frozen carry,
replayed until ``done`` with one read between two chunks.  Each shard is
padded to ``ba.bucket`` of its size.  How the chunk runs is decided when
the call starts (``layout``):

- every shard on the tail device, in one process: one CUDA graph, kept
  per (bucket, cameras, options, devices);
- shards on several devices, in one process: ``SplitChunk``, the layout of
  the camera-sharded mesh step, a graph per shard device and phase, the
  copies between devices and the tail's graphs;
- across processes (a ``torch.distributed`` group, whose collectives a
  graph cannot hold): the same chunk op by op.

An iteration is four phases, shared by every layout and by the Schur
solver: each shard's part of the reduced system (``head``), the ordered
sum and the damped solve (``reduce``), each shard's trial cost
(``trial``), and the accept/reject (``ops.ba.lm_advance``).
"""

from __future__ import annotations

import functools

import torch
from torch.func import jacfwd

from low_cost_mocap_tpu_torch.ops import ba as ba_ops
from low_cost_mocap_tpu_torch.ops.ba import robust_cost
from low_cost_mocap_tpu_torch.parallel.mesh import Mesh, shard_along
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.utils.tree import tree_map

_STEPS = compiled.GraphCache()


def cached_steps() -> list:
    """The compiled steps of the LM chunks the cache holds."""
    return [st for s in _STEPS.values()
            for st in getattr(s.step, "steps", (s.step,))]


def padded_shards(mesh: Mesh, axis: str, pts, mask, K_stack):
    """This process's shards of the points and mask, each padded to the
    bucket of the shard size, with the intrinsics on each shard's device:
    ((points, mask, K) a shard, the real points a shard)."""
    sps, sms = shard_along(mesh, axis, pts), shard_along(mesh, axis, mask)
    nb = ba_ops.bucket(sps[0].shape[0])
    return tuple((*ba_ops.pad_points(sp, sm, nb), K_stack.to(sp.device))
                 for sp, sm in zip(sps, sms)), sps[0].shape[0]


def layout(mesh: Mesh, axis: str) -> str:
    """How a solve on ``mesh`` runs its chunk: ``"graph"`` (every shard on
    the tail device, one process), ``"split"`` (several devices, one
    process) or ``"eager"`` (across processes)."""
    if mesh.distributed:
        return "eager"
    devs = [d for _, d in mesh.axis_shards(axis)]
    return "graph" if all(d == mesh.tail_device for d in devs) else "split"


def ordered_sum(stacked):
    """The sum over the leading axis, one row at a time in order (the
    order of ``Mesh.sum_shards``)."""
    acc = stacked[0]
    for i in range(1, stacked.shape[0]):
        acc = acc + stacked[i]
    return acc


def run(key, carry, shards, devices, max_iters, *, mesh, lay, phases,
        tol, cache, stats, name):
    """The LM loop of a sharded solver in its layout (``ops.ba.lm_run``):
    ``phases`` the solver's (head, reduce, trial, keep) functions, ``keep``
    None without landmarks in the carry; ``tol`` ``lm_advance``'s."""
    head, reduce, trial, keep = phases

    def iteration(c, sh):
        st, xs = c if keep else (c, ())
        parts, local = head(st.p, st.lam, xs, sh)
        moves = reduce(st, mesh.sum_shards(list(parts)))
        costs, x1 = trial(moves, xs, local, sh)
        st, take = ba_ops.lm_advance(st, moves[0], mesh.sum_shards(
            list(costs)), tol=tol)
        return (st, keep(xs, take, x1)) if keep else st

    def build():
        if lay == "split":
            return compiled.ChunkedScan(None, carry, (), ba_ops.CHUNK,
                                        stop=ba_ops.stopped,
                                        chunk=SplitChunk(
                                            carry, shards, devices,
                                            ba_ops.CHUNK, phases, tol=tol,
                                            name=name))
        return compiled.ChunkedScan(iteration, carry, (), ba_ops.CHUNK,
                                    consts=(shards,), stop=ba_ops.stopped,
                                    lazy=True, name=name)

    return ba_ops.lm_run(key, build, carry, max_iters, (shards,),
                         cache=cache, stats=stats, graphs=lay != "eager")


class SplitChunk:
    """``ba.CHUNK`` LM iterations of a sharded solver whose shards lie on
    several devices of one process, laid out as the camera-sharded mesh
    step is (``runtime/engine.py:_ShardedStep``).  An iteration: each
    shard device's graph of its shards' ``head``, the parts copied into
    the tail's buffer, the tail's graph of the ordered sum and ``reduce``,
    its results copied to each shard device, each device's graph of its
    shards' ``trial``, the costs copied to the tail, the tail's graph of
    the accept/reject, and, with landmarks, each device's graph of
    ``keep``.  A copy between two cards waits for both cards' current
    streams (PyTorch's rule).  Called like a ``CompiledStep``: (carry,
    shards) -> (the carry buffers, ()).  Every step is lazy (its first
    call op by op, the capture at its second)."""

    def __init__(self, carry, shards, devices, length, phases, *, tol,
                 name):
        self.length, self.name = length, name
        head, reduce, trial, keep = phases
        self.keep = keep
        self.state = tree_map(torch.clone, carry)
        self.args = (tuple(tree_map(torch.clone, s) for s in shards),)
        st, xs = self.state if keep else (self.state, ())
        groups: dict = {}
        for k, d in enumerate(devices):
            groups.setdefault(d, []).append(k)
        self.groups = list(groups.values())
        names = [str(d) for d in groups]
        P = st.p.shape[0]
        self.parts = torch.empty((len(shards), P, P + 1), dtype=st.p.dtype,
                                 device=st.p.device)
        self.costs = torch.empty((len(shards),), dtype=st.p.dtype,
                                 device=st.p.device)

        def step(fn):
            return lambda state, *a: (state, fn(*a))

        self.names = names
        self.heads, self.trials, self.keeps = [], [], []
        for idx, where in zip(self.groups, names):
            dev = self.args[0][idx[0]][0].device
            sh = tuple(self.args[0][k] for k in idx)
            x = tuple(xs[k] for k in idx) if keep else ()
            self.heads.append(compiled.CompiledStep(
                step(head), (), torch.empty_like(st.p, device=dev),
                torch.empty_like(st.lam, device=dev), x, sh, lazy=True,
                name=f"{name} head {where}"))
            self.trials.append(None)      # built at the first iteration
            if keep:
                self.keeps.append(compiled.CompiledStep(
                    lambda xs_, take, x1: (keep(xs_, take, x1), ()), x,
                    torch.empty_like(st.done, device=dev),
                    tuple(torch.empty_like(t) for t in x), lazy=True,
                    name=f"{name} keep {where}"))
        self.reduce = compiled.CompiledStep(
            step(lambda s, g: reduce(s, ordered_sum(g))), (), st,
            self.parts, lazy=True, name=f"{name} reduce")
        self.advance = compiled.CompiledStep(
            lambda s, p1, c: ba_ops.lm_advance(s, p1, ordered_sum(c),
                                               tol=tol),
            st, torch.empty_like(st.p), self.costs, lazy=True,
            name=f"{name} advance")
        self._trial = trial

    @property
    def steps(self) -> tuple:
        return tuple(s for s in (*self.heads, *self.trials, *self.keeps,
                                 self.reduce, self.advance) if s is not None)

    def __call__(self, carry, shards):
        compiled.assign(self.state, carry)
        compiled.assign(self.args[0], shards)
        st, xs = self.state if self.keep else (self.state, ())
        for _ in range(self.length):
            locals_ = []
            for idx, head in zip(self.groups, self.heads):
                _, (parts, local) = head((), st.p, st.lam, *head.args[2:])
                for k, part in zip(idx, parts):
                    self.parts[k].copy_(part)
                locals_.append(local)
            _, moves = self.reduce((), st, self.parts)
            x1s = []
            for g, (idx, head, local) in enumerate(
                    zip(self.groups, self.heads, locals_)):
                if self.trials[g] is None:
                    dev = head.args[0].device
                    self.trials[g] = compiled.CompiledStep(
                        lambda state, *a: (state, self._trial(*a)), (),
                        tuple(torch.empty_like(m, device=dev)
                              for m in moves), head.args[2],
                        tree_map(torch.empty_like, local), head.args[3],
                        lazy=True, name=f"{self.name} trial {self.names[g]}")
                trial = self.trials[g]
                _, (costs, x1) = trial((), moves, trial.args[1], local,
                                       trial.args[3])
                for k, c in zip(idx, costs):
                    self.costs[k].copy_(c)
                x1s.append(x1)
            _, take = self.advance(st, moves[0], self.costs)
            for keep, x1 in zip(self.keeps, x1s):
                keep(keep.state, take, x1)
        return self.state, ()


def _head(p, lam, xs, shards, *, num_cameras, mode, cauchy_c):
    """Each shard's normal equations [H | g] at ``p``: J_iᵀ W J_i and
    J_iᵀ W r_i side by side, one tensor a shard to gather."""
    parts = []
    for sp, sm, sK in shards:
        def res_with_aux(q, sp=sp, sm=sm, sK=sK):
            r = ba_ops.residuals(q, sp, sm, sK, num_cameras, mode)
            return r, r

        J, r = jacfwd(res_with_aux, has_aux=True)(p.to(sp.device))
        w = 1.0 / (1.0 + (r / cauchy_c) ** 2)
        Jw = J * w[:, None]
        parts.append(torch.cat([Jw.T @ J, (Jw.T @ r)[:, None]], dim=1))
    return tuple(parts), ()


def _reduce(st, Hg):
    """The damped solve of the summed normal equations: (trial point,)."""
    nparam = st.p.shape[0]
    eye = torch.eye(nparam, dtype=st.p.dtype, device=st.p.device)
    return (st.p + torch.linalg.solve_ex(
        Hg[:, :nparam] + st.lam * eye, -Hg[:, nparam])[0],)


def _trial(moves, xs, local, shards, *, num_cameras, mode, cauchy_c):
    """Each shard's robust cost at the trial point."""
    p1 = moves[0]
    return tuple(robust_cost(ba_ops.residuals(
        p1.to(sp.device), sp, sm, sK, num_cameras, mode), cauchy_c)
        for sp, sm, sK in shards), ()


def dist_bundle_adjust(mesh: Mesh, pts, mask, K_stack, Rs0, ts0, *,
                       axis: str = "point", max_iters: int = 64,
                       ftol: float = 1e-2, cauchy_c: float = 1.0,
                       mode: str = "pixel", stats: dict | None = None
                       ) -> ba_ops.BAResult:
    """Distributed BA over a device mesh.

    pts: (N, C, 2) with N divisible by the mesh ``axis`` size; mask:
    (N, C).  ``K_stack``, ``Rs0`` and ``ts0`` are moved to the tail device.
    Returns the single-device solver's ``BAResult`` there.  ``stats``,
    when given, gets ``iterations`` (the LM iterations run until ``done``,
    the one that set it included, at most ``max_iters``), ``chunks`` and
    ``reads`` (``ops.ba.lm_run``).
    """
    tail = mesh.tail_device
    num_cameras = pts.shape[1]
    K_stack = torch.as_tensor(K_stack).to(tail)
    p = ba_ops.pack_params(torch.as_tensor(Rs0).to(tail),
                           torch.as_tensor(ts0).to(tail), K_stack[:, 0, 0])
    shards, _ = padded_shards(mesh, axis, pts, mask, K_stack)
    kw = dict(num_cameras=num_cameras, mode=mode, cauchy_c=cauchy_c)
    phases = (functools.partial(_head, **kw), _reduce,
              functools.partial(_trial, **kw), None)
    lay = layout(mesh, axis)
    devices = tuple(d for _, d in mesh.axis_shards(axis))
    key = (lay, shards[0][0].shape[0], num_cameras, mode, float(ftol),
           float(cauchy_c), ba_ops.CHUNK, devices, p.device, p.dtype)
    with ba_ops._LOCK:
        c0 = mesh.sum_shards(list(phases[2]((p,), (), (), shards)[0]))
        st = run(key, ba_ops.lm_start(p, c0, max_iters), shards, devices,
                 max_iters, mesh=mesh, lay=lay, phases=phases,
                 tol=ftol * 1e-2, cache=_STEPS, stats=stats,
                 name="dist_bundle_adjust")
    Rs, ts, focals = ba_ops.unpack_params(st.p, num_cameras)
    return ba_ops.BAResult(Rs, ts, focals, st.cost, st.n_acc)
