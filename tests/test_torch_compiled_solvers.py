"""PyTorch port: the solvers' compiled programs on the CPU — bundle
adjustment (``ops/ba.py``), the point-sharded and Schur solvers
(``parallel/dist_ba.py``, ``parallel/schur_ba.py``), intrinsics refinement
(``ops/intrinsics.py:refine``), time sharding (``parallel/temporal.py``)
and the two helper jits (``parallel/multiprocess.py``'s rts-assoc
reference, ``utils/differential.py``'s tracking step).

Each LM solver runs ``CHUNK`` iterations a step over a frozen carry,
replayed until ``done`` (a CUDA graph on the card, the same step op by op
on the CPU).  Held here:

- bitwise, against the loop the port ran before, which stops at the first
  converged iteration and reads ``done`` after each (kept below as
  ``*_loop``), over the same padded buffers, at ``max_iters`` 1, 8, 15
  and 64;
- padded to a bucket, against the same loop on the unpadded points and
  against the JAX solver, within the tolerances the port's tests hold
  each solver to against JAX (``tests/test_torch_calibration.py``, BA:
  rotations and unit translations 1e-3, mean error 1e-3;
  ``tests/test_torch_parallel.py``: costs rtol 1e-3;
  ``tests/test_torch_intrinsics.py``: K relative 1e-3);
- ``process_sequence``, ``smooth_sharded`` and the two helpers bitwise
  equal to their op-by-op calls; the caches keyed by shape.

The graphs themselves are held to ``compiled.disable_graphs()`` by the
``cuda`` cases of ``tests/test_torch_compiled.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from low_cost_mocap_tpu.ops import ba as jba
from low_cost_mocap_tpu.ops import intrinsics as jintr
from low_cost_mocap_tpu.parallel import mesh as jmesh
from low_cost_mocap_tpu.parallel.dist_ba import dist_bundle_adjust as jdist
from low_cost_mocap_tpu.parallel.schur_ba import \
    schur_bundle_adjust as jschur
from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.models.pipeline import track_from_blobs
from low_cost_mocap_tpu_torch.ops import ba, camera, intrinsics, kalman
from low_cost_mocap_tpu_torch.ops import rotations as rot
from low_cost_mocap_tpu_torch.ops import triangulate
from low_cost_mocap_tpu_torch.parallel import dist_ba, multiprocess
from low_cost_mocap_tpu_torch.parallel import schur_ba, temporal
from low_cost_mocap_tpu_torch.parallel.mesh import make_mesh, shard_along
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.utils import differential
from low_cost_mocap_tpu_torch.utils import synthetic as syn
from low_cost_mocap_tpu_torch.utils.tree import leaves

torch.set_num_threads(1)
CPU = torch.device("cpu")
ITERS = [1, 8, 15, 64]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _mesh(n):
    return make_mesh({"point": n}, devices=[CPU] * n)


def _scene(n=40, seed=3, rot_sd=0.03, t_sd=0.05, one_view=True):
    """The 4-camera ring in camera 0's gauge, ``n`` points (not a bucket
    size), poses perturbed by ``rot_sd`` rad and ``t_sd`` m; with
    ``one_view``, one point seen by one camera.  (points, mask, K,
    perturbed Rs, ts) tensors."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    rng = np.random.default_rng(seed)
    X = syn.random_points(rng, n)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=0.3, rng=rng)
    mask = mask.copy()
    mask[5, 1:] = not one_view
    R0, t0 = Rs[0].copy(), ts[0].copy()
    Rs = np.einsum("cij,jk->cik", Rs, R0.T).astype(np.float32)
    ts = (ts - np.einsum("cij,j->ci", Rs, t0)).astype(np.float32)
    dR = rot.rotvec_to_matrix(_t(rng.normal(scale=rot_sd, size=(4, 3)).astype(
        np.float32))).numpy()
    Rs_p = np.einsum("cij,cjk->cik", dR, Rs).astype(np.float32)
    ts_p = (ts + rng.normal(scale=t_sd, size=ts.shape)).astype(np.float32)
    Rs_p[0], ts_p[0] = np.eye(3, dtype=np.float32), 0
    return tuple(_t(a) for a in (pts, mask, rig.K_stack(), Rs_p, ts_p))


def _same(a, b) -> bool:
    la, lb = leaves(tuple(a)), leaves(tuple(b))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ------------------------------------------- the loops the port ran before


def _ba_loop(pts, mask, K_stack, Rs0, ts0, *, num_cameras, max_iters,
             ftol=1e-2, cauchy_c=1.0, mode="pixel", freeze_focals=False):
    """``ops/ba.py:bundle_adjust``'s loop before the chunked step: one
    read of ``done`` an iteration, stopping at the first converged one."""
    dev, dt = pts.device, pts.dtype
    p0 = ba.pack_params(Rs0, ts0, K_stack[:, 0, 0])
    nparam = p0.shape[0]
    free_mask = torch.ones(nparam, dtype=dt, device=dev)
    if freeze_focals:
        focal_pos = [0] + [1 + i * 7 for i in range(num_cameras - 1)]
        free_mask[focal_pos] = 0.0

    def res_fn(p):
        return ba.residuals(p, pts, mask, K_stack, num_cameras, mode)

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
        J, r = jacfwd(res_with_aux, has_aux=True)(p)
        w = 1.0 / (1.0 + (r / cauchy_c) ** 2)
        Jw = J * w[:, None]
        H = Jw.T @ J
        g = Jw.T @ r
        if freeze_focals:
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
        if bool(done):
            break
    return p, cost, n_acc, steps


def _lm_step(lam, cost, c1, ftol):
    accept = c1 < cost
    rel = (cost - c1) / torch.clamp_min(cost, 1e-12)
    done = accept & (rel < ftol * 1e-2)
    lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-10), lam * 4.0)
    return accept, done, lam, torch.where(accept, c1, cost)


def _robust(r, c):
    return 0.5 * c ** 2 * torch.log1p((r / c) ** 2).sum()


def _dist_loop(mesh, shards, p, *, num_cameras, max_iters, ftol=1e-2,
               cauchy_c=1.0, mode="pixel"):
    """``parallel/dist_ba.py``'s loop before the chunked step, over the
    given (points, mask, K) shards."""
    def res_fn(params, sp, sm, sK):
        return ba.residuals(params, sp, sm, sK, num_cameras, mode)

    def global_cost(params):
        return mesh.sum_shards([_robust(res_fn(params, sp, sm, sK), cauchy_c)
                                for sp, sm, sK in shards])

    def normal_parts(params):
        parts = []
        for sp, sm, sK in shards:
            J, r = jacfwd(lambda q: (res_fn(q, sp, sm, sK),) * 2,
                          has_aux=True)(params)
            w = 1.0 / (1.0 + (r / cauchy_c) ** 2)
            Jw = J * w[:, None]
            parts.append(torch.cat([Jw.T @ J, (Jw.T @ r)[:, None]], dim=1))
        return parts

    nparam = p.shape[0]
    eye = torch.eye(nparam, dtype=p.dtype)
    lam = torch.tensor(1e-3, dtype=p.dtype)
    cost = global_cost(p)
    n_acc = torch.zeros((), dtype=torch.int64)
    steps = 0
    for _ in range(max_iters):
        Hg = mesh.sum_shards(normal_parts(p))
        H, g = Hg[:, :nparam], Hg[:, nparam]
        p1 = p + torch.linalg.solve_ex(H + lam * eye, -g)[0]
        accept, done, lam, cost = _lm_step(lam, cost, global_cost(p1), ftol)
        p = torch.where(accept, p1, p)
        n_acc = n_acc + accept
        steps += 1
        if bool(done):
            break
    return p, cost, n_acc, steps


def _schur_loop(mesh, shards, Xs, cam_p, *, num_cameras, max_iters,
                ftol=1e-2, cauchy_c=1.0):
    """``parallel/schur_ba.py``'s loop before the chunked step (with
    ``torch.linalg.inv``), over the given shards and landmarks."""
    def res_one(p, x, o, m, K):
        return schur_ba._point_residual(p, x, o, m, K, num_cameras)

    def global_cost(p, Xs):
        return mesh.sum_shards([_robust(vmap(
            res_one, in_dims=(None, 0, 0, 0, None))(p, X, sp, sm, sK),
            cauchy_c) for (sp, sm, sK), X in zip(shards, Xs)])

    def blocks_one(p, x, o, m, K):
        r = res_one(p, x, o, m, K)
        Jc = jacfwd(res_one, argnums=0)(p, x, o, m, K)
        Jp = jacfwd(res_one, argnums=1)(p, x, o, m, K)
        w = 1.0 / (1.0 + (r / cauchy_c) ** 2)
        Jcw, Jpw = Jc * w[:, None], Jp * w[:, None]
        return (Jcw.T @ Jc, Jpw.T @ Jp, Jcw.T @ Jp, Jcw.T @ r, Jpw.T @ r)

    blocks = vmap(blocks_one, in_dims=(None, 0, 0, 0, None))
    nparam = cam_p.shape[0]
    lam = torch.tensor(1e-3, dtype=cam_p.dtype)
    cost = global_cost(cam_p, Xs)
    n_acc = torch.zeros((), dtype=torch.int64)
    Xs = list(Xs)
    eye = torch.eye(nparam, dtype=cam_p.dtype)
    steps = 0
    for _ in range(max_iters):
        parts, local = [], []
        for (sp, sm, sK), X in zip(shards, Xs):
            Hcc, Hpp, Hcp, gc, gp = blocks(cam_p, X, sp, sm, sK)
            Hpp_inv = torch.linalg.inv(Hpp + lam * torch.eye(3))
            S = Hcc.sum(dim=0) - torch.einsum("nij,njk,nlk->il", Hcp,
                                              Hpp_inv, Hcp)
            rhs = gc.sum(dim=0) - torch.einsum("nij,njk,nk->i", Hcp,
                                               Hpp_inv, gp)
            parts.append(torch.cat([S, rhs[:, None]], dim=1))
            local.append((Hcp, Hpp_inv, gp))
        Sr = mesh.sum_shards(parts)
        dc = torch.linalg.solve_ex(Sr[:, :nparam] + lam * eye,
                                   -Sr[:, nparam])[0]
        X1s = [X - torch.einsum("nij,nj->ni", Hpp_inv,
                                gp + torch.einsum("nij,i->nj", Hcp, dc))
               for X, (Hcp, Hpp_inv, gp) in zip(Xs, local)]
        cam_p1 = cam_p + dc
        accept, done, lam, cost = _lm_step(lam, cost,
                                           global_cost(cam_p1, X1s), ftol)
        cam_p = torch.where(accept, cam_p1, cam_p)
        Xs = [torch.where(accept, X1, X) for X1, X in zip(X1s, Xs)]
        n_acc = n_acc + accept
        steps += 1
        if bool(done):
            break
    return cam_p, Xs, cost, n_acc, steps


def _refine_loop(board_xy, img_pts, w, K0, Rs0, ts0, *, max_iters):
    """``ops/intrinsics.py:refine``'s loop before the chunked step."""
    V = img_pts.shape[0]
    img_pts = torch.where(w[..., None] > 0, img_pts, 0.0)
    board3 = torch.cat([board_xy, torch.zeros_like(board_xy[:, :1])], dim=-1)
    rv0 = rot.matrix_to_rotvec(Rs0)
    p = torch.cat([torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
                   torch.zeros(5, dtype=K0.dtype),
                   torch.cat([rv0, ts0], dim=-1).reshape(-1)])
    nparam = p.shape[0]

    def res_fn(q):
        return intrinsics._residuals(q, board3, img_pts, w, V)

    def res_with_aux(q):
        r = res_fn(q)
        return r, r

    def cost_of(r):
        return 0.5 * (r * r).sum()

    eye = torch.eye(nparam, dtype=p.dtype)
    lam = torch.tensor(1e-3, dtype=p.dtype)
    cost = cost_of(res_fn(p))
    n_acc = torch.zeros((), dtype=torch.int64)
    steps = 0
    for _ in range(max_iters):
        J, r = jacfwd(res_with_aux, has_aux=True)(p)
        H = J.T @ J
        g = J.T @ r
        damp = torch.clamp_min(torch.diagonal(H), 1.0)
        delta = torch.linalg.solve_ex(H + lam * (eye * damp), -g)[0]
        p1 = p + delta
        c1 = cost_of(res_fn(p1))
        accept = c1 < cost
        rel = (cost - c1) / torch.clamp_min(cost, 1e-18)
        done = accept & (rel < 1e-10)
        p = torch.where(accept, p1, p)
        lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-12), lam * 5.0)
        cost = torch.where(accept, c1, cost)
        n_acc = n_acc + accept
        steps += 1
        if bool(done):
            break
    return p, cost, n_acc, steps


# ------------------------------------------------------------ the chunks


def test_buckets_and_padding():
    assert [ba.bucket(n) for n in (0, 1, 2, 3, 40, 64, 65, 512, 513, 1487,
                                   1500, 1536, 1537)] == [
        1, 1, 2, 4, 64, 64, 128, 512, 1024, 1536, 1536, 1536, 2048]
    pts, mask = torch.ones(3, 4, 2), torch.ones(3, 4, dtype=torch.bool)
    pp, pm = ba.pad_points(pts, mask, 4)
    assert pp.shape == (4, 4, 2) and torch.equal(pp[:3], pts)
    assert not pm[3].any() and not pp[3].any() and pm[:3].all()


@pytest.mark.parametrize("freeze", [False, True], ids=["free", "frozen"])
@pytest.mark.parametrize("max_iters", ITERS)
def test_bundle_adjust_chunks_equal_the_loop_bitwise(max_iters, freeze):
    """The chunked BA against the loop with a read an iteration over the
    same padded buffers: poses, focals, cost, accepted steps and the
    iterations until ``done`` bitwise equal; one read of ``done`` between
    two chunks."""
    pts, mask, K, Rs_p, ts_p = _scene()
    pb, mb = ba.pad_points(pts, mask, ba.bucket(pts.shape[0]))
    stats = {}
    got = ba.bundle_adjust(pts, mask, K, Rs_p, ts_p, num_cameras=4,
                           max_iters=max_iters, freeze_focals=freeze,
                           stats=stats)
    p, cost, n_acc, steps = _ba_loop(pb, mb, K, Rs_p, ts_p, num_cameras=4,
                                     max_iters=max_iters,
                                     freeze_focals=freeze)
    assert _same(got[:3], ba.unpack_params(p, 4))
    assert torch.equal(got.cost, cost) and torch.equal(got.n_iters, n_acc)
    assert stats["iterations"] == steps <= max_iters
    assert stats["chunks"] == -(-steps // ba.CHUNK)
    assert stats["reads"] == min(stats["chunks"],
                                 -(-max_iters // ba.CHUNK) - 1)
    if max_iters == 64:
        assert steps < 64          # stopped early, at done


@pytest.mark.parametrize("max_iters", ITERS)
@pytest.mark.parametrize("solver", ["dist", "schur"])
def test_sharded_chunks_equal_the_loop_bitwise(solver, max_iters):
    """The point-sharded and Schur solvers on 4 shards of 10 points, each
    padded to 16, against their loops with a read an iteration."""
    pts, mask, K, Rs_p, ts_p = _scene()
    mesh = _mesh(4)
    shards, n = dist_ba.padded_shards(mesh, "point", pts, mask, K)
    assert n == 10 and shards[0][0].shape[0] == 16
    p0 = ba.pack_params(Rs_p, ts_p, K[:, 0, 0])
    stats = {}
    if solver == "dist":
        got = dist_ba.dist_bundle_adjust(mesh, pts, mask, K, Rs_p, ts_p,
                                         max_iters=max_iters, stats=stats)
        p, cost, n_acc, steps = _dist_loop(mesh, shards, p0, num_cameras=4,
                                           max_iters=max_iters)
    else:
        got = schur_ba.schur_bundle_adjust(mesh, pts, mask, K, Rs_p, ts_p,
                                           max_iters=max_iters, stats=stats)
        Ps0 = camera.projection_matrix(K, Rs_p, ts_p)
        Xs = [triangulate.triangulate_points(sp, Ps0, sm)[0]
              for sp, sm, _ in shards]
        p, Xs, cost, n_acc, steps = _schur_loop(
            mesh, shards, Xs, p0, num_cameras=4, max_iters=max_iters)
        assert torch.equal(got.points, torch.cat([X[:n] for X in Xs]))
    assert _same(got[:3], ba.unpack_params(p, 4))
    assert torch.equal(got.cost, cost) and torch.equal(got.n_iters, n_acc)
    assert stats["iterations"] == steps
    assert stats["chunks"] == -(-steps // ba.CHUNK)


def _board_views(n_views=7):
    """``tests/test_intrinsics.py``'s masked scene at 7 views (padded to
    8): a 5x7 dot grid (4 cm) through a distorted camera, noiseless, one
    view masked out and 15% of the other points."""
    K = np.array([[300.0, 0, 162], [0, 295, 158], [0, 0, 1]], np.float32)
    d = np.array([0.08, -0.12, 0.001, -0.0005, 0.05], np.float32)
    board = intrinsics.make_grid(5, 7, 0.04)
    obj3 = np.concatenate([board, np.zeros((35, 1), np.float32)], -1)
    rng = np.random.default_rng(7)
    img = []
    for _ in range(n_views):
        rvec = np.deg2rad([rng.uniform(-30, 30), rng.uniform(-30, 30),
                           rng.uniform(-25, 25)])
        t = np.array([-0.12 + rng.uniform(-0.03, 0.03),
                      -0.08 + rng.uniform(-0.03, 0.03),
                      rng.uniform(0.55, 0.8)], np.float32)
        R = rot.rotvec_to_matrix(_t(rvec.astype(np.float32)))
        img.append(camera.project_points(_t(obj3), R[None], _t(t)[None],
                                         _t(K)[None], _t(d)[None])[0].numpy())
    img = np.stack(img).astype(np.float32)
    mask = np.ones(img.shape[:2], bool)
    mask[3] = False
    mask &= ~(np.random.default_rng(3).random(mask.shape) < 0.15)
    img[~mask] = np.nan
    return board, img, mask


def _refine_inputs(board, img, mask):
    """``calibrate_intrinsics``' inputs to ``refine``: (board, points,
    weights, K0, Rs0, ts0) tensors."""
    w = _t(mask.astype(np.float32))
    img_t = torch.where(w[..., None] > 0, _t(img), 0.0)
    b = _t(board)
    Hs = intrinsics.homography_dlt(b, img_t, w)
    view_ok = (w.sum(dim=1) >= 4).float()
    K0 = intrinsics.intrinsics_from_homographies(Hs, view_ok)
    Rs0, ts0 = intrinsics.extrinsics_from_homography(Hs, K0)
    good = ((view_ok > 0) & torch.isfinite(Rs0).all(-1).all(-1)
            & torch.isfinite(ts0).all(-1))
    Rs0 = torch.where(good[:, None, None], Rs0, torch.eye(3))
    ts0 = torch.where(good[:, None], ts0, torch.tensor([0.0, 0.0, 1.0]))
    return b, img_t, w, K0, Rs0, ts0


@pytest.mark.parametrize("max_iters", ITERS)
def test_intrinsics_chunks_equal_the_loop_bitwise(max_iters):
    """``refine`` on 7 views padded to 8 against its loop with a read an
    iteration over the same padded views."""
    b, img_t, w, K0, Rs0, ts0 = _refine_inputs(*_board_views())
    stats = {}
    K, dist, Rs, ts, rms, n_acc = intrinsics.refine(
        b, img_t, w, K0, Rs0, ts0, max_iters=max_iters, stats=stats)
    ip, wp, Rp, tp = intrinsics.pad_views(img_t, w, Rs0, ts0)
    assert ip.shape[0] == intrinsics.VIEW_BUCKET == 8
    p, cost, acc, steps = _refine_loop(b, ip, wp, K0, Rp, tp,
                                       max_iters=max_iters)
    Kw, dw, Rw, tw = intrinsics._unpack(p, 8)
    assert _same((K, dist, Rs, ts), (Kw, dw, Rw[:7], tw[:7]))
    assert torch.equal(n_acc, acc)
    assert torch.equal(rms, torch.sqrt(2.0 * cost / torch.clamp_min(
        wp.sum(), 1.0)))
    assert stats["iterations"] == steps


# ---------------------------------------- padded against unpadded and JAX


def _unit(ts):
    ts = np.asarray(ts, np.float64)
    return ts / np.linalg.norm(ts) * np.sign(ts[1, 0])


def _mean_err(pts, mask, K, R, t, f):
    Ps = camera.projection_matrix(ba._apply_focals(K, f), R, t)
    X, _ = triangulate.triangulate_points(pts, Ps, mask)
    e = triangulate.reprojection_errors(pts, X, Ps, mask)
    return float(torch.where(torch.isfinite(e), e, 0.0).mean())


@pytest.mark.parametrize("freeze", [False, True], ids=["free", "frozen"])
def test_padded_bundle_adjust_matches_unpadded_and_jax(freeze):
    """40 points padded to 64 against the loop on the 40 points and
    against JAX: rotations and unit translations within 1e-3, mean errors
    within 1e-3."""
    pts, mask, K, Rs_p, ts_p = _scene(seed=9 if freeze else 3)
    got = ba.bundle_adjust(pts, mask, K, Rs_p, ts_p, num_cameras=4,
                           max_iters=40, freeze_focals=freeze)
    p, _, _, _ = _ba_loop(pts, mask, K, Rs_p, ts_p, num_cameras=4,
                          max_iters=40, freeze_focals=freeze)
    want = jba.bundle_adjust(*(jnp.asarray(a.numpy()) for a in
                               (pts, mask, K, Rs_p, ts_p)), num_cameras=4,
                             max_iters=40, freeze_focals=freeze)
    e_got = _mean_err(pts, mask, K, got.Rs, got.ts, got.focals)
    for R, t, f in (ba.unpack_params(p, 4),
                    tuple(_t(np.asarray(a)) for a in
                          (want.Rs, want.ts, want.focals))):
        np.testing.assert_allclose(got.Rs.numpy(), R.numpy(), atol=1e-3)
        np.testing.assert_allclose(_unit(got.ts.numpy()), _unit(t.numpy()),
                                   atol=1e-3)
        assert abs(e_got - _mean_err(pts, mask, K, R, t, f)) < 1e-3
    assert e_got < 0.35


@pytest.mark.parametrize("solver", ["dist", "schur"])
def test_padded_sharded_solvers_match_unpadded_and_jax(solver):
    """8 shards of 5 points, each padded to 8: the cost within rtol 1e-3
    of the loop on the unpadded shards and of the JAX solver on a
    one-device JAX mesh (the Schur solver's landmark blocks inverted with
    ``inv_ex``)."""
    pts, mask, K, Rs_p, ts_p = _scene(seed=5, one_view=False)
    mesh = _mesh(8)
    args = (pts, mask, K, Rs_p, ts_p)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    jm = jmesh.make_mesh({"point": 1}, devices=jax.devices()[:1])
    raw = [(sp, sm, K) for sp, sm in zip(shard_along(mesh, "point", pts),
                                         shard_along(mesh, "point", mask))]
    p0 = ba.pack_params(Rs_p, ts_p, K[:, 0, 0])
    if solver == "dist":
        got = dist_ba.dist_bundle_adjust(mesh, *args, max_iters=20)
        _, cost, _, _ = _dist_loop(mesh, raw, p0, num_cameras=4,
                                   max_iters=20)
        want = jdist(jm, *jargs, max_iters=20)
    else:
        got = schur_ba.schur_bundle_adjust(mesh, *args, max_iters=20)
        Ps0 = camera.projection_matrix(K, Rs_p, ts_p)
        Xs = [triangulate.triangulate_points(sp, Ps0, sm)[0]
              for sp, sm, _ in raw]
        _, _, cost, _, _ = _schur_loop(mesh, raw, Xs, p0, num_cameras=4,
                                       max_iters=20)
        want = jschur(jm, *jargs, max_iters=20)
        assert got.points.shape == (40, 3)
    np.testing.assert_allclose(float(got.cost), float(cost), rtol=1e-3)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)


def test_padded_intrinsics_match_unpadded_and_jax():
    """7 views padded to 8 against the loop on the 7 views and against
    JAX's ``calibrate_intrinsics``: K within 1e-3 relative, distortion
    within 1e-3, the RMS within 1e-3 px."""
    board, img, mask = _board_views()
    got = intrinsics.calibrate_intrinsics(board, img, mask=mask, device="cpu")
    b, img_t, w, K0, Rs0, ts0 = _refine_inputs(board, img, mask)
    p, cost, _, _ = _refine_loop(b, img_t, w, K0, Rs0, ts0, max_iters=48)
    K_loop, d_loop, _, _ = intrinsics._unpack(p, 7)
    want = jintr.calibrate_intrinsics(board, img, mask=mask)
    rms_loop = float(torch.sqrt(2.0 * cost / w.sum()))
    for K, d, rms in ((K_loop.numpy(), d_loop.numpy(), rms_loop),
                      (np.asarray(want.K), np.asarray(want.dist),
                       float(want.rms_px))):
        assert np.abs(got.K.numpy() - K).max() / np.abs(K).max() < 1e-3
        np.testing.assert_allclose(got.dist.numpy()[:4], d[:4], atol=1e-3)
        assert abs(float(got.rms_px) - rms) < 1e-3
    assert got.Rs.shape == (7, 3, 3)


# ---------------------------------------------------------- time sharding


def test_process_sequence_steps_equal_the_op_by_op_calls():
    """Each time shard through its cached step: the outputs bitwise equal
    to ``per_frame_fn`` on each block, one step for the shards' one
    shape, none more at a second call."""
    rng = np.random.default_rng(0)
    seq = (_t(rng.normal(size=(24, 3, 5)).astype(np.float32)),
           _t(rng.integers(0, 9, size=(24, 3)).astype(np.int64)))

    def per_frame(block):
        x, k = block
        return (x * 2.0).sum(-1) + k, torch.cumsum(x, 0)[..., 0] > 0

    mesh = make_mesh({"time": 4}, devices=[CPU] * 4)
    got = temporal.process_sequence(mesh, seq, per_frame)
    want = [per_frame(tuple(x[i * 6:(i + 1) * 6] for x in seq))
            for i in range(4)]
    for g, parts in zip(got, zip(*want)):
        assert torch.equal(g, torch.cat(parts))
    n = len(temporal.cached_steps())
    again = temporal.process_sequence(mesh, seq, per_frame)
    assert len(temporal.cached_steps()) == n and _same(again, got)


def test_smooth_sharded_steps_equal_the_op_by_op_calls():
    """Each block's forward and backward passes through the cached step
    of its extended shape: bitwise equal to ``_filtfilt_block`` on the
    block with its halos, and within 1e-4 of the sequential smoother away
    from the edges."""
    rng = np.random.default_rng(1)
    T, D, halo = 256, 3, 32
    x = _t(np.cumsum(rng.normal(size=(T, D)).astype(np.float32), 0) * 0.01)
    mesh = make_mesh({"time": 4}, devices=[CPU] * 4)
    got = temporal.smooth_sharded(mesh, x, halo=halo)
    b, a = temporal.lowpass.butter_coeffs(5, 20.0, 60.0)
    blocks = list(x.split(T // 4))
    lefts, rights = temporal._neighbour_halos(mesh, blocks, halo)
    want = torch.cat([temporal._filtfilt_block(torch.cat([lh, blk, rh]),
                                               b, a)[halo:halo + T // 4]
                      for blk, lh, rh in zip(blocks, lefts, rights)])
    assert torch.equal(got, want)
    ref = temporal.smooth_reference(x)
    assert (got - ref)[40:-40].abs().max() < 1e-4
    steps = [s for s in temporal.cached_steps() if s.name == "smooth_sharded"]
    assert [tuple(s.args[0].shape) for s in steps].count(
        (T // 4 + 2 * halo, D)) == 1


# --------------------------------------------------------- the helpers


def test_rts_assoc_step_equals_the_op_by_op_call():
    """The rts-assoc worker's unsharded reference as one step, bitwise
    equal to ``kalman.rts_smooth_assoc`` called op by op."""
    rng = np.random.default_rng(2)
    T = 24
    xs = _t(rng.normal(size=(T, 1, 9)).astype(np.float32))
    A = rng.normal(size=(T, 1, 9, 9)).astype(np.float32) * 0.1
    Ps = _t(A @ A.transpose(0, 1, 3, 2) + np.eye(9, dtype=np.float32))
    dts = torch.full((T,), 1 / 60)
    step = multiprocess.rts_smooth_assoc_step(xs, Ps, dts)
    _, got = step((), xs, Ps, dts)
    assert torch.equal(got, kalman.rts_smooth_assoc(xs, Ps, dts)[0])


def test_differential_tracking_step_equals_the_op_by_op_calls():
    """The harness's tracking step over 12 frame sets of two drones,
    bitwise equal to ``track_from_blobs`` called op by op with the state
    carried by hand; the step's state is its buffers."""
    Rs, ts, rig = differential.reference_rig()
    eng = EngineConfig()
    step = differential.tracking_step(Rs, ts, rig, eng, eng.max_blobs, CPU)
    fn = functools.partial(
        track_from_blobs, gate_px=eng.epipolar_gate_px,
        max_candidates=eng.max_candidates_per_cam,
        marker_dist1=rig.marker_dist_short,
        marker_dist2=rig.marker_dist_long, marker_tol=rig.marker_dist_tol,
        marker_side_min=rig.marker_side_min)
    rng = np.random.default_rng(0)
    st, ref_st = step.state, kalman.init_state(2, device=CPU)
    for f in range(12):
        t = f / 60
        X = np.concatenate([
            differential.drone_markers_display(differential._pos_a(t), 0.1,
                                               1, 0.01, rig),
            differential.drone_markers_display(differential._pos_b(t), -0.2,
                                               -1, -0.01, rig)])
        pts, vis = syn.observe(differential.display_to_cam(X).astype(
            np.float32), Rs, ts, rig, noise_px=0.3, rng=rng)
        blobs = np.zeros((4, eng.max_blobs, 2), np.float32)
        valid = np.zeros((4, eng.max_blobs), bool)
        for c in range(4):
            idx = np.flatnonzero(vis[:, c])
            blobs[c, :len(idx)] = pts[idx, c]
            valid[c, :len(idx)] = True
        st, out = step(st, blobs, valid, 1 / 60, *step.args[3:])
        ref_st, ref = fn(ref_st, _t(blobs), _t(valid),
                         torch.tensor(1 / 60), *step.args[3:])
        assert _same(out, ref) and _same(st, ref_st)
    assert st is step.state and bool(out.tracked.valid.all())


# ------------------------------------------------ the loop runner itself


def test_run_until_stops_between_chunks_and_caches_by_bucket():
    """``ChunkedScan.run_until`` replays a chunk at most ceil(n / length)
    times and reads the stop flag once between two chunks (a chunk run op
    by op, as on the CPU, also ends at the iteration that sets it); a BA
    call of another point count in the same bucket builds no new
    chunk."""
    def count(c, limit):
        live = c[0] < limit
        return (c[0] + live, c[1] | ~live)

    carry = (torch.zeros((), dtype=torch.int64),
             torch.zeros((), dtype=torch.bool))
    loop = compiled.ChunkedScan(count, carry, (), 4,
                                consts=(torch.tensor(6),),
                                stop=lambda c: c[1], lazy=True)
    st = loop.run_until(carry, 20, 6)
    assert int(st[0]) == 6 and bool(st[1])
    assert (loop.chunks, loop.reads) == (2, 2)
    st = loop.run_until(carry, 3, 100)
    assert int(st[0]) == 4 and (loop.chunks, loop.reads) == (3, 2)

    ba.clear_cache()
    pts, mask, K, Rs_p, ts_p = _scene(n=40)
    ba.bundle_adjust(pts, mask, K, Rs_p, ts_p, num_cameras=4, max_iters=8)
    steps = ba.cached_steps()
    ba.bundle_adjust(pts[:35], mask[:35], K, Rs_p, ts_p, num_cameras=4,
                     max_iters=8)
    assert ba.cached_steps() == steps and len(steps) == 1
    ba.bundle_adjust(pts, mask, K, Rs_p, ts_p, num_cameras=4, max_iters=8,
                     mode="reference")
    assert len(ba.cached_steps()) == 2


@pytest.mark.parametrize("solver", ["dist", "schur"])
def test_split_layout_equals_the_one_device_chunk(solver):
    """Shards on two devices of one process (a mesh of "cpu" and "cpu:0":
    a step per device and phase, ``dist_ba.SplitChunk``) give the bits of
    the same shards on one device (one step a chunk), over 2 chunks."""
    pts, mask, K, Rs_p, ts_p = _scene()
    one = make_mesh({"point": 4}, devices=[CPU] * 4)
    two = make_mesh({"point": 4}, devices=["cpu", "cpu:0", "cpu",
                                           "cpu:0"])
    assert (dist_ba.layout(one, "point"), dist_ba.layout(two, "point")) == (
        "graph", "split")
    solve = (dist_ba.dist_bundle_adjust if solver == "dist"
             else schur_ba.schur_bundle_adjust)
    got, want = ({}, {}), ({}, {})
    a = solve(two, pts, mask, K, Rs_p, ts_p, max_iters=15, stats=got[0])
    b = solve(one, pts, mask, K, Rs_p, ts_p, max_iters=15, stats=want[0])
    assert _same(a, b) and got[0] == want[0]
    mod = dist_ba if solver == "dist" else schur_ba
    names = {s.name for s in mod.cached_steps()}
    assert {f"{solver}_bundle_adjust head cpu",
            f"{solver}_bundle_adjust head cpu:0"} <= names


def test_the_carry_freezes_at_done_and_at_the_budget():
    """What a graph runs past ``done`` (or past ``max_iters``) changes no
    bit of the carry: the iterations op by op, continued after the stop,
    leave every field as the stopping iteration left it."""
    pts, mask, K, Rs_p, ts_p = _scene()
    pb, mb = ba.pad_points(pts, mask, ba.bucket(pts.shape[0]))
    p0 = ba.pack_params(Rs_p, ts_p, K[:, 0, 0])
    it = functools.partial(ba._iteration, num_cameras=4, mode="pixel",
                           cauchy_c=1.0, tol=1e-4, freeze_focals=False)
    free = torch.ones_like(p0)
    for budget in (64, 3):
        st = ba.lm_start(p0, ba.robust_cost(ba.residuals(
            p0, pb, mb, K, 4, "pixel"), 1.0), budget)
        while not (bool(st.done) or int(st.it) >= budget):
            st = it(st, pb, mb, K, free)
        after = st
        for _ in range(3):
            after = it(after, pb, mb, K, free)
        assert _same(after, st)
        assert (bool(st.done) if budget == 64
                else int(st.it) == 3 and not bool(st.done))
