"""PyTorch port: the mesh, the distributed bundle adjustments and the
time-sharded offline functions on the CPU.

Meshes repeat the CPU device, as the JAX tests lay out eight virtual
devices.  Each solver is held to the JAX tests' criteria
(``tests/test_parallel.py``, ``tests/test_schur_temporal.py``) and to the
JAX function on the same inputs, which runs on a one-device JAX mesh
(the JAX package's own tests compare its meshes); the port's sharded
results are held to its own one-shard results.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from low_cost_mocap_tpu_torch.ops import ba as ba_ops
from low_cost_mocap_tpu_torch.ops import camera, detect_cuda, triangulate
from low_cost_mocap_tpu_torch.ops import rotations as rot
from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
from low_cost_mocap_tpu_torch.parallel import temporal
from low_cost_mocap_tpu_torch.parallel.dist_ba import dist_bundle_adjust
from low_cost_mocap_tpu_torch.parallel.schur_ba import schur_bundle_adjust
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return mesh_lib.make_mesh(axes, devices=[CPU] * n)


def _jmesh(axis):
    from low_cost_mocap_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh({axis: 1}, devices=jax.devices()[:1])


def _scene(n_pts=64, noise=0.3, seed=3, perturb=True):
    """The JAX tests' scene: the 4-camera ring in camera 0's gauge, and
    poses perturbed by 0.02 rad and 3 cm."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    rng = np.random.default_rng(seed)
    X = syn.random_points(rng, n_pts)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=noise, rng=rng)
    R0, t0 = Rs[0].copy(), ts[0].copy()
    Rs = np.einsum("cij,jk->cik", Rs, R0.T).astype(np.float32)
    ts = (ts - np.einsum("cij,j->ci", Rs, t0)).astype(np.float32)
    if perturb:
        dR = rot.rotvec_to_matrix(torch.as_tensor(
            rng.normal(scale=0.02, size=(4, 3)).astype(np.float32))).numpy()
        Rs = np.einsum("cij,cjk->cik", dR, Rs).astype(np.float32)
        ts = (ts + rng.normal(scale=0.03, size=ts.shape)).astype(np.float32)
        Rs[0], ts[0] = np.eye(3, dtype=np.float32), 0
    return pts, mask, Rs, ts, rig


def _args(pts, mask, Rs, ts, rig):
    return tuple(torch.as_tensor(np.asarray(a)) for a in
                 (pts, mask, rig.K_stack(), Rs, ts))


def _jargs(pts, mask, Rs, ts, rig):
    return tuple(jnp.asarray(a) for a in (pts, mask, rig.K_stack(), Rs, ts))


def _mean_err(pts, mask, rig, Rs, ts, focals=None):
    K = torch.as_tensor(rig.K_stack())
    if focals is not None:
        K = ba_ops._apply_focals(K, focals)
    Ps = camera.projection_matrix(K, torch.as_tensor(np.asarray(Rs)),
                                  torch.as_tensor(np.asarray(ts)))
    p, m = torch.as_tensor(pts), torch.as_tensor(mask)
    Xh, _ = triangulate.triangulate_points(p, Ps, m)
    e = triangulate.reprojection_errors(p, Xh, Ps, m)
    return float(torch.where(torch.isfinite(e), e, 0.0).mean())


def test_make_mesh_shapes(monkeypatch):
    m = _mesh(point=8)
    assert m.devices.shape == (8,) and m.shape == {"point": 8}
    m2 = _mesh(cam=4, point=2)
    assert m2.devices.shape == (4, 2) and m2.shape["cam"] == 4
    assert [i for i, _ in m2.axis_shards("point")] == [0, 1]
    with pytest.raises(ValueError):
        mesh_lib.make_mesh({"point": 3}, devices=[CPU] * 8)
    # by default the mesh is every CUDA device, and without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.make_mesh()
    # shard_along splits dim 0 evenly, replicated copies once a device
    x = torch.arange(16.0).reshape(8, 2)
    parts = mesh_lib.shard_along(m, "point", x)
    assert len(parts) == 8 and torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="divisible"):
        mesh_lib.shard_along(_mesh(point=3), "point", x)
    assert list(mesh_lib.replicated(m, x)) == [CPU]
    # the fixed-order sum: shard 0, then + shard 1, ...
    got = m.sum_shards([torch.full((2,), float(i)) for i in range(8)])
    assert torch.equal(got, torch.full((2,), 28.0))


def test_dist_ba_matches_single_device_and_jax():
    """JAX's criteria (mean error < 0.35 px², within 0.05 of the single
    device) on an 8-shard mesh, and the cost of JAX's dist_bundle_adjust
    on the same inputs within rtol 1e-3."""
    from low_cost_mocap_tpu.parallel.dist_ba import \
        dist_bundle_adjust as jdist

    pts, mask, Rs_p, ts_p, rig = _scene()
    args = _args(pts, mask, Rs_p, ts_p, rig)
    single = ba_ops.bundle_adjust(*args, num_cameras=4, max_iters=30)
    dist = dist_bundle_adjust(_mesh(point=8), *args, max_iters=30)
    e_single = _mean_err(pts, mask, rig, single.Rs, single.ts, single.focals)
    e_dist = _mean_err(pts, mask, rig, dist.Rs, dist.ts, dist.focals)
    assert e_dist < 0.35
    assert abs(e_dist - e_single) < 0.05
    want = jdist(_jmesh("point"), *_jargs(pts, mask, Rs_p, ts_p, rig),
                 max_iters=30)
    np.testing.assert_allclose(float(dist.cost), float(want.cost), rtol=1e-3)


def test_dist_ba_on_2d_mesh_axis():
    """BA shards over 'point' even when the mesh also has a 'cam' axis,
    and agrees with the one-shard solve."""
    pts, mask, Rs, ts, rig = _scene(n_pts=32, perturb=False)
    args = _args(pts, mask, Rs, ts, rig)
    res = dist_bundle_adjust(_mesh(cam=4, point=2), *args, max_iters=10)
    one = dist_bundle_adjust(_mesh(point=1), *args, max_iters=10)
    assert np.isfinite(float(res.cost))
    np.testing.assert_allclose(float(res.cost), float(one.cost), rtol=1e-3)


def test_schur_ba_converges_distributed():
    pts, mask, Rs_p, ts_p, rig = _scene()
    e_before = _mean_err(pts, mask, rig, Rs_p, ts_p)
    res = schur_bundle_adjust(_mesh(point=8),
                              *_args(pts, mask, Rs_p, ts_p, rig),
                              max_iters=40)
    e_after = _mean_err(pts, mask, rig, res.Rs, res.ts, res.focals)
    assert e_before > 0.5
    assert e_after < 0.3
    # refined landmarks reproject tightly too
    K = ba_ops._apply_focals(torch.as_tensor(rig.K_stack()), res.focals)
    Ps = camera.projection_matrix(K, res.Rs, res.ts)
    e_pts = triangulate.reprojection_errors(
        torch.as_tensor(pts), res.points, Ps, torch.as_tensor(mask))
    assert float(e_pts.mean()) < 0.3


def test_schur_ba_one_vs_eight_shards_and_jax_agree():
    from low_cost_mocap_tpu.parallel.schur_ba import \
        schur_bundle_adjust as jschur

    pts, mask, Rs_p, ts_p, rig = _scene(n_pts=32, seed=5)
    args = _args(pts, mask, Rs_p, ts_p, rig)
    r1 = schur_bundle_adjust(_mesh(point=1), *args, max_iters=20)
    r8 = schur_bundle_adjust(_mesh(point=8), *args, max_iters=20)
    np.testing.assert_allclose(float(r1.cost), float(r8.cost), rtol=1e-3)
    want = jschur(_jmesh("point"), *_jargs(pts, mask, Rs_p, ts_p, rig),
                  max_iters=20)
    np.testing.assert_allclose(float(r8.cost), float(want.cost), rtol=1e-3)
    assert r8.points.shape == (32, 3)


def test_smooth_sharded_matches_sequential_and_jax():
    from low_cost_mocap_tpu.parallel import temporal as jtemporal

    rng = np.random.default_rng(1)
    T, D = 256, 3
    x = np.cumsum(rng.normal(size=(T, D)).astype(np.float32), axis=0) * 0.01
    ours = temporal.smooth_sharded(_mesh(time=8), torch.as_tensor(x),
                                   halo=32).numpy()
    ref = temporal.smooth_reference(torch.as_tensor(x)).numpy()
    jref = np.asarray(jtemporal.smooth_reference(jnp.asarray(x)))
    # interior matches tightly; block edges inherit the halo's accuracy
    assert np.abs(ours - ref)[40:-40].max() < 1e-4
    assert np.abs(ours - jref)[40:-40].max() < 1e-4
    np.testing.assert_allclose(ref, jref, atol=1e-5)
    with pytest.raises(ValueError, match="halo"):
        temporal.smooth_sharded(_mesh(time=8), torch.as_tensor(x), halo=33)


def _obs(rng, Rs, ts, rig):
    X = syn.random_points(rng, 2)
    return syn.observe(X, Rs, ts, rig)


def test_process_sequence_time_sharded_is_bitwise_unsharded():
    Rs, ts, rig = syn.ring_rig(num_cameras=2, image_size=64)
    rng = np.random.default_rng(0)
    T = 16
    frames = torch.as_tensor(np.stack([
        syn.render_frames(*_obs(rng, Rs, ts, rig), rig.image_size, sigma=0.8)
        for _ in range(T)]))                                 # (T, C, H, W)

    def per_frame(f):          # a block of frames: one detection launch
        c, v, s = detect_cuda.find_blobs(f.reshape(-1, 64, 64).contiguous(),
                                         0.2, 4, cc_iters=8)
        return tuple(t.reshape(f.shape[0], 2, *t.shape[1:])
                     for t in (c, v, s))

    c, v, s = temporal.process_sequence(_mesh(time=8), frames, per_frame)
    assert c.shape == (T, 2, 4, 2)
    assert int(v.sum()) >= T * 2          # every frame found its blob(s)
    for got, want in zip((c, v, s), per_frame(frames)):
        assert torch.equal(got, want)
    # a tuple of sequences shards leaf by leaf
    got = temporal.process_sequence(_mesh(time=4), (c, v),
                                    lambda cv: cv[0] * cv[1][..., None])
    assert torch.equal(got, c * v[..., None])
