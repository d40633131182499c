"""PyTorch port: the native host detector and sparse ingest.

The port builds its own copy of the native library (``control/``); on the
same seeded frames every entry point gives output identical to the JAX
package's bindings, and the binary centroids are bitwise those of the
port's plain detector.  Sparse ingest round-trips exactly, and the sparse
step equals the packed step.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from low_cost_mocap_tpu.control import bindings as jbind
from low_cost_mocap_tpu.ops import detect as jdetect
from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.control import bindings
from low_cost_mocap_tpu_torch.models import pipeline
from low_cost_mocap_tpu_torch.ops import camera, correspond, detect, kalman
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)


def _random_frames(seed, C=4, H=320, W=320, blobs=6):
    rng = np.random.default_rng(seed)
    frames = np.zeros((C, H, W), np.uint8)
    for c in range(C):
        for _ in range(blobs):
            r, col = rng.integers(2, H - 4), rng.integers(2, W - 4)
            rad = int(rng.integers(1, 4))
            frames[c, r - rad:r + rad + 1, col - rad:col + rad + 1] = \
                rng.integers(100, 255)
    frames[0, 0:2, 0:2] = 200      # corner component
    frames[1, -1, -3:] = 210       # bottom-edge strip
    return frames


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_entry_points_match_jax_bindings(seed):
    frames = _random_frames(seed)
    cutoff = detect.threshold_cutoff(0.2)
    assert cutoff == jdetect.threshold_cutoff(0.2)
    packed = bindings.pack_bits(frames, cutoff)
    np.testing.assert_array_equal(packed, jbind.pack_bits(frames, cutoff))
    np.testing.assert_array_equal(packed, detect.pack_frames(frames, 0.2))
    for budget in (64, 4096):
        idx, n = bindings.extract_bits(packed, budget)
        jidx, jn = jbind.extract_bits(packed, budget)
        assert n == jn
        np.testing.assert_array_equal(idx, jidx)
    for gray in (None, frames):
        for a, b in zip(bindings.detect_blobs(packed, 320, 320, 8, gray=gray),
                        jbind.detect_blobs(packed, 320, 320, 8, gray=gray)):
            np.testing.assert_array_equal(a, b)
    for weighted in (False, True):
        for a, b in zip(bindings.ingest_detect(frames, cutoff, 8, weighted),
                        jbind.ingest_detect(frames, cutoff, 8, weighted)):
            np.testing.assert_array_equal(a, b)
        batch = np.stack([frames, _random_frames(seed + 10)])
        np.testing.assert_array_equal(
            bindings.ingest_detect_packed(batch, cutoff, 8, weighted),
            jbind.ingest_detect_packed(batch, cutoff, 8, weighted))


def test_binary_centroids_equal_the_plain_detector():
    for seed in range(3):
        frames = _random_frames(seed)
        cent, valid, sizes = bindings.ingest_detect(
            frames, detect.threshold_cutoff(0.2), 8)
        f = torch.from_numpy(frames.astype(np.float32) * np.float32(1 / 255))
        pc, pv, ps = (t.numpy() for t in detect.find_blobs_multi(
            f, 0.2, 8, cc_iters=64))
        np.testing.assert_array_equal(valid, pv)
        np.testing.assert_array_equal(cent, pc)
        np.testing.assert_array_equal(sizes, ps)


def test_empty_overflow_and_caller_buffer():
    frames = np.zeros((2, 320, 320), np.uint8)
    cent, valid, sizes = bindings.ingest_detect(frames, 52, 8)
    assert not valid.any() and (sizes == 0).all()
    frames[0, ::10, ::10] = 255    # 32*32 isolated pixels, 8 slots
    cent, valid, _ = bindings.ingest_detect(frames, 52, 8)
    assert valid[0].all()
    np.testing.assert_array_equal(cent[0, :, 1], 0.0)
    np.testing.assert_array_equal(cent[0, :, 0], np.arange(8) * 10.0)
    # a caller-owned buffer (the pinned slot of the engine) is filled in
    # place; a threshold above every uint8 value zeroes it
    buf = np.full((2, 8, 3), 7.0, np.float32)
    assert bindings.ingest_detect_packed(frames, 52, 8, out=buf) is buf
    np.testing.assert_array_equal(
        buf, bindings.ingest_detect_packed(frames, 52, 8))
    assert not bindings.ingest_detect_packed(frames, 256, 8, out=buf).any()
    with pytest.raises(ValueError, match="out must be"):
        bindings.ingest_detect_packed(frames, 52, 8,
                                      out=np.empty((2, 8, 2), np.float32))
    for bad in (0, -1):
        with pytest.raises(ValueError, match="max_blobs"):
            bindings.ingest_detect_packed(frames, 52, bad)
    with pytest.raises(ValueError, match="uint8"):
        bindings.ingest_detect_packed(frames.astype(np.float32), 52, 8)


def test_sparse_ingest_roundtrip_and_overflow():
    rng = np.random.default_rng(4)
    frames = ((rng.random((3, 32, 64)) > 0.97) * 255).astype(np.uint8)
    idx, ok, packed = detect.sparse_ingest(frames, 0.2, budget=4096)
    jidx, jok, jpacked = jdetect.sparse_ingest(frames, 0.2, budget=4096)
    assert ok and jok
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(packed, jpacked)
    lit = np.flatnonzero(frames.reshape(-1) >= 52)
    np.testing.assert_array_equal(idx[:lit.size], lit)
    assert (idx[lit.size:] == np.iinfo(np.int32).max).all()
    dense = detect.scatter_pixels(torch.from_numpy(idx), frames.shape)
    np.testing.assert_array_equal(
        dense.numpy(), detect.unpack_bits(torch.from_numpy(packed)).numpy())
    np.testing.assert_array_equal(
        dense.numpy(),
        np.asarray(jdetect.scatter_pixels(jnp.asarray(idx), frames.shape)))
    # more lit pixels than the budget: ok is False, the bitmap still exact
    idx2, ok2, packed2 = detect.sparse_ingest(frames, 0.2, budget=4)
    assert not ok2
    np.testing.assert_array_equal(packed2, packed)


def test_scatter_pixels_drops_out_of_range_indices():
    shape = (2, 4, 8)
    idx = torch.tensor([0, 5, 63, 64, -1, 2**31 - 1, 5], dtype=torch.int32)
    got = detect.scatter_pixels(idx, shape).reshape(-1)
    want = torch.zeros(64)
    want[[0, 5, 63]] = 1.0
    assert torch.equal(got, want)


def test_sparse_step_matches_packed_step():
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    cfg = EngineConfig()
    rng = np.random.default_rng(5)
    pts, mask = syn.observe(syn.random_points(rng, 6), Rs, ts, rig)
    frames = (syn.render_frames(pts, mask, rig.image_size, sigma=0.8)
              * 255).astype(np.uint8)
    K = torch.as_tensor(rig.K_stack())
    Ps = camera.projection_matrix(K, torch.as_tensor(Rs), torch.as_tensor(ts))
    cal = (Ps, K, torch.as_tensor(rig.dist_stack()), torch.eye(4),
           correspond._pairwise_fundamentals(Ps))
    kw = dict(threshold=cfg.detect_threshold, max_blobs=cfg.max_blobs,
              cc_iters=cfg.cc_iters, gate_px=cfg.epipolar_gate_px,
              max_candidates=cfg.max_candidates_per_cam,
              marker_dist1=rig.marker_dist_short,
              marker_dist2=rig.marker_dist_long,
              marker_tol=rig.marker_dist_tol,
              marker_side_min=rig.marker_side_min, do_preprocess=False)
    packed = detect.pack_frames(frames, cfg.detect_threshold)
    _, out_p = pipeline.frame_step(
        kalman.init_state(2, device="cpu"), torch.from_numpy(packed),
        np.float32(1 / 60), *cal, packed_input=True, **kw)
    idx, ok, _ = detect.sparse_ingest(frames, cfg.detect_threshold,
                                      cfg.sparse_budget)
    assert ok
    _, out_s = pipeline.frame_step(
        kalman.init_state(2, device="cpu"), torch.from_numpy(idx),
        np.float32(1 / 60), *cal, sparse_input=True,
        image_shape=frames.shape, **kw)
    np.testing.assert_array_equal(pipeline.pack_outputs(out_p).numpy(),
                                  pipeline.pack_outputs(out_s).numpy())
    assert out_s.point_valid.any()
    with pytest.raises(ValueError, match="image_shape"):
        pipeline.frame_step(kalman.init_state(2, device="cpu"),
                            torch.from_numpy(idx), np.float32(1 / 60), *cal,
                            sparse_input=True, **kw)
