"""PyTorch port: blob detection and packed ingest against the JAX package.

The port's plain detector (``ops/detect.py:find_blobs_multi`` — the plain
version of the ``detect_blobs`` CUDA kernel) against the JAX Pallas kernel
in interpret mode and the JAX XLA detector, on rendered frames plus an
empty frame, pixels at the threshold edge and a lit line longer than
``cc_iters`` (which truncated propagation splits), a lit snake longer than
70 and 100 sweeps (more than one pass of the CUDA kernel holds), and
all-lit and all-dark frames.  Validity and sizes are
exactly equal; centroids are compared exactly too (integer moments below
2^24 and one float32 division on both sides), within the atol 1e-5 the
JAX package's own Pallas test uses.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from low_cost_mocap_tpu.ops import detect as jdetect
from low_cost_mocap_tpu.ops import detect_pallas
from low_cost_mocap_tpu.utils import synthetic as jsyn
from low_cost_mocap_tpu_torch.ops import detect, detect_cuda, native

torch.set_num_threads(1)

CC_ITERS = 16


def _frames(seed=0, n=5, size=128):
    rng = np.random.default_rng(seed)
    Rs, ts, rig = jsyn.ring_rig(num_cameras=2, image_size=size)
    X = jsyn.random_points(rng, n)
    pts, mask = jsyn.observe(X, Rs, ts, rig)
    return jsyn.render_frames(pts, mask, size, sigma=0.8).astype(np.float32)


def _hard_frames(size=128):
    """Camera 0: pixels 50/255, 51/255, 52/255 around the 0.2 threshold and
    a blob; camera 1: a lit line longer than CC_ITERS plus a dot; camera
    2: empty."""
    f = np.zeros((3, size, size), np.float32)
    u8 = np.float32(1.0 / 255.0)
    for i, v in enumerate((50, 51, 52)):
        f[0, 10, 10 + 4 * i] = np.float32(v) * u8
        f[0, 30 + 4 * i, 70] = np.float32(v) * u8
    f[0, 60:64, 40:45] = np.float32(52) * u8
    f[1, 20, 5:5 + 3 * CC_ITERS] = 1.0
    f[1, 90:93, 90:93] = 1.0
    return f


def _check(port, ref):
    c1, v1, s1 = (np.asarray(a) for a in ref)
    c2, v2, s2 = (t.numpy() for t in port)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_allclose(c1, c2, atol=1e-5, rtol=0)


@pytest.mark.parametrize("which", ["render", "hard"])
def test_plain_detector_matches_jax(which):
    frames = _frames() if which == "render" else _hard_frames()
    port = detect.find_blobs_multi(torch.from_numpy(frames), 0.2, 8,
                                   cc_iters=CC_ITERS)
    with pltpu.force_tpu_interpret_mode():
        pallas = detect_pallas.find_blobs_pallas(jnp.asarray(frames), 0.2, 8,
                                                 cc_iters=CC_ITERS)
    xla = jdetect.find_blobs_multi(jnp.asarray(frames), 0.2, 8,
                                   cc_iters=CC_ITERS)
    _check(port, pallas)
    _check(port, xla)
    if which == "hard":
        cent, valid, size = (t.numpy() for t in port)
        # 51/255 rounds just above f32(0.2) and passes, 50/255 does not:
        # two pixels of each triple plus the blob
        assert valid[0].sum() == 5
        # truncated propagation splits the long line: its first
        # CC_ITERS + 1 pixels share the end's label, every later pixel
        # carries the label of the pixel CC_ITERS to its left
        assert valid[1].all()
        assert size[1, 0] == CC_ITERS + 1 and (size[1, 1:] == 1).all()
        assert not valid[2].any() and not cent[2].any() and not size[2].any()


def _snake(H=40, W=40):
    """Camera 0: a serpentine line of about 400 pixels; camera 1: a dot."""
    f = np.zeros((2, H, W), np.float32)
    rows = list(range(1, H - 1, 4))
    for k, y in enumerate(rows):
        f[0, y, 1:W - 1] = 1.0
        if k + 1 < len(rows):
            f[0, y:y + 5, W - 2 if k % 2 == 0 else 1] = 1.0
    f[1, 20:22, 7:9] = 1.0
    return f


@pytest.mark.parametrize("cc_iters", [70, 100])
def test_plain_detector_matches_jax_beyond_one_pass(cc_iters):
    """More sweeps than one pass of the CUDA kernel holds (69): the snake
    is longer than cc_iters, so truncated propagation still splits it."""
    frames = _snake()
    port = detect.find_blobs_multi(torch.from_numpy(frames), 0.2, 8,
                                   cc_iters=cc_iters)
    with pltpu.force_tpu_interpret_mode():
        pallas = detect_pallas.find_blobs_pallas(jnp.asarray(frames), 0.2, 8,
                                                 cc_iters=cc_iters)
    xla = jdetect.find_blobs_multi(jnp.asarray(frames), 0.2, 8,
                                   cc_iters=cc_iters)
    _check(port, pallas)
    _check(port, xla)
    valid, size = port[1].numpy(), port[2].numpy()
    # the snake splits into more pieces than there are slots
    assert valid[0].all() and size[0].sum() < frames[0].sum()
    assert valid[1].sum() == 1 and size[1, 0] == 4


@pytest.mark.parametrize("lit", [True, False])
def test_plain_detector_matches_jax_on_uniform_frames(lit):
    frames = np.full((2, 24, 40), 1.0 if lit else 0.0, np.float32)
    port = detect.find_blobs_multi(torch.from_numpy(frames), 0.2, 8,
                                   cc_iters=CC_ITERS)
    with pltpu.force_tpu_interpret_mode():
        pallas = detect_pallas.find_blobs_pallas(jnp.asarray(frames), 0.2, 8,
                                                 cc_iters=CC_ITERS)
    xla = jdetect.find_blobs_multi(jnp.asarray(frames), 0.2, 8,
                                   cc_iters=CC_ITERS)
    _check(port, pallas)
    _check(port, xla)
    assert bool(port[1].all()) == lit and bool(port[1].any()) == lit


def test_wrapper_on_card_refuses_non_contiguous_frames(monkeypatch):
    """On the card the wrapper converts nothing: a strided view is refused
    before any kernel is built."""
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel built")

    monkeypatch.setattr(native, "on_card", lambda t: True)
    monkeypatch.setattr(native, "load", no_kernel)
    frames = torch.from_numpy(_hard_frames())[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        detect_cuda.find_blobs(frames, 0.2, 8, cc_iters=CC_ITERS)


def test_plain_detector_keeps_first_k_in_raster_order():
    frames = _frames(seed=1, n=9)
    port = detect.find_blobs_multi(torch.from_numpy(frames), 0.2, 3,
                                   cc_iters=CC_ITERS)
    xla = jdetect.find_blobs_multi(jnp.asarray(frames), 0.2, 3,
                                   cc_iters=CC_ITERS)
    _check(port, xla)


def test_pack_and_unpack_match_jax():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (3, 16, 64), dtype=np.uint8)
    frames[0, 0, :3] = (50, 51, 52)
    for thr in (0.2, 0.5, 1.0):
        packed = detect.pack_frames(frames, thr)
        np.testing.assert_array_equal(packed, jdetect.pack_frames(frames, thr))
        assert detect.threshold_cutoff(thr) == jdetect.threshold_cutoff(thr)
        np.testing.assert_array_equal(
            detect.unpack_bits(torch.from_numpy(packed)).numpy(),
            np.asarray(jdetect.unpack_bits(jnp.asarray(packed))))
    with pytest.raises(TypeError):
        detect.pack_frames(frames.astype(np.float32), 0.2)


def test_wrapper_takes_plain_version_on_cpu():
    frames = torch.from_numpy(_hard_frames())
    before = detect_cuda.launches
    got = detect_cuda.find_blobs(frames, 0.2, 8, cc_iters=CC_ITERS)
    want = detect.find_blobs_multi(frames, 0.2, 8, cc_iters=CC_ITERS)
    assert detect_cuda.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_on_card_never_falls_back(monkeypatch):
    def no_kernel(name):
        raise RuntimeError(f"no {name} kernel built")

    monkeypatch.setattr(native, "on_card", lambda t: True)
    monkeypatch.setattr(native, "load", no_kernel)
    before = detect_cuda.launches
    with pytest.raises(RuntimeError, match="detect_blobs"):
        detect_cuda.find_blobs(torch.from_numpy(_hard_frames()), 0.2, 8,
                               cc_iters=CC_ITERS)
    assert detect_cuda.launches == before
