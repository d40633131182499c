"""PyTorch port: intrinsic (Zhang) calibration against the JAX package on
the CPU, stage by stage, on the noiseless and the masked/NaN scenes of
``tests/test_intrinsics.py``: homographies (relative 1e-4), closed-form K
and the refined K (relative 1e-3), distortion (atol 1e-3; k3 5e-3
relative), RMS; the
numpy grid helpers element for element; the too-few-views error.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from low_cost_mocap_tpu.ops import intrinsics as jintr
from low_cost_mocap_tpu_torch.ops import intrinsics as intr

torch.set_num_threads(1)

K_TRUE = np.array([[300.0, 0.0, 162.0],
                   [0.0, 295.0, 158.0],
                   [0.0, 0.0, 1.0]], np.float64)
DIST_TRUE = np.array([0.08, -0.12, 0.001, -0.0005, 0.05], np.float64)
ROWS, COLS, SPACING = 5, 7, 0.04


def _poses(n_views: int):
    rng = np.random.default_rng(7)
    poses = []
    for v in range(n_views):
        rvec = np.deg2rad([rng.uniform(-30, 30), rng.uniform(-30, 30),
                           rng.uniform(-25, 25)])
        t = np.array([-0.12 + rng.uniform(-0.03, 0.03),
                      -0.08 + rng.uniform(-0.03, 0.03),
                      rng.uniform(0.55, 0.8)])
        poses.append((rvec, t))
    return poses


def _views(n_views: int, noise_px: float = 0.0, seed: int = 0):
    board = intr.make_grid(ROWS, COLS, SPACING).astype(np.float64)
    obj3 = np.concatenate([board, np.zeros((len(board), 1))], axis=-1)
    rng = np.random.default_rng(seed)
    img = []
    for rvec, t in _poses(n_views):
        uv, _ = cv2.projectPoints(obj3, rvec, t, K_TRUE, DIST_TRUE)
        uv = uv.reshape(-1, 2)
        if noise_px > 0:
            uv = uv + rng.normal(scale=noise_px, size=uv.shape)
        img.append(uv)
    return board.astype(np.float32), np.stack(img).astype(np.float32)


def _scene(kind):
    if kind == "noiseless":
        board, img = _views(8)
        return board, img, np.ones(img.shape[:2], bool)
    board, img = _views(9, noise_px=0.1)
    mask = np.ones(img.shape[:2], bool)
    mask[3] = False                                   # one dead view
    mask &= ~(np.random.default_rng(3).random(mask.shape) < 0.15)
    img[~mask] = np.nan
    return board, img, mask


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


@pytest.mark.parametrize("kind", ["noiseless", "masked"])
def test_stages_match_jax(kind):
    board, img, mask = _scene(kind)
    w = mask.astype(np.float32)
    img0 = np.where(mask[..., None], img, 0.0).astype(np.float32)
    t = lambda a: torch.tensor(np.asarray(a))
    Hs = intr.homography_dlt(t(board), t(img0), t(w))
    ok = mask.sum(axis=1) >= 4
    Hs_j = np.stack([np.asarray(jintr.homography_dlt(
        jnp.asarray(board), jnp.asarray(img0[v]), jnp.asarray(w[v])))
        for v in range(len(img))])
    for v in np.where(ok)[0]:
        assert _rel(Hs[v].numpy(), Hs_j[v]) < 1e-4, v
    view_ok = ok.astype(np.float32)
    K0 = intr.intrinsics_from_homographies(t(Hs_j), t(view_ok))
    K0_j = jintr.intrinsics_from_homographies(jnp.asarray(Hs_j),
                                              jnp.asarray(view_ok))
    assert _rel(K0.numpy(), K0_j) < 1e-3
    R, tv = intr.extrinsics_from_homography(t(Hs_j[ok]), t(np.asarray(K0_j)))
    for v, H in enumerate(Hs_j[ok]):
        Rj, tj = jintr.extrinsics_from_homography(jnp.asarray(H), K0_j)
        np.testing.assert_allclose(R[v].numpy(), np.asarray(Rj), atol=1e-4)
        np.testing.assert_allclose(tv[v].numpy(), np.asarray(tj), atol=1e-4)

    got = intr.calibrate_intrinsics(board, img, mask=mask, device="cpu")
    want = jintr.calibrate_intrinsics(board, img, mask=mask)
    assert int(got.iters) > 0
    assert _rel(got.K.numpy(), want.K) < 1e-3
    dist, dist_j = got.dist.numpy(), np.asarray(want.dist)
    np.testing.assert_allclose(dist[:4], dist_j[:4], atol=1e-3)
    # k3 scales r⁶, which the board's few outer points barely constrain
    assert abs(dist[4] - dist_j[4]) < 5e-3 * max(1.0, abs(dist_j[4]))
    assert abs(float(got.rms_px) - float(want.rms_px)) < 1e-3
    np.testing.assert_allclose(got.K.numpy()[:2], K_TRUE[:2],
                               rtol=0.02 if kind == "masked" else 1e-3)


def test_grid_helpers_match_jax_element_for_element():
    np.testing.assert_array_equal(intr.make_grid(ROWS, COLS, SPACING),
                                  jintr.make_grid(ROWS, COLS, SPACING))
    board = intr.make_grid(ROWS, COLS, SPACING).astype(np.float64)
    obj3 = np.concatenate([board, np.zeros((len(board), 1))], axis=-1)
    rng = np.random.default_rng(11)
    for rvec, tv in _poses(6):
        uv = cv2.projectPoints(obj3, rvec, tv, K_TRUE, DIST_TRUE)[0].reshape(
            -1, 2)
        perm = rng.permutation(len(uv))
        order, resid = intr.order_grid(uv[perm], ROWS, COLS)
        order_j, resid_j = jintr.order_grid(uv[perm], ROWS, COLS)
        np.testing.assert_array_equal(order, order_j)
        assert resid == resid_j and resid < 0.1
    assert intr.order_grid(board[:-1], ROWS, COLS)[0] is None
    quad = np.array([[0, 0], [3, 0], [3, 2], [0, 2.0]])
    np.testing.assert_array_equal(
        intr._homography_np(quad, quad * 2 + 1),
        jintr._homography_np(quad, quad * 2 + 1))


def test_too_few_views_raises():
    board, img = _views(4)
    with pytest.raises(ValueError, match="3 views"):
        intr.calibrate_intrinsics(board, img[:2], device="cpu")
