"""Synthetic rig fixtures: known cameras + markers -> observations/frames.

The port's numpy-only copy of ``low_cost_mocap_tpu/utils/synthetic.py``:
a ring of cameras with known extrinsics, random points, their projections
with a visibility mask, Gaussian blobs rendered into frames, and the
reference's 3-LED drone marker layout.
"""

from __future__ import annotations

import numpy as np

from low_cost_mocap_tpu_torch.config import RigConfig, image_hw


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    """World->camera R, t with +z forward (OpenCV convention)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-8:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # rows: camera axes in world frame
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def ring_rig(num_cameras: int = 4, radius: float = 2.5, height: float = 1.8,
             image_size=320, target=(0.0, 0.0, 0.5)):
    """Cameras on a ring, all aimed at ``target``. Returns (Rs, ts, rig)."""
    Rs, ts = [], []
    for i in range(num_cameras):
        ang = 2.0 * np.pi * i / num_cameras
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        R, t = look_at(eye, np.asarray(target))
        Rs.append(R)
        ts.append(t)
    rig = RigConfig(num_cameras=num_cameras, image_size=image_size)
    return np.stack(Rs), np.stack(ts), rig


def random_points(rng: np.random.Generator, n: int, lo=(-0.6, -0.6, 0.1),
                  hi=(0.6, 0.6, 1.2)) -> np.ndarray:
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    return (rng.random((n, 3)) * (hi - lo) + lo).astype(np.float32)


def observe(X: np.ndarray, Rs, ts, rig: RigConfig, noise_px: float = 0.0,
            rng: np.random.Generator | None = None):
    """Project points into every camera; add pixel noise; visibility mask.

    Returns (pts_px (N, C, 2), mask (N, C)) — mask is False off-frame.
    """
    K = rig.K_stack()
    Xc = np.einsum("cij,nj->cni", np.asarray(Rs), np.asarray(X)) \
        + np.asarray(ts)[:, None, :]                       # (C, N, 3)
    xy = Xc[..., :2] / Xc[..., 2:3]
    fx = K[:, None, 0, 0]
    fy = K[:, None, 1, 1]
    cx = K[:, None, 0, 2]
    cy = K[:, None, 1, 2]
    pts = np.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], axis=-1)
    pts = np.transpose(pts, (1, 0, 2)).astype(np.float32)  # (N, C, 2)
    if noise_px > 0:
        if rng is None:
            raise ValueError("noise_px > 0 needs an rng")
        pts = pts + rng.normal(scale=noise_px, size=pts.shape).astype(
            np.float32)
    h, w = rig.image_hw()
    mask = ((pts[..., 0] >= 0.0) & (pts[..., 0] <= w - 1.0)
            & (pts[..., 1] >= 0.0) & (pts[..., 1] <= h - 1.0))
    return pts, mask


def render_frames(pts_px: np.ndarray, mask: np.ndarray, image_size,
                  sigma: float = 1.5, amplitude: float = 1.0) -> np.ndarray:
    """Render Gaussian blobs into (C, H, W) float32 frames in [0, 1],
    evaluating a 5-sigma window around each blob."""
    N, C, _ = pts_px.shape
    H, W = image_hw(image_size)
    r = max(int(np.ceil(5.0 * sigma)), 2)
    frames = np.zeros((C, H, W), np.float32)
    for c in range(C):
        for n in range(N):
            if not mask[n, c]:
                continue
            x0, y0 = pts_px[n, c]
            xa, xb = int(np.floor(x0)) - r, int(np.floor(x0)) + r + 1
            ya, yb = int(np.floor(y0)) - r, int(np.floor(y0)) + r + 1
            xa_c, xb_c = max(xa, 0), min(xb, W)
            ya_c, yb_c = max(ya, 0), min(yb, H)
            if xa_c >= xb_c or ya_c >= yb_c:
                continue
            gx = np.arange(xa_c, xb_c, dtype=np.float32)
            gy = np.arange(ya_c, yb_c, dtype=np.float32)
            d2 = ((gx[None, :] - x0) ** 2 + (gy[:, None] - y0) ** 2)
            frames[c, ya_c:yb_c, xa_c:xb_c] += amplitude * np.exp(
                -d2 / (2.0 * sigma**2))
    return np.clip(frames, 0.0, 1.0)


def drone_markers(pos: np.ndarray, heading: float,
                  rig: RigConfig) -> np.ndarray:
    """The reference's 3-LED drone layout: two arm LEDs
    ``marker_dist_long`` apart centred on ``pos``, a third LED
    ``marker_dist_short`` from each on the +y side.  Returns (3, 3)."""
    half = rig.marker_dist_long / 2.0
    h = float(np.sqrt(max(rig.marker_dist_short**2 - half**2, 1e-8)))
    local = np.array(
        [[half, 0.0, 0.0], [-half, 0.0, 0.0], [0.0, h, 0.0]], np.float32)
    c, s = np.cos(heading), np.sin(heading)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    return (local @ Rz.T) + np.asarray(pos, np.float32)
