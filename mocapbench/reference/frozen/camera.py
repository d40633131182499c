"""Frozen copy of ``low_cost_mocap_tpu_torch/ops/camera.py`` (commit
9b1e9ac), its imports made relative; the benchmark's reference runs it
op by op and never imports the program.

Camera model: projection, distortion, undistortion, projection matrices.

Counterpart of ``low_cost_mocap_tpu/ops/camera.py``, with the same
operation order.  Blob centroids are undistorted analytically (about ten
flops a point) instead of dewarping whole frames; cameras stack along a
leading axis so one call handles the rig, and any further leading axes
(a batch of frames) broadcast.  ``build_undistort_map`` and
``undistort_image`` remap whole frames for display.
"""

from __future__ import annotations

import torch


def distort_normalized(xy, dist):
    """Apply 5-term radial/tangential distortion to (..., 2) normalized
    coordinates; ``dist`` is (..., 5) [k1, k2, p1, p2, k3]."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x_t = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + x_t, y * radial + y_t], dim=-1)


def undistort_normalized(xy_d, dist, iters: int = 8):
    """Invert the distortion map by ``iters`` fixed-point iterations."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        x_t = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x_new = (xy_d[..., 0] - x_t) / radial
        y_new = (xy_d[..., 1] - y_t) / radial
        xy = torch.stack([x_new, y_new], dim=-1)
    return xy


def pixels_to_normalized(px, K):
    """(..., 2) pixels -> normalized coords given (..., 3, 3) intrinsics."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([(px[..., 0] - cx) / fx, (px[..., 1] - cy) / fy],
                       dim=-1)


def normalized_to_pixels(xy, K):
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], dim=-1)


def undistort_points(px, K, dist, iters: int = 8):
    """Undistort pixel coordinates; the output is pixels under the same K."""
    xy_d = pixels_to_normalized(px, K)
    xy = undistort_normalized(xy_d, dist, iters=iters)
    return normalized_to_pixels(xy, K)


def project_points(X, R, t, K, dist=None):
    """Project world points into a camera.

    X: (..., N, 3); R: (..., 3, 3); t: (..., 3); K: (..., 3, 3); dist:
    optional (..., 5).  Returns (..., N, 2) pixel coordinates.
    """
    Xc = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    xy = Xc[..., :2] / Xc[..., 2:3]
    if dist is not None:
        xy = distort_normalized(xy, dist[..., None, :])
    return normalized_to_pixels(xy, K[..., None, :, :])


def projection_matrix(K, R, t):
    """P = K [R | t]: (..., 3, 4) from (..., 3, 3), (..., 3, 3), (..., 3)."""
    Rt = torch.cat([R, t[..., :, None]], dim=-1)
    return K @ Rt


def build_undistort_map(K, dist, height: int, width: int):
    """(H, W, 2) float32 source pixel (x, y) of every destination pixel of
    the undistorted frame, computed once; ``undistort_image`` samples it.
    The display path's full-frame remap (tracking undistorts centroids)."""
    ys = torch.arange(height, dtype=torch.float32, device=K.device)
    xs = torch.arange(width, dtype=torch.float32, device=K.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")               # (H, W)
    xy = pixels_to_normalized(torch.stack([gx, gy], dim=-1), K)
    return normalized_to_pixels(distort_normalized(xy, dist), K)


def undistort_image(img, smap):
    """Bilinear resample of ``img`` (H, W) or (H, W, C) at the source map
    ``smap`` (H, W, 2), clamped to the frame; float32 out."""
    H, W = img.shape[0], img.shape[1]
    x = torch.clamp(smap[..., 0], 0.0, W - 1.0)
    y = torch.clamp(smap[..., 1], 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    wx = x - x0.to(x.dtype)
    wy = y - y0.to(y.dtype)
    if img.dim() == 3:
        wx, wy = wx[..., None], wy[..., None]
    f = img.to(torch.float32)
    top = f[y0, x0] * (1 - wx) + f[y0, x1] * wx
    bot = f[y1, x0] * (1 - wx) + f[y1, x1] * wx
    return top * (1 - wy) + bot * wy
