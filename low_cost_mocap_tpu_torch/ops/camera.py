"""Camera model: projection, distortion, undistortion, projection matrices.

Counterpart of ``low_cost_mocap_tpu/ops/camera.py``, with the same
operation order.  Blob centroids are undistorted analytically (about ten
flops a point) instead of dewarping whole frames; cameras stack along a
leading axis so one call handles the rig, and any further leading axes
(a batch of frames) broadcast.
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
