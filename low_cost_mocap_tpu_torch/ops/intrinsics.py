"""Intrinsic calibration from planar-target views (Zhang's method).

Counterpart of ``low_cost_mocap_tpu/ops/intrinsics.py``: observe a planar
dot grid in V poses and recover ``K = [[fx,0,cx],[0,fy,cy],[0,0,1]]`` and
the 5-term distortion ``[k1, k2, p1, p2, k3]`` of ``ops/camera.py``.

1. per view, a Hartley-normalised DLT homography board -> image (one
   batched SVD over the views);
2. closed-form K from the image of the absolute conic;
3. per-view extrinsics from the columns of ``K⁻¹ H``;
4. joint Levenberg-Marquardt over intrinsics, distortion and per-view
   poses, Marquardt damping with a unit floor, the Jacobian from
   ``torch.func.jacfwd``: ``ops/ba.py``'s chunk of ``ba.CHUNK``
   iterations over a frozen carry, a CUDA graph on the card kept per
   (views padded to a multiple of ``VIEW_BUCKET``, points, device);
   padded views have zero weight, so their residuals, gradient and
   Hessian block are zero and the damping floor leaves their poses put.

The last right singular vector of an SVD has an arbitrary sign; ``H /
H[2, 2]`` and the ratios of the conic's entries cancel it, as in the JAX
package.  ``make_grid``, ``order_grid`` and ``_homography_np`` are the
port's own numpy copies.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.ops import ba as ba_ops
from low_cost_mocap_tpu_torch.ops import camera as cam_ops
from low_cost_mocap_tpu_torch.ops import rotations as rot_ops
from low_cost_mocap_tpu_torch.runtime import compiled

VIEW_BUCKET = 8      # views are padded to a multiple of it
_STEPS = compiled.GraphCache()


class IntrinsicsResult(NamedTuple):
    K: torch.Tensor          # (3, 3)
    dist: torch.Tensor       # (5,) [k1, k2, p1, p2, k3]
    Rs: torch.Tensor         # (V, 3, 3) board->camera per view
    ts: torch.Tensor         # (V, 3)
    rms_px: torch.Tensor     # per-point RMS over valid points
    iters: torch.Tensor      # accepted LM steps


def _normalise(pts, w):
    """Similarity taking weighted (..., N, 2) points to mean 0 and RMS
    distance sqrt(2).  Returns (pts_n, T (..., 3, 3))."""
    wsum = torch.clamp_min(w.sum(dim=-1), 1e-9)[..., None]
    mean = (pts * w[..., None]).sum(dim=-2) / wsum
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(dim=-1))
    scale = math.sqrt(2.0) / torch.clamp_min((d * w).sum(dim=-1, keepdim=True)
                                             / wsum, 1e-9)
    scale = scale[..., 0]
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -mean[..., 0] * scale], dim=-1),
        torch.stack([zero, scale, -mean[..., 1] * scale], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return (pts - mean[..., None, :]) * scale[..., None, None], T


def homography_dlt(board_xy, img_xy, w):
    """DLT homographies board (N, 2) -> image (..., N, 2) with weights
    (..., N); masked points give zero rows.  Returns (..., 3, 3) with
    H[2, 2] = 1."""
    board = board_xy.expand(img_xy.shape)
    bn, Tb = _normalise(board, w)
    imn, Ti = _normalise(img_xy, w)
    x, y = bn[..., 0], bn[..., 1]
    u, v = imn[..., 0], imn[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (.., 2N, 9)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    Hn = Vt[..., -1, :].reshape(*Vt.shape[:-2], 3, 3)
    H = torch.linalg.solve(Ti, Hn) @ Tb
    return H / H[..., 2:3, 2:3]


def _vij(H, i, j):
    """Zhang's v_ij rows of (..., 3, 3) homographies: h_iᵀ B h_j in the
    6-vector basis."""
    h_i, h_j = H[..., :, i], H[..., :, j]
    return torch.stack([
        h_i[..., 0] * h_j[..., 0],
        h_i[..., 0] * h_j[..., 1] + h_i[..., 1] * h_j[..., 0],
        h_i[..., 1] * h_j[..., 1],
        h_i[..., 2] * h_j[..., 0] + h_i[..., 0] * h_j[..., 2],
        h_i[..., 2] * h_j[..., 1] + h_i[..., 1] * h_j[..., 2],
        h_i[..., 2] * h_j[..., 2],
    ], dim=-1)


def intrinsics_from_homographies(Hs, view_ok=None):
    """Closed-form K (zero skew) from (V, 3, 3) homographies, V >= 3.
    ``view_ok``: optional (V,) weights that keep views with too few points
    out of the conic estimate."""
    rows01 = _vij(Hs, 0, 1)
    rows00_11 = _vij(Hs, 0, 0) - _vij(Hs, 1, 1)
    if view_ok is not None:
        rows01 = rows01 * view_ok[:, None]
        rows00_11 = rows00_11 * view_ok[:, None]
    A = torch.cat([rows01, rows00_11], dim=0)                 # (2V, 6)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    B11, B12, B22, B13, B23, B33 = Vt[-1]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([torch.stack([alpha, zero, u0]),
                        torch.stack([zero, beta, v0]),
                        torch.stack([zero, zero, one])])


def extrinsics_from_homography(H, K):
    """Board poses (R, t) from (..., 3, 3) homographies and K."""
    A = torch.linalg.solve(K, H)                              # K⁻¹ H
    lam = 1.0 / torch.clamp_min(
        torch.linalg.vector_norm(A[..., :, 0], dim=-1), 1e-12)
    # cheirality: the board sits in front of the camera (t_z > 0)
    lam = (lam * torch.sign(A[..., 2, 2] + 1e-30))[..., None]
    r1, r2, t = lam * A[..., :, 0], lam * A[..., :, 1], lam * A[..., :, 2]
    Q = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
    U, _, Vt = torch.linalg.svd(Q)
    R = U @ Vt
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    return R, t


def _unpack(p, V):
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, zero, cx]),
                     torch.stack([zero, fy, cy]),
                     torch.stack([zero, zero, one])])
    pv = p[9:].reshape(V, 6)
    return K, p[4:9], rot_ops.rotvec_to_matrix(pv[:, :3]), pv[:, 3:]


def _residuals(p, board3, img_pts, w, V):
    K, dist, Rs, ts = _unpack(p, V)
    uv = cam_ops.project_points(board3, Rs, ts, K[None].expand(V, 3, 3),
                                dist[None].expand(V, 5))       # (V, N, 2)
    return ((uv - img_pts) * w[..., None]).reshape(-1)


def cached_steps() -> list:
    """The compiled LM chunks the cache holds."""
    return [st.step for st in _STEPS.values()]


def pad_views(img_pts, w, Rs0, ts0):
    """(V, N, 2) points, (V, N) weights and (V, 3, 3), (V, 3) poses padded
    to a multiple of ``VIEW_BUCKET`` views: zero points and weights, the
    board 1 m straight ahead."""
    V, N = img_pts.shape[0], img_pts.shape[1]
    pad = -V % VIEW_BUCKET
    if not pad:
        return img_pts, w, Rs0, ts0
    eye = torch.eye(3, dtype=Rs0.dtype, device=Rs0.device)
    return (torch.cat([img_pts, img_pts.new_zeros((pad, N, 2))]),
            torch.cat([w, w.new_zeros((pad, N))]),
            torch.cat([Rs0, eye.expand(pad, 3, 3)]),
            torch.cat([ts0, ts0.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)]))


def _cost(r):
    return 0.5 * (r * r).sum()


def _iteration(st, board3, img_pts, w, *, V: int):
    """One LM iteration over the (padded) views."""
    def res_with_aux(q):
        r = _residuals(q, board3, img_pts, w, V)
        return r, r

    J, r = jacfwd(res_with_aux, has_aux=True)(st.p)            # (M, P)
    H = J.T @ J
    g = J.T @ r
    # the damped diagonal is floored at lam: a fully masked view zeroes
    # its block of H, which damping by diag(H) alone leaves singular
    damp = torch.clamp_min(torch.diagonal(H), 1.0)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    delta = torch.linalg.solve_ex(H + st.lam * (eye * damp), -g)[0]
    p1 = st.p + delta
    c1 = _cost(_residuals(p1, board3, img_pts, w, V))
    return ba_ops.lm_advance(st, p1, c1, tol=1e-10, lam_min=1e-12,
                             lam_up=5.0, cost_min=1e-18)[0]


def refine(board_xy, img_pts, w, K0, Rs0, ts0, *, max_iters: int = 48,
           stats: dict | None = None):
    """Joint LM over intrinsics, distortion and per-view poses.

    board_xy: (N, 2) target points (z = 0, metres); img_pts: (V, N, 2)
    pixels; w: (V, N) weights.  The views are padded to a multiple of
    ``VIEW_BUCKET`` with zero-weight views.  Returns (K, dist, Rs, ts,
    rms_px, accepted_iters).  ``stats``, when given, gets ``iterations``
    (the LM iterations run until ``done``, the one that set it included,
    at most ``max_iters``), ``chunks`` and ``reads`` (``ops.ba.lm_run``).
    """
    V, N = img_pts.shape[0], img_pts.shape[1]
    dev, dt = img_pts.device, img_pts.dtype
    img_pts = torch.where(w[..., None] > 0, img_pts, 0.0)
    img_pts, w, Rs0, ts0 = pad_views(img_pts, w, Rs0, ts0)
    Vb = img_pts.shape[0]
    board3 = torch.cat([board_xy, torch.zeros_like(board_xy[:, :1])], dim=-1)
    rv0 = rot_ops.matrix_to_rotvec(Rs0)
    p0 = torch.cat([
        torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
        torch.zeros(5, dtype=K0.dtype, device=K0.device),
        torch.cat([rv0, ts0], dim=-1).reshape(-1),
    ])
    consts = (board3, img_pts, w)
    with ba_ops._LOCK:
        carry = ba_ops.lm_start(p0, _cost(_residuals(p0, *consts, Vb)),
                                max_iters)
        st = ba_ops.lm_run((Vb, N, ba_ops.CHUNK, dev, dt),
                           lambda: compiled.ChunkedScan(
                               functools.partial(_iteration, V=Vb), carry,
                               (), ba_ops.CHUNK, consts=consts,
                               stop=ba_ops.stopped, lazy=True,
                               name="intrinsics refine"),
                           carry, max_iters, consts, cache=_STEPS,
                           stats=stats)
    K, dist, Rs, ts = _unpack(st.p, Vb)
    n_valid = torch.clamp_min(w.sum(), 1.0)
    # OpenCV calibrateCamera's convention: sqrt(sum ||e_i||² / n_points)
    rms = torch.sqrt(2.0 * st.cost / n_valid)
    return K, dist, Rs[:V], ts[:V], rms, st.n_acc


def calibrate_intrinsics(board_xy, img_pts, mask=None, *,
                         max_iters: int = 48,
                         device=None) -> IntrinsicsResult:
    """Homographies -> closed-form K -> joint LM, on ``device`` (the card
    unless ``"cpu"`` is asked for).

    board_xy: (N, 2) target layout (metres, z = 0); img_pts: (V, N, 2)
    pixels per view; mask: optional (V, N) validity.  Needs V >= 3 views
    at different orientations.
    """
    dev = resolve_device(device)
    board_xy = torch.as_tensor(np.asarray(board_xy, np.float32), device=dev)
    img_pts = torch.as_tensor(np.asarray(img_pts, np.float32), device=dev)
    V, N = img_pts.shape[0], img_pts.shape[1]
    if V < 3:
        raise ValueError(f"need >= 3 views for intrinsics, got {V}")
    w = (torch.ones((V, N), dtype=torch.float32, device=dev) if mask is None
         else torch.as_tensor(np.asarray(mask, np.float32), device=dev))
    # masked slots may carry NaN sentinels; zero them before any weighted sum
    img_pts = torch.where(w[..., None] > 0, img_pts, 0.0)
    Hs = homography_dlt(board_xy, img_pts, w)
    # a view needs >= 4 points for a homography; keep the others out of the
    # conic system (the LM ignores them through the weights)
    view_ok = (w.sum(dim=1) >= 4).to(torch.float32)
    K0 = intrinsics_from_homographies(Hs, view_ok)
    Rs0, ts0 = extrinsics_from_homography(Hs, K0)
    # degenerate views can give non-finite poses: a benign placeholder
    # keeps NaN * 0 out of the LM cost (their residuals are weighted out)
    good = ((view_ok > 0) & torch.isfinite(Rs0).all(dim=-1).all(dim=-1)
            & torch.isfinite(ts0).all(dim=-1))
    eye = torch.eye(3, dtype=Rs0.dtype, device=dev)
    Rs0 = torch.where(good[:, None, None], Rs0, eye)
    ts0 = torch.where(good[:, None], ts0,
                      torch.tensor([0.0, 0.0, 1.0], device=dev))
    K, dist, Rs, ts, rms, iters = refine(board_xy, img_pts, w, K0, Rs0, ts0,
                                         max_iters=max_iters)
    return IntrinsicsResult(K, dist, Rs, ts, rms, iters)


# ---------------------------------------------------------------------------
# Dot-grid ordering: unordered detector blobs -> grid-indexed points (numpy)
# ---------------------------------------------------------------------------


def make_grid(rows: int, cols: int, spacing: float) -> np.ndarray:
    """(rows*cols, 2) planar target layout, row-major, metres."""
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    return np.stack([jj.reshape(-1), ii.reshape(-1)],
                    axis=-1).astype(np.float32) * spacing


def order_grid(points: np.ndarray, rows: int, cols: int,
               max_resid: float = 0.25):
    """Order an unordered (rows*cols, 2) point set into grid-major order.

    Estimates the projective frame from the set's extreme corners, maps
    every point into grid coordinates and snaps to integer nodes, over all
    8 corner labelings, keeping the bijective one with the lowest mean
    snap distance.  Returns (order, resid), ``points[order][k]`` being node
    (k // cols, k % cols), or (None, resid) when no labeling gives a
    consistent grid within ``max_resid`` (grid units).
    """
    pts = np.asarray(points, np.float64)
    n = rows * cols
    if pts.shape != (n, 2):
        return None, float("inf")
    ctr = pts.mean(axis=0)
    q = pts - ctr
    _, _, vt = np.linalg.svd(q, full_matrices=False)
    pq = q @ vt.T
    cands = [pts[int(np.argmax(a))] for a in
             (pq[:, 0] + pq[:, 1], pq[:, 0] - pq[:, 1],
              -pq[:, 0] - pq[:, 1], -pq[:, 0] + pq[:, 1])]
    corners_img = np.asarray(cands)
    grid_corners = np.array([[0.0, 0.0], [cols - 1.0, 0.0],
                             [cols - 1.0, rows - 1.0], [0.0, rows - 1.0]])
    best = (None, float("inf"))
    for mirror in (False, True):
        ci = corners_img[::-1] if mirror else corners_img
        for shift in range(4):
            H = _homography_np(grid_corners, np.roll(ci, shift, axis=0))
            if H is None:
                continue
            inv = np.linalg.inv(H)
            ph = np.concatenate([pts, np.ones((n, 1))], axis=-1) @ inv.T
            g = ph[:, :2] / ph[:, 2:3]                  # grid coords
            snap = np.rint(g)
            resid = float(np.linalg.norm(g - snap, axis=-1).mean())
            idx = snap[:, 1].astype(int) * cols + snap[:, 0].astype(int)
            ok = (snap[:, 0] >= 0).all() and (snap[:, 0] < cols).all() \
                and (snap[:, 1] >= 0).all() and (snap[:, 1] < rows).all() \
                and len(set(idx.tolist())) == n
            if ok and resid < best[1]:
                order = np.empty(n, int)
                order[idx] = np.arange(n)
                best = (order, resid)
    if best[0] is None or best[1] > max_resid:
        return None, best[1]
    return best


def _homography_np(src, dst):
    """Exact 4-point homography (numpy)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    A = np.asarray(A, np.float64)
    _, s, vt = np.linalg.svd(A)
    if s[-2] < 1e-12:                                   # degenerate quad
        return None
    H = vt[-1].reshape(3, 3)
    if abs(H[2, 2]) < 1e-12:
        return None
    return H / H[2, 2]
