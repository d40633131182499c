"""Extrinsics auto-calibration: pairwise pose bootstrap + bundle adjustment.

Counterpart of ``low_cost_mocap_tpu/models/calibrator.py``:

  1. for each adjacent camera pair, RANSAC estimates F, which lifts to E
     and decomposes into four motion candidates;
  2. cheirality picks the candidate that puts the most triangulated
     inliers in front of both cameras, tested in the canonical two-view
     frame [I|0], [R|t] with each pair's own intrinsics;
  3. pair poses chain into the camera-0 frame;
  4. bundle adjustment refines everything (``ops/ba.py``).

RANSAC's samples come from ``generator`` (one ``torch.Generator`` drawn in
pair order) or from ``index_tables``, one (iters, 8) table per adjacent
pair, which is how tests feed the port the JAX package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from low_cost_mocap_tpu_torch.ops import ba as ba_ops
from low_cost_mocap_tpu_torch.ops import epipolar as epi
from low_cost_mocap_tpu_torch.ops import ransac as ransac_ops
from low_cost_mocap_tpu_torch.ops import triangulate as tri
from low_cost_mocap_tpu_torch.ops.camera import projection_matrix


class CalibrationResult(NamedTuple):
    Rs: torch.Tensor          # (C, 3, 3) world->camera, camera-0 frame
    ts: torch.Tensor          # (C, 3)
    focals: torch.Tensor      # (C,) refined focal lengths
    mean_error: torch.Tensor  # mean reprojection error (mean squared px)
    ba_cost: torch.Tensor
    ba_iters: torch.Tensor


def _pair_relative_pose(pts1, pts2, pair_mask, K1, K2, ransac_iters,
                        threshold_px, idx=None, generator=None):
    """Relative pose (R, t) of camera b w.r.t. camera a, and the inliers."""
    if not bool(pair_mask.any()):
        raise ValueError("a camera pair shares no observation: nothing to "
                         "draw RANSAC samples from")
    F, inliers = ransac_ops.ransac_fundamental(
        pts1, pts2, pair_mask, iters=ransac_iters, threshold_px=threshold_px,
        idx=idx, generator=generator)
    Rcands, tcands = epi.motion_from_essential(
        epi.essential_from_fundamental(F, K1, K2))

    eye_R = torch.eye(3, dtype=pts1.dtype, device=pts1.device)
    zero_t = torch.zeros(3, dtype=pts1.dtype, device=pts1.device)
    pc = torch.stack([pts1, pts2], dim=1)                     # (N, 2, 2)
    m = torch.stack([inliers, inliers], dim=1)
    counts = []
    for Rc, tc in zip(Rcands, tcands):
        Ps = projection_matrix(torch.stack([K1, K2]), torch.stack([eye_R, Rc]),
                               torch.stack([zero_t, tc]))
        X, valid = tri.triangulate_points(pc, Ps, m)
        z2 = (X @ Rc.T + tc)[:, 2]
        ok = valid & inliers
        counts.append(((X[:, 2] > 0) & ok).sum() + ((z2 > 0) & ok).sum())
    best = torch.argmax(torch.stack(counts)).reshape(1)
    return (Rcands.index_select(0, best)[0], tcands.index_select(0, best)[0],
            inliers)


def bootstrap_poses(pts, mask, K_stack, ransac_iters: int = 512,
                    threshold_px: float = 1.0, *, generator=None,
                    index_tables=None):
    """Chain pairwise poses into the camera-0 frame.

    pts: (N, C, 2) image points over N frames; mask: (N, C).  Returns
    (Rs (C, 3, 3), ts (C, 3)), camera 0 at identity, translation scale
    arbitrary per pair: R_b = R_rel R_a, t_b = t_a + R_a t_rel.
    """
    C = pts.shape[1]
    Rs = [torch.eye(3, dtype=pts.dtype, device=pts.device)]
    ts = [torch.zeros(3, dtype=pts.dtype, device=pts.device)]
    for i in range(C - 1):
        R_rel, t_rel, _ = _pair_relative_pose(
            pts[:, i], pts[:, i + 1], mask[:, i] & mask[:, i + 1],
            K_stack[i], K_stack[i + 1], ransac_iters, threshold_px,
            idx=None if index_tables is None else index_tables[i],
            generator=generator)
        R_a, t_a = Rs[-1], ts[-1]
        Rs.append(R_rel @ R_a)
        ts.append(t_a + R_a @ t_rel)
    return torch.stack(Rs), torch.stack(ts)


def calibrate(pts, mask, K_stack, *, ransac_iters: int = 512,
              threshold_px: float = 1.0, ba_iters: int = 64,
              ba_mode: str = "pixel", progress_cb=None,
              progress_chunk: int = 8, generator=None,
              index_tables=None) -> CalibrationResult:
    """Full extrinsics calibration from captured image points.

    ``progress_cb(Rs, ts, iters_done)`` (numpy poses): when given, BA runs
    in chunks of ``progress_chunk`` iterations, each a fresh
    ``bundle_adjust`` from the last chunk's poses and K_stack's focals, as
    in the JAX package, and the callback fires between chunks.
    """
    C = pts.shape[1]
    Rs0, ts0 = bootstrap_poses(pts, mask, K_stack, ransac_iters=ransac_iters,
                               threshold_px=threshold_px, generator=generator,
                               index_tables=index_tables)
    if progress_cb is None:
        res = ba_ops.bundle_adjust(pts, mask, K_stack, Rs0, ts0,
                                   num_cameras=C, max_iters=ba_iters,
                                   mode=ba_mode)
    else:
        Rs_c, ts_c = Rs0, ts0
        done = 0
        while done < ba_iters:
            n = min(progress_chunk, ba_iters - done)
            res = ba_ops.bundle_adjust(pts, mask, K_stack, Rs_c, ts_c,
                                       num_cameras=C, max_iters=n,
                                       mode=ba_mode)
            Rs_c, ts_c = res.Rs, res.ts
            done += n
            progress_cb(res.Rs.cpu().numpy(), res.ts.cpu().numpy(), done)
    Ps = projection_matrix(ba_ops._apply_focals(K_stack, res.focals),
                           res.Rs, res.ts)
    X, _ = tri.triangulate_points(pts, Ps, mask)
    errs = tri.reprojection_errors(pts, X, Ps, mask)
    finite = torch.isfinite(errs)
    mean_err = torch.where(finite, errs, 0.0).sum() / torch.clamp_min(
        finite.sum(), 1)
    return CalibrationResult(res.Rs, res.ts, res.focals, mean_err,
                             res.cost, res.n_iters)
