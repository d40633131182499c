"""Trajectory evaluation metrics: ATE and RPE.

Counterpart (a copy; numpy only) of ``low_cost_mocap_tpu/utils/metrics.py``:
absolute trajectory error, plain and after a rigid (or similarity)
alignment, relative pose error, and the reprojection RMSE, held against
synthetic ground truth or a recording with known geometry.
"""

from __future__ import annotations

import numpy as np


def ate(estimated: np.ndarray, reference: np.ndarray,
        valid: np.ndarray | None = None) -> dict:
    """Absolute trajectory error between (T, 3) tracks, same frame/scale.

    Returns rmse / mean / median / max in the input units.
    """
    est = np.asarray(estimated, np.float64)
    ref = np.asarray(reference, np.float64)
    if valid is not None:
        est = est[np.asarray(valid, bool)]
        ref = ref[np.asarray(valid, bool)]
    e = np.linalg.norm(est - ref, axis=-1)
    return {
        "rmse": float(np.sqrt(np.mean(e**2))),
        "mean": float(np.mean(e)),
        "median": float(np.median(e)),
        "max": float(np.max(e)),
        "n": int(len(e)),
    }


def ate_aligned(estimated: np.ndarray, reference: np.ndarray,
                valid: np.ndarray | None = None,
                with_scale: bool = False) -> dict:
    """ATE after optimal rigid (optionally similarity) alignment (Umeyama).

    Use when the estimate lives in an arbitrary gauge (e.g. raw camera-0
    frame before floor/origin/scale fixing).
    """
    est = np.asarray(estimated, np.float64)
    ref = np.asarray(reference, np.float64)
    if valid is not None:
        est = est[np.asarray(valid, bool)]
        ref = ref[np.asarray(valid, bool)]
    mu_e = est.mean(axis=0)
    mu_r = ref.mean(axis=0)
    E = est - mu_e
    R_ = ref - mu_r
    S = R_.T @ E / len(est)
    U, D, Vt = np.linalg.svd(S)
    sgn = np.sign(np.linalg.det(U @ Vt))
    C = np.diag([1.0, 1.0, sgn])
    rot = U @ C @ Vt
    if with_scale:
        var_e = (E**2).sum() / len(est)
        scale = np.trace(np.diag(D) @ C) / var_e
    else:
        scale = 1.0
    aligned = scale * E @ rot.T + mu_r
    return ate(aligned, ref)


def rpe(estimated: np.ndarray, reference: np.ndarray, delta: int = 1) -> dict:
    """Relative pose (translation drift) error over ``delta``-frame windows."""
    est = np.asarray(estimated, np.float64)
    ref = np.asarray(reference, np.float64)
    de = est[delta:] - est[:-delta]
    dr = ref[delta:] - ref[:-delta]
    e = np.linalg.norm(de - dr, axis=-1)
    return {
        "rmse": float(np.sqrt(np.mean(e**2))),
        "mean": float(np.mean(e)),
        "max": float(np.max(e)),
    }


def reprojection_rmse_px(errors: np.ndarray,
                         valid: np.ndarray | None = None) -> float:
    """RMSE in pixels from the pipeline's per-point mean-squared errors."""
    e = np.asarray(errors, np.float64)
    if valid is not None:
        e = e[np.asarray(valid, bool)]
    e = e[np.isfinite(e)]
    return float(np.sqrt(np.mean(e))) if len(e) else float("nan")
