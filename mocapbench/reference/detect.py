"""Plain blob detection: threshold, 8-connected components, binary centroids.

Written from the detector's stated semantics, not from its code: a pixel is
lit when its uint8 value ``v`` passes the float32 test
``v * f32(1/255) > f32(threshold)``; components are 8-connected within one
camera, ordered by their lowest raster index, and the first ``max_blobs``
are kept; a centroid is ``f32(sum x) / f32(count)`` (exact while the sums
stay below 2**24).  scipy's labelling numbers components in raster order of
their first pixel, which is that order.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# 8-connectivity inside a camera's image, none across cameras or frames
_STRUCTURE = np.zeros((3, 3, 3), bool)
_STRUCTURE[1] = True


def lit_cutoff(threshold: float) -> int:
    """The smallest uint8 value that passes the float32 threshold test."""
    v = np.arange(256, dtype=np.float32) * np.float32(1.0 / 255.0)
    passes = v > np.float32(threshold)
    return int(np.argmax(passes)) if passes.any() else 256


def find_blobs(frames_u8: np.ndarray, threshold: float, max_blobs: int):
    """(..., H, W) uint8 images -> (centroids (..., K, 2) float32 xy,
    valid (..., K) bool)."""
    lead, (H, W) = frames_u8.shape[:-2], frames_u8.shape[-2:]
    imgs = frames_u8.reshape(-1, H, W)
    n = imgs.shape[0]
    K = max_blobs
    cent = np.zeros((n, K, 2), np.float32)
    valid = np.zeros((n, K), bool)
    labels, count = ndimage.label(imgs >= lit_cutoff(threshold), _STRUCTURE)
    if count:
        flat = labels.reshape(n, H * W)
        img_of, pix = np.nonzero(flat)
        lab = flat[img_of, pix]
        m = np.bincount(lab, minlength=count + 1)
        sx = np.bincount(lab, weights=pix % W, minlength=count + 1)
        sy = np.bincount(lab, weights=pix // W, minlength=count + 1)
        owner = np.zeros(count + 1, np.int64)
        owner[lab] = img_of
        # labels ascend in raster order, so within an image the first K
        # labels seen are its first K components
        labs = np.arange(1, count + 1)
        own = owner[1:]
        start = np.searchsorted(own, np.arange(n), side="left")
        rank = labs - 1 - start[own]
        keep = rank < K
        li, im, rk = labs[keep], own[keep], rank[keep]
        mf = m[li].astype(np.float32)
        cent[im, rk, 0] = sx[li].astype(np.float32) / mf
        cent[im, rk, 1] = sy[li].astype(np.float32) / mf
        valid[im, rk] = True
    return cent.reshape(*lead, K, 2), valid.reshape(*lead, K)
