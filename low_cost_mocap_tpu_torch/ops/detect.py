"""Blob detection front-end: threshold -> connected components -> centroids.

Counterpart of ``low_cost_mocap_tpu/ops/detect.py``: the blur + sharpen
preprocessing, host-side threshold + 1-bit packing and lit-pixel
extraction (sparse ingest), device-side unpacking and scattering, and the
plain PyTorch detector.

Preprocessing composes the reference's 9x9 Gaussian blur and 5x5 sharpen
kernel into one 13x13 kernel (convolution is associative) and applies it
to all cameras in one ``conv2d``, a cross-correlation as JAX's
``lax.conv`` is, with the same zero padding; the kernel is built once per
device.
The detector labels each lit pixel with its raster index, runs
``cc_iters`` masked 3x3 min-label sweeps (out-of-frame pixels count as
``big`` = H*W), takes the first K distinct labels in ascending (raster)
order and their binary moments.  It is the plain version of the
``detect_blobs`` CUDA kernel (``ops/detect_cuda.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        # OpenCV's default sigma for GaussianBlur(ksize, sigmaX=0)
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


# The reference's hand-tuned sharpen kernel (computer_code/api/helpers.py:76-80)
SHARPEN_KERNEL = np.array(
    [
        [-2, -1, -1, -1, -2],
        [-1, 1, 3, 1, -1],
        [-1, 3, 4, 3, -1],
        [-1, 1, 3, 1, -1],
        [-2, -1, -1, -1, -2],
    ],
    dtype=np.float32,
)


@functools.lru_cache(maxsize=8)
def fused_preprocess_kernel(blur_ksize: int = 9,
                            sigma: float = 0.0) -> np.ndarray:
    """Gaussian blur and sharpen composed into one (blur_ksize + 4)^2
    kernel: sharpen * (gauss * img) == (sharpen * gauss) * img."""
    from scipy.signal import convolve2d

    g1 = _gaussian_kernel_1d(blur_ksize, sigma)
    g2 = np.outer(g1, g1)
    return convolve2d(SHARPEN_KERNEL, g2, mode="full").astype(np.float32)


@functools.cache
def _preprocess_weight(blur_ksize: int, sigma: float, device: torch.device):
    """The fused kernel on ``device``, kept for the life of the process (a
    captured graph reads it by address)."""
    k = torch.from_numpy(fused_preprocess_kernel(blur_ksize, sigma))
    return k[None, None].to(device)                 # (1, 1, kh, kw)


def preprocess(frames, blur_ksize: int = 9, sigma: float = 0.0):
    """Blur + sharpen all camera frames in one conv.

    frames: (C, H, W) float32 in [0, 1].  Returns the same shape, clipped
    to [0, 1] (the uint8 saturation the reference gets implicitly).
    """
    w = _preprocess_weight(blur_ksize, float(sigma), frames.device)
    kh, kw = w.shape[-2:]
    out = F.conv2d(frames[:, None], w, padding=(kh // 2, kw // 2))[:, 0]
    return torch.clamp(out, 0.0, 1.0)


@functools.lru_cache(maxsize=64)
def threshold_cutoff(threshold: float) -> int:
    """Smallest uint8 pixel value passing the float32 device threshold test
    (``v * f32(1/255) > f32(threshold)``), or 256 when none does."""
    passes = (np.arange(256, dtype=np.float32)
              * np.float32(1.0 / 255.0)) > np.float32(threshold)
    return int(np.argmax(passes)) if passes.any() else 256


def pack_frames(frames_u8: np.ndarray, threshold: float) -> np.ndarray:
    """Host-side threshold + bit-pack of (C, H, W) uint8 frames, rows
    MSB-first (``np.packbits``).  The float32 test is monotone in the pixel
    value, so it reduces to one compare against ``threshold_cutoff``."""
    frames_u8 = np.asarray(frames_u8)
    if frames_u8.dtype != np.uint8:
        raise TypeError(
            f"pack_frames expects uint8 frames, got {frames_u8.dtype}; "
            "convert with (frames * 255).astype(np.uint8)")
    cutoff = threshold_cutoff(float(threshold))
    if cutoff > 255:
        return np.zeros(frames_u8.shape[:-1] + (frames_u8.shape[-1] // 8,),
                        np.uint8)
    return np.packbits(frames_u8 >= cutoff, axis=-1)


def sparse_ingest(frames_u8: np.ndarray, threshold: float,
                  budget: int) -> tuple[np.ndarray, bool, np.ndarray]:
    """Host-side threshold + lit-pixel index extraction (the sparsest
    ingest: thresholded mocap frames are almost all dark).

    Returns (idx, ok, packed): idx is (budget,) int32 raster indices of the
    lit pixels, padded with INT32_MAX (dropped by ``scatter_pixels``); ok is
    False when more than ``budget`` pixels are lit, and the caller then
    uploads the dense ``packed`` bitmap, which one packing pass gives too.
    """
    from low_cost_mocap_tpu_torch.control.bindings import extract_bits

    packed = pack_frames(frames_u8, threshold)
    idx, count = extract_bits(packed, budget)
    return idx, count <= budget, packed


def scatter_pixels(idx, shape):
    """(budget,) lit-pixel indices -> (C, H, W) float32 binary frames.

    The device-side inverse of ``sparse_ingest``: indices outside
    [0, C*H*W) (the INT32_MAX padding) are dropped.  ``index_put_`` would
    not drop them, so they are sent to one spare element past the end,
    without a host synchronisation.  Equal to ``unpack_bits`` of the packed
    bitmap whenever the budget was not exceeded."""
    C, H, W = shape
    n = C * H * W
    idx = idx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    flat = torch.zeros(n + 1, dtype=torch.float32, device=idx.device)
    flat.index_fill_(0, idx, 1.0)
    return flat[:n].reshape(C, H, W)


def unpack_bits(packed):
    """(..., W//8) uint8 bit-packed rows -> (..., W) float32 binary frames
    (MSB first, ``np.packbits`` order)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(
        torch.float32)


def _min_label_step(labels, big: int):
    """min over the 8-neighbourhood + self, out-of-frame pixels = big."""
    p = F.pad(labels, (1, 1, 1, 1), value=big)
    H, W = labels.shape[-2:]
    vert = torch.minimum(torch.minimum(p[..., 2:, 1:-1], p[..., :-2, 1:-1]),
                         p[..., 1:-1, 1:-1])
    vp = F.pad(vert, (1, 1), value=big)
    return torch.minimum(torch.minimum(vp[..., 2:], vp[..., :-2]), vert)


def find_blobs_multi(frames, threshold: float, max_blobs: int,
                     cc_iters: int = 24, integer_centroids: bool = False):
    """Detect up to ``max_blobs`` blobs per camera.

    frames: (C, H, W) float32.  Returns (centroids (C, K, 2) xy pixels,
    valid (C, K) bool, sizes (C, K) f32), components in raster order of
    their lowest pixel index.  Moments are integer sums, which equal the
    reference's float32 sums while they stay below 2^24.
    ``integer_centroids=True`` floors the centroids (the reference's
    ``int()`` cast).
    """
    C, H, W = frames.shape
    dev = frames.device
    big = H * W
    mask = frames > threshold
    idx = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(H, W)
    big_t = torch.tensor(big, dtype=torch.int32, device=dev)
    labels = torch.where(mask, idx, big_t)
    for _ in range(cc_iters):
        labels = torch.where(mask, _min_label_step(labels, big), big_t)

    flat = labels.reshape(C, H * W)
    cur = flat
    roots = []
    for _ in range(max_blobs):
        r = cur.min(dim=-1).values                              # (C,)
        cur = torch.where(cur == r[:, None], big_t, cur)
        roots.append(r)
    root_ids = torch.stack(roots, dim=1)                        # (C, K)
    slot_valid = root_ids < big

    member = flat[:, None, :] == root_ids[:, :, None]           # (C, K, HW)
    xs = idx.reshape(-1) % W
    ys = idx.reshape(-1) // W
    m00 = member.sum(dim=-1)
    sx = (member * xs).sum(dim=-1)
    sy = (member * ys).sum(dim=-1)
    m00_f = m00.to(torch.float32)
    m00_safe = torch.clamp_min(m00_f, 1.0)
    cent = torch.stack([sx.to(torch.float32) / m00_safe,
                        sy.to(torch.float32) / m00_safe], dim=-1)
    valid = slot_valid & (m00 > 0)
    cent = torch.where(valid[..., None], cent, 0.0)
    if integer_centroids:
        cent = torch.floor(cent)
    return cent, valid, m00_f * valid


def find_blobs(frame, threshold: float, max_blobs: int, cc_iters: int = 24,
               integer_centroids: bool = False):
    """One (H, W) frame: (centroids (K, 2), valid (K,), sizes (K,)).  The
    detector of ``ops/detect_cuda.find_blobs`` (the ``detect_blobs``
    kernel on the card) at one camera."""
    from low_cost_mocap_tpu_torch.ops import detect_cuda

    return tuple(x[0] for x in detect_cuda.find_blobs(
        frame[None].contiguous(), threshold, max_blobs, cc_iters,
        integer_centroids=integer_centroids))
