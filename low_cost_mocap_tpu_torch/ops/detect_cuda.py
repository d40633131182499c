"""Blob detection through the ``detect_blobs`` CUDA kernel.

Replaces ``low_cost_mocap_tpu/ops/detect_pallas.py:find_blobs_pallas``.
The kernel (``csrc/detect_blobs.cu``) runs as two grids — tiled label
propagation with a ``cc_iters`` halo, then root extraction and integer
moments with one block per camera — and agrees with the plain version
(``ops/detect.py:find_blobs_multi``) bitwise.

``find_blobs`` takes the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``launches`` counts the calls
that launched it (one per call: both grids of one detection).
"""

from __future__ import annotations

import ctypes

import torch

from low_cost_mocap_tpu_torch.ops import detect, native

NAME = "detect_blobs"
launches = 0

_SMEM_LIMIT = 227 * 1024     # a block's shared memory on Hopper


def _lib():
    lib = native.load(NAME)
    if not getattr(lib, "_lcm_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lcm_detect_blobs.argtypes = [P, I, I, I, Fl, I, I, P, P, P, P, P]
        lib.lcm_detect_blobs.restype = I
        lib.lcm_detect_smem_bytes.argtypes = [I]
        lib.lcm_detect_smem_bytes.restype = I
        lib._lcm_typed = True
    return lib


def find_blobs(frames, threshold: float, max_blobs: int, cc_iters: int = 24):
    """(C, H, W) float32 frames -> (centroids (C, K, 2), valid (C, K) bool,
    sizes (C, K) f32); the contract of ``detect.find_blobs_multi``."""
    global launches
    if not native.on_card(frames):
        return detect.find_blobs_multi(frames, threshold, max_blobs, cc_iters)
    if frames.dtype != torch.float32 or frames.dim() != 3:
        raise ValueError("frames must be (C, H, W) float32")
    if max_blobs < 1 or cc_iters < 0:
        raise ValueError("max_blobs must be >= 1 and cc_iters >= 0")
    lib = _lib()
    if lib.lcm_detect_smem_bytes(cc_iters) > _SMEM_LIMIT:
        raise ValueError(f"cc_iters={cc_iters} needs more shared memory "
                         "than a block has")
    frames = frames.contiguous()
    C, H, W = frames.shape
    K = max_blobs
    dev = frames.device
    labels = torch.empty((C, H, W), dtype=torch.int32, device=dev)
    cent = torch.empty((C, K, 2), dtype=torch.float32, device=dev)
    valid = torch.empty((C, K), dtype=torch.bool, device=dev)
    size = torch.empty((C, K), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.check(lib.lcm_detect_blobs(
        frames.data_ptr(), C, H, W, float(threshold), K, cc_iters,
        labels.data_ptr(), cent.data_ptr(), valid.data_ptr(), size.data_ptr(),
        stream), NAME)
    launches += 1
    return cent, valid, size
