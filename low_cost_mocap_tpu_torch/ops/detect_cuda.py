"""Blob detection through the ``detect_blobs`` CUDA kernel.

Replaces ``low_cost_mocap_tpu/ops/detect_pallas.py:find_blobs_pallas``.
The kernel (``csrc/detect_blobs.cu``) propagates labels only in tiles that
hold a lit pixel, stops a tile's sweeps at their fixed point, and records
the lit pixels and a presence bit per label; a second grid takes the first
K roots in raster order and their integer moments.  It agrees with the
plain version (``ops/detect.py:find_blobs_multi``) bitwise, for any
``cc_iters``: sweeps beyond what one block's shared memory holds run in
further passes.

``find_blobs`` takes the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``launches`` counts the calls
that launched it (one per call, whatever the number of passes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from low_cost_mocap_tpu_torch.ops import detect, native

NAME = "detect_blobs"
launches = 0


def _lib():
    lib = native.load(NAME)
    if not getattr(lib, "_lcm_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lcm_detect_blobs.argtypes = [P, I, I, I, Fl, I, I, P, P, P]
        lib.lcm_detect_blobs.restype = I
        lib.lcm_detect_work_ints.argtypes = [I, I, I, I]
        lib.lcm_detect_work_ints.restype = ctypes.c_longlong
        lib._lcm_typed = True
    return lib


@functools.lru_cache(maxsize=16)
def _work_ints(C: int, H: int, W: int, cc_iters: int) -> int:
    """int32 work space of a launch (the kernel zeroes what it needs)."""
    return _lib().lcm_detect_work_ints(C, H, W, cc_iters)


def find_blobs(frames, threshold: float, max_blobs: int, cc_iters: int = 24,
               integer_centroids: bool = False):
    """(C, H, W) float32 frames -> (centroids (C, K, 2), valid (C, K) bool,
    sizes (C, K) f32); the contract of ``detect.find_blobs_multi``.  On the
    card the three outputs are views of one allocation, except floored
    centroids (``integer_centroids``), a cast of the kernel's."""
    global launches
    if not native.on_card(frames):
        return detect.find_blobs_multi(frames, threshold, max_blobs, cc_iters,
                                       integer_centroids)
    if (frames.dtype != torch.float32 or frames.dim() != 3
            or not frames.is_contiguous()):
        raise ValueError("frames must be contiguous (C, H, W) float32")
    if max_blobs < 1 or cc_iters < 0:
        raise ValueError("max_blobs must be >= 1 and cc_iters >= 0")
    C, H, W = frames.shape
    if H * W >= 2**31:
        raise ValueError("a frame must have fewer than 2^31 pixels")
    lib = _lib()
    K = max_blobs
    dev = frames.device
    work = torch.empty(_work_ints(C, H, W, cc_iters), dtype=torch.int32,
                       device=dev)
    out = torch.empty(C * K * 13, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):   # the C launcher uses the current device
        native.check(lib.lcm_detect_blobs(
            frames.data_ptr(), C, H, W, float(threshold), K, cc_iters,
            work.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), NAME)
    launches += 1
    floats = out[:C * K * 12].view(torch.float32)
    cent = floats[:C * K * 2].view(C, K, 2)
    return (torch.floor(cent) if integer_centroids else cent,
            out[C * K * 12:].view(torch.bool).view(C, K),
            floats[C * K * 2:].view(C, K))
