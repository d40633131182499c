"""ctypes bindings to the port's copy of the native control runtime.

The port's own copy of ``low_cost_mocap_tpu/control/bindings.py`` over its
own copy of the C++ sources (``control/native/``): the drone cascade bank,
the point-mass simulator, SBUS framing, the jerk-limited trajectory
planner, and the host ingest path (threshold + 1-bit pack, lit-pixel
extraction, connected-component blob detection).

Build.  ``g++`` compiles every source into one shared library with the
flags of the JAX package's Makefile, under ``low_cost_mocap_tpu_torch/
_build/``.  The file name carries a hash of the sources and flags, the
library is written to a temporary file and moved into place, so processes
that build at once (test workers) never load a half-written file.  Nothing
is built at import.  A failed build raises: no caller falls back to
another path.

The library is loaded in ctypes' default ``RTLD_LOCAL`` mode: the JAX
package's library exports the same ``lcm_*`` symbols, and both may live in
one process (the tests load both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = _PKG / "_build"
# the source list and flags of low_cost_mocap_tpu/control/native/Makefile
SOURCES = ("pid.cc", "json_lite.cc", "cascade.cc", "sbus.cc", "sim.cc",
           "otg.cc", "ingest.cc", "detect.cc", "lcm_control.cc")
CXX = "g++"
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library lives for the current sources and flags."""
    h = hashlib.sha256()
    for p in sorted(NATIVE_DIR.glob("*.cc")) + sorted(NATIVE_DIR.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"liblcmcontrol-{h.hexdigest()[:16]}.so"


def start_build():
    """Start ``g++`` unless the library is built; returns (process,
    temporary output, log path) or None.  ``finish_build`` waits for it, so
    a caller can build this library beside the CUDA kernels."""
    out = library_path()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    log_path = BUILD_DIR / f"liblcmcontrol.{os.getpid()}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [CXX, *CXX_FLAGS, "-o", str(tmp),
             *(str(NATIVE_DIR / s) for s in SOURCES)],
            stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, log_path


def finish_build(pending) -> Path:
    out = library_path()
    if pending is not None:
        proc, tmp, log_path = pending
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(f"{CXX} failed to build the native library "
                               f"(rc={rc}):\n{log_path.read_text()}")
        os.replace(tmp, out)
        log_path.unlink()
    return out


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every exported function."""
    P8 = ctypes.POINTER(ctypes.c_uint8)
    Pf = ctypes.POINTER(ctypes.c_float)
    Pd = ctypes.POINTER(ctypes.c_double)
    i32 = ctypes.c_int32
    lib.lcm_bank_create.restype = ctypes.c_void_p
    lib.lcm_bank_create.argtypes = [ctypes.c_int]
    lib.lcm_bank_destroy.argtypes = [ctypes.c_void_p]
    lib.lcm_bank_feed.restype = ctypes.c_int
    lib.lcm_bank_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_uint64]
    lib.lcm_bank_step.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_int16)]
    lib.lcm_bank_armed.restype = ctypes.c_int
    lib.lcm_bank_armed.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lcm_bank_pwm.argtypes = [ctypes.c_void_p, ctypes.c_int, Pd]

    lib.lcm_sim_create.restype = ctypes.c_void_p
    lib.lcm_sim_destroy.argtypes = [ctypes.c_void_p]
    lib.lcm_sim_step.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int16),
                                 ctypes.c_double]
    lib.lcm_sim_set_state.argtypes = [ctypes.c_void_p, Pd, Pd,
                                      ctypes.c_double]
    lib.lcm_sim_get_state.argtypes = [ctypes.c_void_p, Pd, Pd, Pd]

    lib.lcm_sbus_encode.argtypes = [ctypes.POINTER(ctypes.c_uint16),
                                    ctypes.c_int, P8]
    lib.lcm_sbus_decode.restype = ctypes.c_int
    lib.lcm_sbus_decode.argtypes = [P8, ctypes.POINTER(ctypes.c_uint16),
                                    ctypes.POINTER(ctypes.c_int)]

    lib.lcm_otg_plan.restype = ctypes.c_int
    lib.lcm_otg_plan.argtypes = [ctypes.c_int] + [Pd] * 5 + \
        [ctypes.c_double, Pd, ctypes.c_int]

    lib.lcm_pack_bits.argtypes = [P8, ctypes.c_int64, ctypes.c_uint8, P8]
    lib.lcm_extract_bits.restype = ctypes.c_int64
    lib.lcm_extract_bits.argtypes = [P8, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.c_int64]
    lib.lcm_detect_blobs_multi.argtypes = [P8, i32, i32, i32, i32, Pf, P8,
                                           Pf]
    lib.lcm_detect_blobs_weighted_multi.argtypes = [P8, P8, i32, i32, i32,
                                                    i32, Pf, P8, Pf]
    lib.lcm_ingest_detect_multi.argtypes = [P8, i32, i32, i32,
                                            ctypes.c_uint8, i32, i32, Pf, P8,
                                            Pf]
    lib.lcm_ingest_detect_packed.argtypes = [P8, i32, i32, i32,
                                             ctypes.c_uint8, i32, i32, Pf]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises if it cannot be
    built)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(finish_build(start_build())))
            _declare(lib)
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _dptr(a: np.ndarray):
    return _ptr(a, ctypes.c_double)


class CascadeBank:
    """Bank of per-drone control cascades with reference wire framing."""

    def __init__(self, num_drones: int):
        self._lib = get_lib()
        self._h = self._lib.lcm_bank_create(num_drones)
        self.num_drones = num_drones

    def feed(self, frame: bytes, now_us: int) -> int:
        """One '<digit><json>' frame (computer_code/api/helpers.py:121)."""
        return self._lib.lcm_bank_feed(self._h, frame, len(frame), now_us)

    def feed_command(self, drone_index: int, payload: dict,
                     now_us: int) -> int:
        import json

        frame = f"{drone_index}{json.dumps(payload)}".encode()
        return self.feed(frame, now_us)

    def step(self, drone_index: int, now_us: int) -> np.ndarray:
        out = np.zeros(16, np.int16)
        self._lib.lcm_bank_step(self._h, drone_index, now_us,
                                _ptr(out, ctypes.c_int16))
        return out

    def armed(self, drone_index: int) -> bool:
        return bool(self._lib.lcm_bank_armed(self._h, drone_index))

    def pwm(self, drone_index: int) -> np.ndarray:
        out = np.zeros(4, np.float64)
        self._lib.lcm_bank_pwm(self._h, drone_index, _dptr(out))
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lcm_bank_destroy(self._h)
            self._h = None


class DroneSimulator:
    """Point-mass quadrotor consuming cascade SBUS channels."""

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.lcm_sim_create()

    def step(self, channels: np.ndarray, dt: float) -> None:
        ch = np.ascontiguousarray(channels, np.int16)
        self._lib.lcm_sim_step(self._h, _ptr(ch, ctypes.c_int16), dt)

    def set_state(self, pos, vel=(0, 0, 0), yaw: float = 0.0) -> None:
        p = np.ascontiguousarray(pos, np.float64)
        v = np.ascontiguousarray(vel, np.float64)
        self._lib.lcm_sim_set_state(self._h, _dptr(p), _dptr(v), yaw)

    def get_state(self):
        p = np.zeros(3, np.float64)
        v = np.zeros(3, np.float64)
        yaw = ctypes.c_double()
        self._lib.lcm_sim_get_state(self._h, _dptr(p), _dptr(v),
                                    ctypes.byref(yaw))
        return p, v, yaw.value

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lcm_sim_destroy(self._h)
            self._h = None


def sbus_encode(channels: np.ndarray, flags: int = 0) -> bytes:
    ch = np.ascontiguousarray(channels, np.uint16)
    out = np.zeros(25, np.uint8)
    get_lib().lcm_sbus_encode(_ptr(ch, ctypes.c_uint16), flags,
                              _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def sbus_decode(frame: bytes):
    buf = np.frombuffer(frame, np.uint8).copy()
    ch = np.zeros(16, np.uint16)
    flags = ctypes.c_int()
    ok = get_lib().lcm_sbus_decode(_ptr(buf, ctypes.c_uint8),
                                   _ptr(ch, ctypes.c_uint16),
                                   ctypes.byref(flags))
    if not ok:
        return None
    return ch, flags.value


def plan_trajectory_segment(start, end, max_vel, max_accel, max_jerk,
                            timestep: float, max_steps: int = 100000):
    """Jerk-limited synchronized multi-DoF segment (Ruckig role).

    start/end: (D,) positions; limits scalars or (D,).  Returns (N, D)
    setpoints sampled at ``timestep``.
    """
    start = np.ascontiguousarray(start, np.float64)
    end = np.ascontiguousarray(end, np.float64)
    D = len(start)

    def lim(x):
        return np.ascontiguousarray(
            np.broadcast_to(np.asarray(x, np.float64), (D,)))

    out = np.zeros((max_steps, D), np.float64)
    n = get_lib().lcm_otg_plan(
        D, _dptr(start), _dptr(end), _dptr(lim(max_vel)),
        _dptr(lim(max_accel)), _dptr(lim(max_jerk)), timestep,
        _dptr(out.reshape(-1)), max_steps)
    return out[:n].copy()


def _check_frames(frames_u8: np.ndarray) -> None:
    if frames_u8.dtype != np.uint8 or frames_u8.shape[-1] % 8:
        raise ValueError(
            f"frames must be uint8 with W % 8 == 0, got "
            f"{frames_u8.dtype} {frames_u8.shape}")


def pack_bits(frames_u8: np.ndarray, cutoff: int) -> np.ndarray:
    """Fused threshold + MSB-first bit-pack along the last axis:
    ``np.packbits(frames_u8 >= cutoff, axis=-1)`` for a last axis
    divisible by 8 and ``cutoff`` <= 255."""
    _check_frames(frames_u8)
    flat = np.ascontiguousarray(frames_u8).reshape(-1)
    out = np.empty(flat.size // 8, np.uint8)
    get_lib().lcm_pack_bits(_ptr(flat, ctypes.c_uint8), flat.size,
                            np.uint8(cutoff), _ptr(out, ctypes.c_uint8))
    return out.reshape(*frames_u8.shape[:-1], frames_u8.shape[-1] // 8)


def detect_blobs(packed: np.ndarray, height: int, width: int,
                 max_blobs: int, gray: np.ndarray | None = None):
    """Blob detection over packed 1-bit frames (exact connected
    components, raster order, binary-mass float32 centroids).

    packed: (C, H, W//8) uint8 MSB-first bitmap (``pack_bits`` output).
    Returns (centroids (C, K, 2) f32 xy, valid (C, K) bool, sizes (C, K)).
    ``gray``: optional (C, H, W) uint8 original frames, for intensity-
    weighted centroids (components, order and sizes unchanged).
    """
    flat = np.ascontiguousarray(packed).reshape(-1)
    C = packed.shape[0]
    cent = np.zeros((C, max_blobs, 2), np.float32)
    valid = np.zeros((C, max_blobs), np.uint8)
    sizes = np.zeros((C, max_blobs), np.float32)
    outs = (_ptr(cent, ctypes.c_float), _ptr(valid, ctypes.c_uint8),
            _ptr(sizes, ctypes.c_float))
    if gray is not None:
        gflat = np.ascontiguousarray(gray, np.uint8).reshape(-1)
        get_lib().lcm_detect_blobs_weighted_multi(
            _ptr(flat, ctypes.c_uint8), _ptr(gflat, ctypes.c_uint8), C,
            height, width, max_blobs, *outs)
    else:
        get_lib().lcm_detect_blobs_multi(
            _ptr(flat, ctypes.c_uint8), C, height, width, max_blobs, *outs)
    return cent, valid.astype(bool), sizes


def ingest_detect(frames_u8: np.ndarray, cutoff: int, max_blobs: int,
                  weighted: bool = False):
    """Fused threshold + pack + connected-component centroids in one
    native call.  frames_u8: (C, H, W) uint8, W % 8 == 0; ``cutoff`` from
    ``ops.detect.threshold_cutoff``.  Returns (centroids (C, K, 2) f32 xy,
    valid (C, K) bool, sizes (C, K)), identical to ``pack_bits`` +
    ``detect_blobs``."""
    _check_frames(frames_u8)
    flat = np.ascontiguousarray(frames_u8).reshape(-1)
    C, H, W = frames_u8.shape
    cent = np.zeros((C, max_blobs, 2), np.float32)
    valid = np.zeros((C, max_blobs), np.uint8)
    sizes = np.zeros((C, max_blobs), np.float32)
    if cutoff > 255:        # threshold above every uint8 value: no blobs
        return cent, valid.astype(bool), sizes
    get_lib().lcm_ingest_detect_multi(
        _ptr(flat, ctypes.c_uint8), C, H, W, np.uint8(cutoff), max_blobs,
        int(weighted), _ptr(cent, ctypes.c_float),
        _ptr(valid, ctypes.c_uint8), _ptr(sizes, ctypes.c_float))
    return cent, valid.astype(bool), sizes


def ingest_detect_packed(frames_u8: np.ndarray, cutoff: int,
                         max_blobs: int, weighted: bool = False,
                         out: np.ndarray | None = None) -> np.ndarray:
    """Fused detection straight into the device-upload layout.

    frames_u8: (..., H, W) uint8 (a frame set (C, H, W), or a batch
    (B, C, H, W)).  Returns (..., max_blobs, 3) float32, slot = [x, y,
    valid]: the tensor ``track_from_blobs(packed[..., :2],
    packed[..., 2] > 0.5)`` takes.  ``out``: a caller-owned C-contiguous
    float32 buffer of that shape (a pinned host buffer, for instance).
    """
    _check_frames(frames_u8)
    if max_blobs <= 0:
        raise ValueError(f"max_blobs must be positive, got {max_blobs}")
    lead, (H, W) = frames_u8.shape[:-2], frames_u8.shape[-2:]
    n = int(np.prod(lead, dtype=np.int64)) if lead else 1
    shape = (*lead, max_blobs, 3)
    if out is None:
        out = np.empty(shape, np.float32)
    elif (out.shape != shape or out.dtype != np.float32
          or not out.flags.c_contiguous):
        # the native call writes n*max_blobs*3 floats through the pointer
        raise ValueError(
            f"out must be C-contiguous float32 of shape {shape}, got "
            f"{out.dtype} {out.shape} contiguous={out.flags.c_contiguous}")
    if cutoff > 255:        # threshold above every uint8 value: no blobs
        out[:] = 0.0
        return out
    flat = np.ascontiguousarray(frames_u8).reshape(-1)
    get_lib().lcm_ingest_detect_packed(
        _ptr(flat, ctypes.c_uint8), n, H, W, np.uint8(cutoff), max_blobs,
        int(weighted), _ptr(out, ctypes.c_float))
    return out


def extract_bits(packed: np.ndarray, max_out: int) -> tuple[np.ndarray, int]:
    """Pixel indices of all set bits in an MSB-first packed bitmap.

    Returns (idx, total_count): idx is (max_out,) int32 in raster order,
    padded with INT32_MAX past the true count (out of range, so
    ``ops.detect.scatter_pixels`` drops it); total_count may exceed
    max_out (overflow: the caller takes the dense bitmap instead).
    """
    flat = np.ascontiguousarray(packed, np.uint8).reshape(-1)
    out = np.full(max_out, np.iinfo(np.int32).max, np.int32)
    count = get_lib().lcm_extract_bits(
        _ptr(flat, ctypes.c_uint8), flat.size, _ptr(out, ctypes.c_int32),
        max_out)
    return out, int(count)
