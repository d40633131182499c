"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface.  It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``low_cost_mocap_tpu_torch/_build/`` at first use, rebuilt whenever the
source (or the flags) change — the library's file name carries their hash —
and loaded with ``ctypes``.  Nothing is built at import: the CPU path never
needs a compiler.

Flags: ``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into fused
multiply-adds, and no ``--use_fast_math``, so each kernel performs exactly
the float32 operations its plain PyTorch version performs (the Butterworth
recurrence drifts by an ulp when multiply-adds are fused).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    the one on PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_build(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library is built;
    returns (process, temporary output) or None.  ``finish_build`` waits
    for it, so a caller can compile several kernels in parallel."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    log = open(BUILD_DIR / f"{name}.log", "w")
    try:
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(SRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp


def finish_build(name: str, pending) -> Path:
    out = library_path(name)
    if pending is not None:
        proc, tmp = pending
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu (rc={rc}):\n"
                + (BUILD_DIR / f"{name}.log").read_text())
        os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the last build of ``csrc/<name>.cu``, or '' if none is kept."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = finish_build(name, start_build(name))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def on_card(t) -> bool:
    """Whether a kernel wrapper takes the kernel for tensor ``t``: True for
    a CUDA tensor, False for a CPU tensor (the plain version); any other
    device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
