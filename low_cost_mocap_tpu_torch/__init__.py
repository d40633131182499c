"""low_cost_mocap_tpu_torch — the mocap engine on PyTorch and CUDA.

A port of ``low_cost_mocap_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU.  The module layout mirrors the JAX package, so every function
has its counterpart at the same path.  The two Pallas kernels of the live
tracking step are hand-written CUDA C++ kernels here
(``csrc/kalman_bank.cu``, ``csrc/detect_blobs.cu``), each beside a plain
PyTorch version of the same function that the CPU path runs.

This package imports neither ``jax`` nor ``low_cost_mocap_tpu``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.

Float32 matrix products are pinned to full float32 at import: the JAX
path pins HIGH/HIGHEST precision on its geometry contractions, and a
reduced-precision product (TF32 here, bf16 passes on the TPU) costs about
a millimetre of marker accuracy.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from low_cost_mocap_tpu_torch.config import (CameraIntrinsics,  # noqa: E402
                                             EngineConfig, RigConfig)
from low_cost_mocap_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["CameraIntrinsics", "EngineConfig", "RigConfig", "resolve_device"]
