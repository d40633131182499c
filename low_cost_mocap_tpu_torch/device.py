"""Device selection for the port's entry points.

Entry points run on the GPU by default.  Without CUDA they raise instead
of dropping to the CPU quietly: a CPU run is only ever one that the caller
asked for (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without
    CUDA); ``"cpu"`` -> the CPU; any other ``torch.device`` is checked the
    same way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
