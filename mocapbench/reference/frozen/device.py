"""Device selection of the frozen copies: the device asked for, as given."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; otherwise ``device``."""
    return torch.device("cuda" if device is None else device)
