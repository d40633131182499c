"""Carry state and calibration across from the JAX package's arrays.

The JAX package's tracker state and calibration are numpy-convertible
arrays; these helpers turn them into the port's tensors on a device, so a
rig calibrated or a track started by one package continues in the other —
and so tests can feed both packages identical inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.ops.kalman import KalmanState


class Calibration(NamedTuple):
    """Rig calibration as the pipeline's tensors."""

    K: torch.Tensor          # (C, 3, 3) intrinsics
    dist: torch.Tensor       # (C, 5) distortion
    Ps: torch.Tensor         # (C, 3, 4) projection matrices
    Fs: torch.Tensor         # (C, C, 3, 3) pairwise fundamentals
    to_world: torch.Tensor   # (4, 4)


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def kalman_state_from_numpy(x, P, initialized, prev_pos, lpf_heading,
                            lpf_vel, age, device=None) -> KalmanState:
    """A KalmanState from the leaves of the JAX package's ``KalmanState``
    (in field order, as numpy arrays)."""
    dev = resolve_device(device)
    return KalmanState(
        x=_f32(x, dev), P=_f32(P, dev),
        initialized=torch.tensor(np.asarray(initialized, bool), device=dev),
        prev_pos=_f32(prev_pos, dev), lpf_heading=_f32(lpf_heading, dev),
        lpf_vel=_f32(lpf_vel, dev), age=_f32(age, dev))


def calibration_from_numpy(K, dist, Ps, Fs, to_world,
                           device=None) -> Calibration:
    """The JAX package's calibration arrays as the port's tensors."""
    dev = resolve_device(device)
    return Calibration(K=_f32(K, dev), dist=_f32(dist, dev), Ps=_f32(Ps, dev),
                       Fs=_f32(Fs, dev), to_world=_f32(to_world, dev))
