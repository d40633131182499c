"""Frame sources of the port.

``SyntheticSource`` renders moving drones through a known rig, like the
JAX package's (``low_cost_mocap_tpu/runtime/sources.py``).  Beside the
wall-clock ``read()`` it has ``read_at(t)``, which renders the scene at a
given time, so that a run is deterministic.
"""

from __future__ import annotations

import time

import numpy as np

from low_cost_mocap_tpu_torch.config import RigConfig
from low_cost_mocap_tpu_torch.utils import synthetic as syn


class SyntheticSource:
    """Drones orbiting the rig centre, rendered as (C, H, W) uint8 frames.

    ``headings``: per-drone yaw; the default is the JAX source's
    ``0.1 * drone``.  The drone index the locator reports comes from the
    side of the arm axis the third LED sits on, so drones with headings
    about pi apart get distinct indices.
    """

    def __init__(self, rig: RigConfig, Rs: np.ndarray, ts: np.ndarray,
                 num_drones: int = 1, orbit_radius: float = 0.35,
                 orbit_hz: float = 0.25, sigma: float = 0.8,
                 headings=None):
        self.rig = rig
        self.num_cameras = rig.num_cameras
        self.image_size = rig.image_size
        self.Rs = Rs
        self.ts = ts
        self.num_drones = num_drones
        self.orbit_radius = orbit_radius
        self.orbit_hz = orbit_hz
        self.sigma = sigma
        self.headings = (tuple(0.1 * d for d in range(num_drones))
                         if headings is None else tuple(headings))
        self._t0 = time.monotonic()

    def drone_pose(self, drone: int, t: float):
        """(position (3,), heading) of a drone at time ``t`` seconds."""
        phase = 2 * np.pi * (self.orbit_hz * t
                             + drone / max(self.num_drones, 1))
        pos = np.array([
            self.orbit_radius * np.cos(phase),
            self.orbit_radius * np.sin(phase),
            0.6 + 0.1 * np.sin(0.5 * phase),
        ], np.float32)
        return pos, self.headings[drone]

    def read_at(self, t: float) -> np.ndarray:
        """The (C, H, W) uint8 frames of the scene at time ``t``."""
        markers = [syn.drone_markers(*self.drone_pose(d, t), self.rig)
                   for d in range(self.num_drones)]
        X = (np.concatenate(markers) if markers
             else np.zeros((0, 3), np.float32))
        pts, mask = syn.observe(X, self.Rs, self.ts, self.rig)
        frames = syn.render_frames(pts, mask, self.image_size,
                                   sigma=self.sigma)
        return (frames * 255).astype(np.uint8)

    def read(self) -> np.ndarray:
        """The frames at the wall-clock time since the source was made."""
        return self.read_at(time.monotonic() - self._t0)
