"""Frame sources of the port: synthetic rig, simulated SIL rig, recorded
sequences, live PS3-Eye cameras (gated import).

The port's counterpart of ``low_cost_mocap_tpu/runtime/sources.py``.  The
engine reads (C, H, W) uint8 frame sets through the ``FrameSource``
interface, so the same loop serves synthetic scenes, recordings and live
hardware.  ``SyntheticSource`` also has ``read_at(t)``, which renders the
scene at a given time, so that a run is deterministic.
"""

from __future__ import annotations

import time
from typing import Protocol

import numpy as np

from low_cost_mocap_tpu_torch.config import RigConfig
from low_cost_mocap_tpu_torch.utils import synthetic as syn


class FrameSource(Protocol):
    num_cameras: int
    image_size: object  # int (square) or (H, W)

    def read(self) -> np.ndarray:
        """Returns (C, H, W) uint8 frames."""
        ...

    def set_settings(self, exposure: float, gain: float) -> None:
        ...

    def close(self) -> None:
        ...


class SyntheticSource:
    """Drones orbiting the rig centre, rendered as (C, H, W) uint8 frames.

    ``headings``: per-drone yaw; the default is the JAX source's
    ``0.1 * drone``.  The drone index the locator reports comes from the
    side of the arm axis the third LED sits on, so drones with headings
    about pi apart get distinct indices.  ``gain`` scales brightness
    (10 = unscaled), as the JAX source emulates it.
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
        self.exposure = 100.0
        self.gain = 10.0
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
        frames = np.clip(frames * (self.gain / 10.0), 0.0, 1.0)
        return (frames * 255).astype(np.uint8)

    def read(self) -> np.ndarray:
        """The frames at the wall-clock time since the source was made."""
        return self.read_at(time.monotonic() - self._t0)

    def set_settings(self, exposure: float, gain: float) -> None:
        self.exposure = exposure
        self.gain = gain

    def close(self) -> None:
        pass


class SimulatedRigSource:
    """Renders the loopback link's simulated drones — full-system SIL.

    Closes the entire loop without hardware: simulator poses -> rendered
    marker blobs -> vision pipeline -> tracked pose feed -> native cascade
    -> simulator dynamics.  The drone pose lives in the firmware frame
    (x, y, altitude); display-world coordinates are [x, alt, y] and the
    camera-frame rendering applies the inverse of ``ops.world.to_world``
    with the identity matrix.
    """

    def __init__(self, rig: RigConfig, Rs: np.ndarray, ts: np.ndarray,
                 link, sigma: float = 0.8):
        self.rig = rig
        self.num_cameras = rig.num_cameras
        self.image_size = rig.image_size
        self.Rs = Rs
        self.ts = ts
        self.link = link
        self.sigma = sigma
        self.exposure = 100.0
        self.gain = 10.0

    def _markers_cam(self) -> np.ndarray:
        out = []
        half = self.rig.marker_dist_long / 2.0
        h = float(np.sqrt(max(self.rig.marker_dist_short**2 - half**2,
                              1e-8)))
        for i in range(self.link.num_drones):
            p, v, yaw = self.link.drone_state(i)
            c, s = np.cos(yaw), np.sin(yaw)
            # firmware frame (x, y, alt): arm along heading; the third LED's
            # side encodes the drone identity (mounted mirrored on drone 1,
            # computer_code/api/helpers.py:469)
            side = h if i % 2 == 0 else -h
            local = np.array([[half, 0.0], [-half, 0.0], [0.0, side]],
                             np.float64)
            rot = np.array([[c, -s], [s, c]])
            xy = local @ rot.T + p[:2]
            markers_fw = np.column_stack([xy, np.full(3, p[2])])
            # world(display) = [x, alt, y]; cam = flip(swap(world))
            world = markers_fw[:, [0, 2, 1]]
            cam = world[:, [0, 2, 1]] * np.array([-1.0, -1.0, 1.0])
            out.append(cam)
        return (np.concatenate(out).astype(np.float32)
                if out else np.zeros((0, 3), np.float32))

    def read(self) -> np.ndarray:
        X = self._markers_cam()
        pts, mask = observe_points(X, self.Rs, self.ts, self.rig)
        frames = syn.render_frames(pts, mask, self.image_size,
                                   sigma=self.sigma)
        return (frames * 255).astype(np.uint8)

    def set_settings(self, exposure: float, gain: float) -> None:
        self.exposure = exposure
        self.gain = gain

    def close(self) -> None:
        pass


def observe_points(X, Rs, ts, rig):
    if len(X) == 0:
        return (np.zeros((0, rig.num_cameras, 2), np.float32),
                np.zeros((0, rig.num_cameras), bool))
    return syn.observe(X, Rs, ts, rig)


class RecordedSource:
    """Replays a recorded (T, C, H, W) uint8 sequence from .npz, looping."""

    def __init__(self, path: str):
        with np.load(path) as data:
            self.frames = data["frames"]
        if self.frames.ndim != 4:
            raise ValueError(f"{path}: frames must be (T, C, H, W), got "
                             f"shape {self.frames.shape}")
        self.num_cameras = self.frames.shape[1]
        h, w = self.frames.shape[2], self.frames.shape[3]
        self.image_size = h if h == w else (h, w)
        self._i = 0

    def read(self) -> np.ndarray:
        f = self.frames[self._i % len(self.frames)]
        self._i += 1
        return f

    def set_settings(self, exposure: float, gain: float) -> None:
        pass

    def close(self) -> None:
        pass


class PseyepySource:
    """Live PS3-Eye capture via pseyepy (optional dependency, gated import).

    Mirrors the reference's acquisition setup: 90 fps, RES_SMALL, gain 10,
    exposure 100 (``computer_code/api/helpers.py:24``) with per-camera
    display rotation (``helpers.py:71-73``).  The output shape is
    ``rig.image_hw()``: frames larger than it on an axis are centre-cropped,
    smaller ones centre-padded (the reference's centring,
    ``helpers.py:507-523``, generalised per axis).
    """

    def __init__(self, rig: RigConfig, fps: int = 90, gain: int = 10,
                 exposure: int = 100):
        try:
            from pseyepy import Camera  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "pseyepy is not installed; use SyntheticSource or "
                "RecordedSource") from e
        self.rig = rig
        self._cam = Camera(fps=fps, resolution=Camera.RES_SMALL, gain=gain,
                           exposure=exposure)
        self.num_cameras = rig.num_cameras
        self.image_size = rig.image_size

    def read(self) -> np.ndarray:
        frames, _ = self._cam.read()
        H, W = self.rig.image_hw()
        out = np.zeros((self.num_cameras, H, W), np.uint8)
        for i in range(self.num_cameras):
            f = np.asarray(frames[i])
            if f.ndim == 3:
                f = f.mean(axis=-1).astype(np.uint8)
            f = np.rot90(f, k=self.rig.cameras[i].rotation)
            h, w = f.shape
            if h > H:                       # centre-crop ...
                y = (h - H) // 2
                f = f[y:y + H]
                h = H
            if w > W:
                x = (w - W) // 2
                f = f[:, x:x + W]
                w = W
            y0 = (H - h) // 2               # ... and centre-pad the rest
            x0 = (W - w) // 2
            out[i, y0:y0 + h, x0:x0 + w] = f
        return out

    def set_settings(self, exposure: float, gain: float) -> None:
        n = self.num_cameras
        self._cam.exposure = [int(exposure)] * n
        self._cam.gain = [int(gain)] * n

    def close(self) -> None:
        self._cam.end()
