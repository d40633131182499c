"""Typed configuration for the rig and the engine.

The port's own copy of ``CameraIntrinsics``, ``RigConfig`` and
``EngineConfig``, with the fields and defaults of the JAX package's
``config.py``, so that one configuration means the same thing to both.
Fixed-shape budgets (``max_blobs``, ``max_candidates_per_cam``) keep every
tensor of the tracking step at a static shape.  ``save_config`` /
``load_config`` write and read both as one JSON file.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole + 5-term (k1, k2, p1, p2, k3) distortion intrinsics of one
    camera, plus a display rotation in multiples of 90 degrees."""

    intrinsic_matrix: tuple  # 3x3 nested tuple
    distortion_coef: tuple   # length-5
    rotation: int = 0

    def K(self) -> np.ndarray:
        return np.asarray(self.intrinsic_matrix, dtype=np.float32)

    def dist(self) -> np.ndarray:
        return np.asarray(self.distortion_coef, dtype=np.float32)


def _normalize_image_size(image_size):
    """int -> square; (H, W) sequence -> tuple."""
    if isinstance(image_size, (int, np.integer)):
        return int(image_size)
    h, w = image_size
    return (int(h), int(w))


def image_hw(image_size) -> tuple:
    """(H, W) of an ``image_size`` (an int means a square frame)."""
    s = _normalize_image_size(image_size)
    return (s, s) if isinstance(s, int) else s


def _default_intrinsics(num_cameras: int, image_size) -> tuple:
    h, w = image_hw(image_size)
    f = float(max(h, w)) * 0.85
    K = ((f, 0.0, w / 2.0), (0.0, f, h / 2.0), (0.0, 0.0, 1.0))
    return tuple(
        CameraIntrinsics(intrinsic_matrix=K, distortion_coef=(0.0,) * 5)
        for _ in range(num_cameras)
    )


@dataclasses.dataclass(frozen=True)
class RigConfig:
    """Physical rig: cameras, drone marker geometry, world scale."""

    num_cameras: int = 4
    image_size: Any = 320            # int | (H, W)
    cameras: tuple = ()              # tuple[CameraIntrinsics]
    marker_dist_short: float = 0.095   # LED#3 to each arm LED
    marker_dist_long: float = 0.15     # arm LED to arm LED
    marker_dist_tol: float = 0.025
    marker_side_min: float = 0.02      # third-LED off-axis floor (ops/rigid.py)
    wand_length: float = 0.15
    num_objects: int = 2               # tracked drones
    body_markers: tuple = ()           # ((x, y, z), ...); () = disabled
    max_bodies: int = 2
    body_sets: tuple = ()              # (((xyz, ...), max_instances), ...)

    def __post_init__(self):
        object.__setattr__(
            self, "image_size", _normalize_image_size(self.image_size))
        if not self.cameras:
            object.__setattr__(
                self, "cameras",
                _default_intrinsics(self.num_cameras, self.image_size))
        if len(self.cameras) != self.num_cameras:
            raise ValueError(
                f"{len(self.cameras)} intrinsics for {self.num_cameras} cameras")

    def image_hw(self) -> tuple:
        """(H, W) frame shape — square configs return (s, s)."""
        return image_hw(self.image_size)

    def body_template(self):
        """``rigid_general.BodyTemplate`` for ``body_markers``, or None."""
        if not self.body_markers:
            return None
        from low_cost_mocap_tpu_torch.ops.rigid_general import make_template

        return make_template(np.asarray(self.body_markers, np.float32))

    def body_sets_resolved(self) -> tuple:
        """All configured body templates as ((BodyTemplate, max_inst), ...):
        ``body_markers``/``max_bodies`` (when set) first, then every
        ``body_sets`` entry; ``()`` when none is configured."""
        from low_cost_mocap_tpu_torch.ops.rigid_general import make_template

        sets = []
        if self.body_markers:
            sets.append((self.body_template(), int(self.max_bodies)))
        for markers, max_inst in self.body_sets:
            sets.append((make_template(np.asarray(markers, np.float32)),
                         int(max_inst)))
        return tuple(sets)

    def total_body_slots(self) -> int:
        """Sum of max_instances across all configured body sets."""
        return sum(mi for _, mi in self.body_sets_resolved())

    def K_stack(self) -> np.ndarray:
        """(C, 3, 3) stacked intrinsic matrices."""
        return np.stack([c.K() for c in self.cameras])

    def dist_stack(self) -> np.ndarray:
        """(C, 5) stacked distortion coefficients."""
        return np.stack([c.dist() for c in self.cameras])


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs and static shape budgets (defaults of the JAX package)."""

    # detection
    detect_threshold: float = 0.2
    max_blobs: int = 8              # fixed K blob slots per camera
    cc_iters: int = 24              # label-propagation sweeps
    weighted_centroids: bool = False

    # correspondence
    epipolar_gate_px: float = 5.0
    max_candidates_per_cam: int = 2

    # calibration
    ransac_iters: int = 512
    ransac_threshold_px: float = 1.0
    ba_max_iters: int = 64
    ba_ftol: float = 1e-2
    ba_loss: str = "cauchy"

    # tracking
    kalman_process_noise: float = 1e-2
    kalman_measurement_noise: float = 1.0
    kalman_report: str = "pre"
    lpf_cutoff_hz: float = 20.0
    lpf_sample_hz: float = 60.0
    lpf_order: int = 5

    # ingest
    sparse_budget: int = 2048

    # camera health
    health_enabled: bool = True
    health_freeze_frames: int = 15
    health_dark_frames: int = 90
    health_interval: int = 4

    # serving
    dispatch_batch: int = 1
    target_fps: float = 150.0
    serial_baud: int = 1_000_000
    readback_pipeline_depth: int = 0
    batch_emit_thread: bool = False

    # numerics
    dtype: str = "float32"


def save_config(path: str, rig: RigConfig, engine: EngineConfig) -> None:
    blob: dict[str, Any] = {
        "version": 1,
        "rig": dataclasses.asdict(rig),
        "engine": dataclasses.asdict(engine),
    }
    with open(path, "w") as f:
        json.dump(blob, f, indent=2)


def load_config(path: str) -> tuple[RigConfig, EngineConfig]:
    with open(path) as f:
        blob = json.load(f)
    rig_d = blob["rig"]
    cams = tuple(
        CameraIntrinsics(
            intrinsic_matrix=tuple(tuple(r) for r in c["intrinsic_matrix"]),
            distortion_coef=tuple(c["distortion_coef"]),
            rotation=c.get("rotation", 0),
        )
        for c in rig_d.pop("cameras")
    )
    if "body_markers" in rig_d:
        rig_d["body_markers"] = tuple(
            tuple(m) for m in rig_d["body_markers"])
    if "body_sets" in rig_d:
        rig_d["body_sets"] = tuple(
            (tuple(tuple(m) for m in markers), int(max_inst))
            for markers, max_inst in rig_d["body_sets"])
    rig = RigConfig(cameras=cams, **rig_d)
    engine = EngineConfig(**blob["engine"])
    return rig, engine
