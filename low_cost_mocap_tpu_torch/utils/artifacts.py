"""Versioned calibration artifacts: save/load full rig calibration state.

The reference persists only intrinsics (``computer_code/api/camera-params.json``,
loaded at ``computer_code/api/helpers.py:19-22``); extrinsics and the world
matrix live as *frontend state* with hardcoded defaults
(``computer_code/src/App.tsx:44-45``) — "resume" means the operator pasting
JSON into a form (SURVEY.md §5).  Here the complete calibration (intrinsics,
extrinsics, world transform, scale provenance) is a versioned server-side
artifact.

The port's own copy of ``low_cost_mocap_tpu/utils/artifacts.py``: the same
file format, so either package resumes the other's calibration.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

FORMAT_VERSION = 1


@dataclasses.dataclass
class Calibration:
    Rs: np.ndarray                 # (C, 3, 3)
    ts: np.ndarray                 # (C, 3)
    focals: np.ndarray | None      # (C,) BA-refined, optional
    to_world_matrix: np.ndarray    # (4, 4)
    mean_reprojection_error: float | None = None
    scale_applied: bool = False
    created_at: float = 0.0

    def to_dict(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "created_at": self.created_at or time.time(),
            "camera_poses": [
                {"R": R.tolist(), "t": t.tolist()}
                for R, t in zip(np.asarray(self.Rs), np.asarray(self.ts))
            ],
            "focals": None if self.focals is None
                      else np.asarray(self.focals).tolist(),
            "to_world_matrix": np.asarray(self.to_world_matrix).tolist(),
            "mean_reprojection_error": self.mean_reprojection_error,
            "scale_applied": self.scale_applied,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        if d.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported format {d.get('format_version')}")
        Rs = np.asarray([p["R"] for p in d["camera_poses"]], np.float32)
        ts = np.asarray([p["t"] for p in d["camera_poses"]], np.float32)
        return cls(
            Rs=Rs, ts=ts,
            focals=None if d["focals"] is None
                   else np.asarray(d["focals"], np.float32),
            to_world_matrix=np.asarray(d["to_world_matrix"], np.float32),
            mean_reprojection_error=d.get("mean_reprojection_error"),
            scale_applied=bool(d.get("scale_applied", False)),
            created_at=float(d.get("created_at", 0.0)),
        )


def save_calibration(path: str, calib: Calibration) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(calib.to_dict(), f, indent=2)
    os.replace(tmp, path)  # atomic


def load_calibration(path: str) -> Calibration:
    with open(path) as f:
        return Calibration.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Intrinsics artifact
# ---------------------------------------------------------------------------
#
# The reference ships intrinsics as a hand-made ``camera-params.json`` it
# cannot produce (loaded at ``computer_code/api/helpers.py:19-22``; the
# README points at an external calibration tool).  Here the in-framework
# Zhang calibration (``ops/intrinsics.py``, ``calibrate-intrinsics`` event)
# writes this artifact, and the engine reloads it on startup.


def save_intrinsics(path: str, cameras) -> None:
    """Persist per-camera intrinsics (a tuple of ``config.CameraIntrinsics``,
    e.g. ``RigConfig.cameras``) as a versioned JSON artifact."""
    blob = {
        "format_version": FORMAT_VERSION,
        "created_at": time.time(),
        "cameras": [
            {
                "intrinsic_matrix": np.asarray(
                    c.intrinsic_matrix, np.float64).tolist(),
                "distortion_coef": np.asarray(
                    c.distortion_coef, np.float64).tolist(),
                "rotation": int(c.rotation),
            }
            for c in cameras
        ],
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=2)
    os.replace(tmp, path)


def load_intrinsics(path: str):
    """Inverse of ``save_intrinsics``: tuple of ``CameraIntrinsics``."""
    from low_cost_mocap_tpu_torch.config import CameraIntrinsics

    with open(path) as f:
        blob = json.load(f)
    if blob.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported format {blob.get('format_version')}")
    return tuple(
        CameraIntrinsics(
            intrinsic_matrix=tuple(tuple(r) for r in c["intrinsic_matrix"]),
            distortion_coef=tuple(c["distortion_coef"]),
            rotation=int(c.get("rotation", 0)),
        )
        for c in blob["cameras"]
    )
