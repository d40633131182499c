"""The serving engine of the port, built around ``process_frame``.

A slim counterpart of ``low_cost_mocap_tpu/runtime/engine.py``: the mode
flags (capture / triangulate / locate) and the handlers that set them,
camera poses and the world matrix as engine state, and per frame

    host threshold + 1-bit pack -> ``frame_step`` on the device (detection
    kernel, geometry, bank kernel) -> one packed row -> host decode ->
    ``object-points`` event

with the JAX engine's ``object-points`` payload.  Detection runs on the
device: the JAX engine's host detector is native code of that package, so
batched dispatch (``dispatch_batch > 1``), which needs it, raises here as
it does there without host detection.  Health monitoring, calibration
capture and handlers (``image-points``), trajectories, the drone command
link and the server binding are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from low_cost_mocap_tpu_torch.config import EngineConfig, RigConfig
from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.models.pipeline import (frame_step,
                                                      pack_outputs,
                                                      unpack_outputs)
from low_cost_mocap_tpu_torch.ops import camera as cam_ops
from low_cost_mocap_tpu_torch.ops import correspond, kalman
from low_cost_mocap_tpu_torch.ops.detect import pack_frames


class Engine:
    def __init__(self, rig: RigConfig, cfg: EngineConfig, device=None):
        """``device``: where the tracking step runs — CUDA by default (raises
        without it); ``"cpu"`` runs the plain PyTorch versions of the
        kernels."""
        rig.body_sets_resolved()   # raises for rigid-body templates
        if cfg.dispatch_batch > 1:
            raise ValueError(
                "dispatch_batch > 1 requires the host-detect ingest path "
                "(native detector + fast path) or mesh mode: the batched "
                "program runs pre-detected (or per-shard-detected) blobs "
                "through scan_track_from_blobs")
        self.rig = rig
        self.cfg = cfg
        self.device = resolve_device(device)
        self.is_capturing_points = False
        self.is_triangulating_points = False
        self.is_locating_objects = False
        self.camera_poses: tuple[np.ndarray, np.ndarray] | None = None
        self._listeners: dict[str, list[Callable[[Any], None]]] = {}

        dev = self.device
        self._K = torch.as_tensor(rig.K_stack(), device=dev)
        self._dist = torch.as_tensor(rig.dist_stack(), device=dev)
        self._Ps = torch.eye(3, 4, device=dev).repeat(rig.num_cameras, 1, 1)
        self._F = correspond._pairwise_fundamentals(self._Ps)
        self.set_to_world_matrix(np.eye(4, dtype=np.float32))
        self._kalman_state = kalman.init_state(rig.num_objects, device=dev)
        self._step_kw = dict(
            threshold=cfg.detect_threshold, max_blobs=cfg.max_blobs,
            cc_iters=cfg.cc_iters, gate_px=cfg.epipolar_gate_px,
            max_candidates=cfg.max_candidates_per_cam,
            marker_dist1=rig.marker_dist_short,
            marker_dist2=rig.marker_dist_long,
            marker_tol=rig.marker_dist_tol,
            marker_side_min=rig.marker_side_min,
            do_preprocess=False, packed_input=True,
            kalman_report=cfg.kalman_report)

    # ------------------------------------------------------------ events

    def on(self, event: str, cb: Callable[[Any], None]) -> None:
        self._listeners.setdefault(event, []).append(cb)

    def emit(self, event: str, data: Any) -> None:
        for cb in tuple(self._listeners.get(event, ())):
            cb(data)

    def handle(self, event: str, data: Any) -> None:
        fn = getattr(self, "handle_" + event.replace("-", "_"), None)
        if fn is None:
            raise KeyError(f"unknown event {event!r}")
        fn(data if data is not None else {})

    def handle_locate_objects(self, data):
        self.is_locating_objects = data["startOrStop"] == "start"

    def handle_triangulate_points(self, data):
        if data["startOrStop"] == "start":
            Rs, ts = serializable_to_camera_poses(data["cameraPoses"])
            self.set_camera_poses(Rs, ts)
            if data.get("toWorldCoordsMatrix") is not None:
                self.set_to_world_matrix(
                    np.asarray(data["toWorldCoordsMatrix"], np.float32))
            self._kalman_state = kalman.init_state(self.rig.num_objects,
                                                   device=self.device)
            self.is_capturing_points = True
            self.is_triangulating_points = True
        else:
            self.is_capturing_points = False
            self.is_triangulating_points = False

    # ------------------------------------------------------------- state

    def set_camera_poses(self, Rs: np.ndarray, ts: np.ndarray) -> None:
        self.camera_poses = (Rs, ts)
        self._Ps = cam_ops.projection_matrix(
            self._K, torch.as_tensor(np.asarray(Rs, np.float32),
                                     device=self.device),
            torch.as_tensor(np.asarray(ts, np.float32), device=self.device))
        # the pairwise fundamentals change only with the calibration
        self._F = correspond._pairwise_fundamentals(self._Ps)

    def set_to_world_matrix(self, M: np.ndarray) -> None:
        self.to_world_matrix = np.asarray(M, np.float32)
        self._M = torch.as_tensor(self.to_world_matrix, device=self.device)

    # -------------------------------------------------------------- frames

    def process_frame(self, frames: np.ndarray, dt: float):
        """One frame set — (C, H, W) uint8 — through the tracking step and
        the reference-shaped emits.  Returns the decoded FrameOutputs (numpy
        leaves), or None while not capturing."""
        if not self.is_capturing_points:
            return None
        packed = torch.from_numpy(
            pack_frames(frames, self.cfg.detect_threshold)).to(self.device)
        self._kalman_state, out = frame_step(
            self._kalman_state, packed, np.float32(dt), self._Ps, self._K,
            self._dist, self._M, self._F, **self._step_kw)
        row = pack_outputs(out).cpu().numpy()   # one device->host transfer
        out = unpack_outputs(row, self.rig.num_cameras, self.cfg.max_blobs,
                             self.rig.num_objects)
        self._emit_frame_outputs(out)
        return out

    def _emit_frame_outputs(self, out) -> None:
        """The reference's ``object-points`` emit while triangulating."""
        if not (self.is_triangulating_points
                and self._listeners.get("object-points")):
            return
        objects, filtered = [], []
        if self.is_locating_objects:
            o = out.objects
            for i in np.where(o.valid)[0]:
                objects.append({
                    "pos": o.pos[i].tolist(),
                    "heading": float(o.heading[i]),
                    "error": float(o.error[i]),
                    "droneIndex": int(o.index[i]),
                })
            tr = out.tracked
            for d in np.where(tr.valid)[0]:
                filtered.append({
                    "pos": tr.pos[d].tolist(),
                    "vel": tr.vel[d].tolist(),
                    "heading": float(tr.heading[d]),
                    "droneIndex": int(d),
                })
        pv = out.point_valid
        self.emit("object-points", {
            "object_points": out.object_points[pv].tolist(),
            "errors": out.point_errors[pv].tolist(),
            "objects": objects,
            "filtered_objects": filtered,
        })


def serializable_to_camera_poses(poses):
    """Reference wire shape [{"R": 3x3, "t": 3}, ...] -> (Rs, ts)."""
    Rs = np.asarray([p["R"] for p in poses], np.float32)
    ts = np.asarray([np.asarray(p["t"], np.float32).reshape(-1)
                     for p in poses], np.float32)
    return Rs, ts
