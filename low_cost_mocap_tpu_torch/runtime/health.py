"""Per-camera failure detection + elastic recovery.

The reference leaves camera dropout entirely unhandled (SURVEY.md §5:
"Camera dropout, backend crash, or RF loss beyond this are unhandled" —
a PS3 Eye whose USB pipeline stalls keeps returning its last buffer from
``pseyepy``, and the stale blobs keep feeding triangulation as if the
camera were live, silently corrupting every reconstructed point).

``CameraHealthMonitor`` watches the raw frame stream host-side and
classifies each camera every frame:

- **frozen**: the camera's frames are bit-identical for
  ``freeze_frames`` consecutive frames *while at least one other camera's
  frames are changing*.  Real sensors never produce two identical
  buffers (noise); a byte-identical run means the transport stalled.
  The "others are changing" guard keeps a globally static synthetic /
  recorded scene from tripping it.
- **dark**: the camera has reported zero blobs for ``dark_frames``
  consecutive frames while >= 2 other cameras see blobs (lens cap,
  failed IR filter, pointing away).  Advisory only — no blobs already
  means no contribution to triangulation.
- **ok**: anything else.

Recovery action for *frozen* cameras is elastic, not fatal: the engine
masks the camera (zeroes its frames before ingest, so every ingest path —
dense, 1-bit packed, sparse, host-detect, mesh-sharded — sees no blobs
from it) and tracking continues on the remaining cameras; DLT
triangulation already handles any >= 2 live views per point.  The moment
the camera's frames change again it is unmasked and rejoins the rig,
no restart, no recompile (camera count and all shapes are static — the
mask is data, not structure).

Status transitions are emitted as ``camera-health`` events
(``{"camera": c, "status": "frozen"|"dark"|"ok", "frames": n}``) so the
operator console can show a per-camera health row.

The port's own copy of ``low_cost_mocap_tpu/runtime/health.py``, with one
deliberate difference: ``interval`` < 1 raises ``ValueError`` here, where
the JAX package's monitor divides by zero on its first frame.
"""

from __future__ import annotations

import numpy as np

OK = "ok"
FROZEN = "frozen"
DARK = "dark"


class CameraHealthMonitor:
    """Classifies per-camera health from the raw frame stream.

    ``update(frames)`` is called once per frame with the (C, H, W) uint8
    stack *before* ingest; it returns a list of (camera, status) state
    transitions (empty almost always).  ``frozen_mask`` is the (C,) bool
    mask of cameras the engine should suppress this frame.

    Cost: one subsampled (stride-4) per-camera buffer compare per frame —
    a few microseconds for 4x320x320.
    """

    def __init__(self, num_cameras: int, freeze_frames: int = 15,
                 dark_frames: int = 90, stride: int = 4,
                 interval: int = 1):
        self.num_cameras = num_cameras
        self.freeze_frames = freeze_frames
        self.dark_frames = dark_frames
        self.stride = stride
        # Sample every ``interval``-th frame: freeze detection is a
        # 15-frame-scale decision, so comparing every frame is wasted
        # host time on the hot serving loop (measured ~100 us/frame of a
        # ~140 us/frame product loop at interval=1 — the engine passes 4).
        # ``_unchanged`` still counts FRAMES (increments by ``interval``),
        # so thresholds keep their meaning; detection latency quantizes
        # to ``interval`` frames.
        if interval < 1:
            raise ValueError(f"interval must be >= 1 frame, got {interval}")
        self.interval = interval
        self._tick = 0
        self._prev: np.ndarray | None = None   # (C, h, w) subsampled copy
        self._unchanged = np.zeros(num_cameras, np.int64)
        self._no_blobs = np.zeros(num_cameras, np.int64)
        self.status = [OK] * num_cameras

    @property
    def frozen_mask(self) -> np.ndarray:
        return np.asarray([s == FROZEN for s in self.status])

    def update(self, frames: np.ndarray) -> list[tuple[int, str]]:
        """Feed one (C, H, W) frame stack; returns status transitions."""
        self._tick += 1
        if self._tick % self.interval:
            return []
        # strided VIEW for the compare (no materialization); ONE copy to
        # keep as prev — array_equal walks the view directly
        sub = frames[:, ::self.stride, ::self.stride]
        if self._prev is None or self._prev.shape != sub.shape:
            self._prev = np.array(sub)
            return []
        changed = np.asarray([
            not np.array_equal(sub[c], self._prev[c])
            for c in range(self.num_cameras)])
        self._prev = np.array(sub)
        self._unchanged = np.where(changed, 0,
                                   self._unchanged + self.interval)

        transitions: list[tuple[int, str]] = []
        any_live_motion = bool(changed.any())
        for c in range(self.num_cameras):
            if self.status[c] == FROZEN:
                if changed[c]:
                    self.status[c] = OK
                    transitions.append((c, OK))
            elif (self._unchanged[c] >= self.freeze_frames
                  and any_live_motion):
                self.status[c] = FROZEN
                transitions.append((c, FROZEN))
        return transitions

    def update_blobs(self, blob_counts: np.ndarray) -> list[tuple[int, str]]:
        """Feed per-camera detected-blob counts (advisory *dark* status).

        Called with the (C,) count of valid blobs per camera once the
        frame's detections are known (host-detect: immediately; device
        paths: when the readback arrives — a few frames of lag is fine at
        this timescale).
        """
        counts = np.asarray(blob_counts)
        # a FROZEN camera's blobs are masked by the engine, so its zero
        # counts say nothing — keep its dark counter at 0 or the camera
        # would be flagged DARK the moment it recovers from FROZEN
        frozen = np.asarray([s == FROZEN for s in self.status])
        self._no_blobs = np.where((counts > 0) | frozen, 0,
                                  self._no_blobs + 1)
        seeing = int((counts > 0).sum())
        transitions: list[tuple[int, str]] = []
        for c in range(self.num_cameras):
            if self.status[c] == DARK:
                if counts[c] > 0:
                    self.status[c] = OK
                    transitions.append((c, OK))
            elif (self.status[c] == OK
                  and self._no_blobs[c] >= self.dark_frames and seeing >= 2):
                self.status[c] = DARK
                transitions.append((c, DARK))
        return transitions
