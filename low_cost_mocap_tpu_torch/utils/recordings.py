"""Recording artifacts: save/replay multi-camera frame sequences.

The port's copy of ``low_cost_mocap_tpu/utils/recordings.py``.
Recordings are .npz bundles of (T, C, H, W) uint8 frames, replayed by
``runtime.sources.RecordedSource``; the engine writes them for its
``record-frames`` event.
"""

from __future__ import annotations

import json

import numpy as np


def save_recording(path: str, frames: np.ndarray, *, fps: float = 60.0,
                   meta: dict | None = None,
                   truth_tracks: np.ndarray | None = None) -> None:
    """frames: (T, C, H, W) uint8; optional ground-truth (T, O, 3) tracks."""
    if frames.ndim != 4 or frames.dtype != np.uint8:
        raise ValueError(f"frames must be (T, C, H, W) uint8, got "
                         f"{frames.shape} {frames.dtype}")
    blobs = {"frames": frames, "fps": np.float64(fps),
             "meta": np.bytes_(json.dumps(meta or {}))}
    if truth_tracks is not None:
        blobs["truth_tracks"] = truth_tracks.astype(np.float32)
    np.savez_compressed(path, **blobs)


def load_recording(path: str):
    """Returns (frames, fps, meta, truth_tracks|None)."""
    with np.load(path) as data:
        meta = (json.loads(bytes(data["meta"]).decode())
                if "meta" in data else {})
        truth = data["truth_tracks"] if "truth_tracks" in data else None
        return data["frames"], float(data["fps"]), meta, truth


def record_synthetic(path: str, *, num_cameras: int = 4, T: int = 120,
                     fps: float = 60.0, num_drones: int = 1,
                     image_size=320, seed: int = 0) -> None:
    """Render a synthetic drone recording with ground-truth tracks."""
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = syn.ring_rig(num_cameras=num_cameras,
                               image_size=image_size)
    frames = np.zeros((T, num_cameras, *rig.image_hw()), np.uint8)
    truth = np.zeros((T, num_drones, 3), np.float32)
    for t in range(T):
        markers = []
        for d in range(num_drones):
            phase = 2 * np.pi * (0.3 * t / fps + d / max(num_drones, 1))
            pos = np.array([0.35 * np.cos(phase), 0.35 * np.sin(phase),
                            0.6 + 0.05 * np.sin(0.5 * phase)], np.float32)
            truth[t, d] = pos
            markers.append(syn.drone_markers(pos, 0.0, rig))
        X = np.concatenate(markers)
        pts, mask = syn.observe(X, Rs, ts, rig)
        frames[t] = (syn.render_frames(pts, mask, image_size, sigma=0.8)
                     * 255).astype(np.uint8)
    save_recording(path, frames, fps=fps,
                   meta={"num_cameras": num_cameras,
                         "camera_Rs": np.asarray(Rs).tolist(),
                         "camera_ts": np.asarray(ts).tolist(),
                         "num_drones": num_drones, "seed": seed},
                   truth_tracks=truth)
