"""The plain reference of the tracking paths: frames -> blobs -> points ->
located drones -> Kalman/low-pass tracks (and, offline, RTS-smoothed
tracks).

Detection is ``detect.find_blobs`` (numpy and scipy); the geometry, the
tracker and the smoother are the frozen copies under ``frozen/``, run op
by op on the device given, with the frame-independent geometry batched over
the distinct frame sets.  Nothing here imports the program, and nothing the
program made is taken: the camera matrices, the fundamentals and every
tracker state are worked out again from the rig and the poses.

``lower=True`` is the control: the same computation with every floating
value that passes between stages (blobs, camera matrices, points, located
drones and the tracker state after every step) held in bfloat16, the next
precision below the float32 that the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from . import detect
from .frozen import camera, correspond, kalman, rigid, tree, world


def _q(x, lower: bool):
    """``x`` held in bfloat16 when ``lower`` (floating tensors only)."""
    if not lower or not torch.is_tensor(x) or not x.is_floating_point():
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def _qt(t, lower: bool):
    return tree.tree_map(lambda x: _q(x, lower), t)


class Rig:
    """The calibration the reference works from: intrinsics, distortion,
    poses and the world matrix (numpy), and the geometry options."""

    def __init__(self, K, dist, Rs, ts, world_matrix, opts: dict):
        self.K = np.asarray(K, np.float32)
        self.dist = np.asarray(dist, np.float32)
        self.Rs = np.asarray(Rs, np.float32)
        self.ts = np.asarray(ts, np.float32)
        self.M = np.asarray(world_matrix, np.float32)
        self.opts = dict(opts)

    @classmethod
    def of(cls, rig, ecfg, Rs, ts):
        """From a rig and an engine configuration (the program's config
        classes, plain data) and the camera poses; the world matrix the
        identity, as the cells serve."""
        return cls(rig.K_stack(), rig.dist_stack(), Rs, ts, np.eye(4),
                   dict(gate_px=ecfg.epipolar_gate_px,
                        max_candidates=ecfg.max_candidates_per_cam,
                        marker_dist1=rig.marker_dist_short,
                        marker_dist2=rig.marker_dist_long,
                        marker_tol=rig.marker_dist_tol,
                        marker_side_min=rig.marker_side_min))

    def tensors(self, device, lower: bool):
        K = _q(torch.as_tensor(self.K, device=device), lower)
        dist = torch.as_tensor(self.dist, device=device)
        Rs = torch.as_tensor(self.Rs, device=device)
        ts = torch.as_tensor(self.ts, device=device)
        Ps = _q(camera.projection_matrix(K, Rs, ts), lower)
        M = torch.as_tensor(self.M, device=device)
        Fs = _q(correspond._pairwise_fundamentals(Ps), lower)
        return Ps, K, dist, M, Fs


def locate(blobs, valid, rig: Rig, device, lower: bool = False,
           chunk: int = 64):
    """Frame-independent geometry of (T, C, K, 2) blobs: undistort ->
    epipolar match -> DLT -> world -> drone triples, ``chunk`` frame sets at
    a time.  Returns a dict of (T, ...) tensors on ``device``: blob_px,
    blob_valid, points, point_valid, point_errors and the LocatedObjects
    (pos, heading, error, index, valid)."""
    Ps, K, dist, M, Fs = rig.tensors(device, lower)
    o = rig.opts
    parts = []
    for lo in range(0, len(blobs), chunk):
        b = _q(torch.as_tensor(blobs[lo:lo + chunk], device=device), lower)
        v = torch.as_tensor(valid[lo:lo + chunk], device=device)
        bu = camera.undistort_points(b, K[:, None], dist[:, None])
        bu = _q(torch.where(v[..., None], bu, 0.0), lower)
        m = correspond.match_points(bu, v, Ps, gate_px=o["gate_px"],
                                    max_candidates=o["max_candidates"],
                                    Fs=Fs)
        pts = world.to_world(m["object_points"], M)
        pts = _q(torch.where(m["valid"][..., None], pts, 0.0), lower)
        errs = _q(m["errors"], lower)
        loc = rigid.locate_objects(
            pts, errs, m["valid"], dist1=o["marker_dist1"],
            dist2=o["marker_dist2"], tol=o["marker_tol"],
            side_min=o["marker_side_min"], ax_h1=0, ax_h2=2)
        loc = _qt(loc, lower)
        parts.append(dict(blob_px=bu, blob_valid=v, points=pts,
                          point_valid=m["valid"], point_errors=errs,
                          pos=loc.pos, heading=loc.heading, error=loc.error,
                          index=loc.index, valid=loc.valid))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def detect_frames(frames_u8, threshold: float, max_blobs: int):
    """Blobs of (T, C, H, W) uint8 frame sets, 64 frame sets at a time."""
    out_b, out_v = [], []
    for lo in range(0, len(frames_u8), 64):
        b, v = detect.find_blobs(frames_u8[lo:lo + 64], threshold, max_blobs)
        out_b.append(b)
        out_v.append(v)
    return np.concatenate(out_b), np.concatenate(out_v)


def _take(loc: dict, k):
    return (loc["pos"][k], loc["heading"][k], loc["index"][k],
            loc["valid"][k])


def track(loc: dict, order, dts, num_objects: int, device,
          lower: bool = False):
    """The Kalman bank (report "pre", the serving options) frame by frame
    over the located drones of frame sets ``order`` (indices into
    ``loc``), from a fresh bank.  Returns TrackedObjects of (n, O, ...)
    tensors."""
    state = kalman.init_state(num_objects, device=device)
    outs = []
    for n, k in enumerate(order):
        state, tr = kalman.update(state, *_take(loc, int(k)), dts[n])
        state = _qt(state, lower)
        outs.append(_qt(tr, lower))
    return tree.stack(outs)


def smooth(loc: dict, dts, num_objects: int, process_noise: float,
           meas_noise: float, device, lower: bool = False):
    """The RTS-smoothed tracks of a recording (the smoother's forward
    filter and backward pass, op by op), from a fresh bank."""
    state = kalman.init_state(num_objects, device=device)
    if not lower:
        smoothed, _ = kalman.smooth_sequence(
            state, loc["pos"], loc["heading"], loc["index"], loc["valid"],
            dts, process_noise=process_noise, meas_noise=meas_noise)
        return smoothed

    def step(st, *x):
        st, out = kalman._forward_step(st, *x, process_noise=process_noise,
                                       meas_noise=meas_noise)
        return _qt(st, True), _qt(out, True)

    _, ((tracked, xs, Ps), inited) = tree.scan(
        step, state, loc["pos"], loc["heading"], loc["index"], loc["valid"],
        dts)
    xs_s, _ = kalman.rts_smooth(xs, Ps, dts, process_noise=process_noise)
    xs_s = _q(xs_s, True)
    return kalman.TrackedObjects(
        pos=torch.where(inited[..., None], xs_s[..., :3], 0.0),
        vel=torch.where(inited[..., None], xs_s[..., 3:6], 0.0),
        heading=tracked.heading, valid=inited)
