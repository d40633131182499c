"""The live tracking step: frames -> blobs -> tracked drone and body poses.

Counterpart of ``low_cost_mocap_tpu/models/pipeline.py``:

    frames -> [blur + sharpen] -> blobs -> undistort -> epipolar match ->
    DLT triangulate -> world transform -> rigid-body fit -> Kalman bank ->
    [6-DoF body fits + body tracker] -> one packed row

Detection runs the ``detect_blobs`` kernel and the bank the
``kalman_bank`` kernel for CUDA tensors (their plain PyTorch versions for
CPU tensors).  The frame-independent geometry takes an explicit leading
batch axis, so per-frame tracking (``track_from_blobs``, B = 1) and batched
serving (``scan_track_from_blobs``) run the same code and the same bank
kernel.

``MocapPipeline`` holds a rig's calibration on one device and steps
frames; ``batched_track_from_blobs`` serves R rigs in one call, rig by
rig (the bank kernel launches once per rig).

Frames come in dense (uint8 or float), as 1-bit packed rows, or as the
lit pixels' indices (sparse ingest, ``ops.detect.sparse_ingest``).
``do_preprocess`` blurs and sharpens dense frames before detection.
``with_obs`` adds the matcher's per-camera observations of every point to
the outputs (and to the packed row), which live recalibration collects.

``body_sets`` (((BodyTemplate, max_instances), ...)) tracks rigid-body
templates after the bank: each set is fit over the points the previous
sets left (``ops/rigid_general.locate_bodies``), seeded by its tracks'
constant-velocity predictions, then tracked (``ops/body_tracker.update``).
The state is then (KalmanState, (BodyTrackState, ...)), as
``make_init_state`` builds it.  Because the body stage is seeded by the
tracker, batched serving runs it frame by frame after the batched geometry
and the bank, the same calls per-frame serving makes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.ops import body_tracker
from low_cost_mocap_tpu_torch.ops import camera as cam_ops
from low_cost_mocap_tpu_torch.ops import (correspond, detect, detect_cuda,
                                          kalman, kalman_cuda, rigid,
                                          rigid_general, world)
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.utils import tree


class FrameOutputs(NamedTuple):
    """Everything the engine emits per frame, fixed-shape (an optional
    leading batch axis on every leaf)."""

    blob_px: torch.Tensor        # (C, K, 2) detected centroids (undistorted)
    blob_valid: torch.Tensor     # (C, K)
    object_points: torch.Tensor  # (C*K, 3) world-frame triangulated points
    point_errors: torch.Tensor   # (C*K,) reprojection errors
    point_valid: torch.Tensor    # (C*K,)
    objects: rigid.LocatedObjects      # raw rigid-body fits
    tracked: kalman.TrackedObjects     # Kalman/low-pass output
    point_obs: Any = None        # (C*K, C, 2) winners' per-camera pixels
    point_obs_mask: Any = None   # (C*K, C); both with ``with_obs`` only
    bodies: Any = None           # rigid_general.LocatedBodies (I, ...)
    tracked_bodies: Any = None   # body_tracker.TrackedBodies (I, ...); both
    #                              with body templates only


def pack_outputs(out: FrameOutputs) -> torch.Tensor:
    """Flatten FrameOutputs into one float32 vector per frame — (L,), or
    (B, L) for batched outputs — so a frame's readback is one transfer.
    The layout is the JAX package's; decode with ``unpack_outputs``.  The
    body fields come last (``_pack_bodies``)."""
    leaves = [out.blob_px, out.blob_valid, out.object_points,
              out.point_errors, out.point_valid, *out.objects, *out.tracked]
    if out.point_obs is not None:
        leaves += [out.point_obs, out.point_obs_mask]
    if out.bodies is not None:
        leaves += [*out.bodies, *out.tracked_bodies]
    return _pack(leaves, out.tracked.valid.shape[:-1])


def _pack(leaves, lead) -> torch.Tensor:
    return torch.cat([t.to(torch.float32).reshape(*lead, -1)
                      for t in leaves], dim=-1)


def _pack_bodies(bodies, tracked_bodies) -> torch.Tensor:
    """The body fields of one frame's packed row: its last
    ``row_length`` - ``row_length(num_bodies=0)`` floats."""
    return _pack([*bodies, *tracked_bodies], ())


def _sizes(C: int, K: int, O: int, with_obs: bool, I: int) -> list:
    N = C * K
    return [C * K * 2, C * K, N * 3, N, N, N * 3, N, N, N, N,
            O * 3, O * 3, O, O] + ([N * C * 2, N * C] if with_obs else []) \
        + ([I * 9, I * 3, I, I, I * 3, I * 3, I * 4, I] if I else [])


def row_length(num_cameras: int, max_blobs: int, num_objects: int,
               with_obs: bool = False, num_bodies: int = 0) -> int:
    """Length L of one frame's packed row (``pack_outputs``)."""
    return sum(_sizes(num_cameras, max_blobs, num_objects, with_obs,
                      num_bodies))


def unpack_outputs_batch(rows: np.ndarray, num_cameras: int, max_blobs: int,
                         num_objects: int, with_obs: bool = False,
                         num_bodies: int = 0) -> list:
    """Decode a (B, L) batch of packed rows into per-frame FrameOutputs of
    numpy arrays (views into the batch).  ``with_obs`` mirrors the step's
    flag; ``num_bodies`` is the total body slots (0 without templates)."""
    C, K, O, I = num_cameras, max_blobs, num_objects, num_bodies
    N = C * K
    rows = np.asarray(rows)
    B = rows.shape[0]
    splits = np.split(rows, np.cumsum(_sizes(C, K, O, with_obs, I))[:-1],
                      axis=1)
    (blob_px, blob_valid, obj_pts, errs, pvalid, lpos, lhead, lerr, lidx,
     lvalid, tpos, tvel, thead, tvalid) = splits[:14]
    n = 14
    if with_obs:
        pobs = splits[14].reshape(B, N, C, 2)
        pobs_m = splits[15].reshape(B, N, C) > 0.5
        n = 16
    if I:
        bR, bt, brms, bvalid, tbpos, tbvel, tbquat, tbvalid = splits[n:]
        bR = bR.reshape(B, I, 3, 3)
        bt = bt.reshape(B, I, 3)
        bvalid = bvalid > 0.5
        tbpos = tbpos.reshape(B, I, 3)
        tbvel = tbvel.reshape(B, I, 3)
        tbquat = tbquat.reshape(B, I, 4)
        tbvalid = tbvalid > 0.5
    blob_px = blob_px.reshape(B, C, K, 2)
    blob_valid = blob_valid.reshape(B, C, K) > 0.5
    obj_pts = obj_pts.reshape(B, N, 3)
    pvalid = pvalid > 0.5
    lpos = lpos.reshape(B, N, 3)
    lidx = lidx.astype(np.int32)
    lvalid = lvalid > 0.5
    tpos = tpos.reshape(B, O, 3)
    tvel = tvel.reshape(B, O, 3)
    tvalid = tvalid > 0.5
    return [FrameOutputs(
        blob_px=blob_px[i], blob_valid=blob_valid[i],
        object_points=obj_pts[i], point_errors=errs[i],
        point_valid=pvalid[i],
        objects=rigid.LocatedObjects(pos=lpos[i], heading=lhead[i],
                                     error=lerr[i], index=lidx[i],
                                     valid=lvalid[i]),
        tracked=kalman.TrackedObjects(pos=tpos[i], vel=tvel[i],
                                      heading=thead[i], valid=tvalid[i]),
        point_obs=pobs[i] if with_obs else None,
        point_obs_mask=pobs_m[i] if with_obs else None,
        bodies=rigid_general.LocatedBodies(
            R=bR[i], t=bt[i], rms=brms[i], valid=bvalid[i]) if I else None,
        tracked_bodies=body_tracker.TrackedBodies(
            pos=tbpos[i], vel=tbvel[i], quat=tbquat[i],
            valid=tbvalid[i]) if I else None,
    ) for i in range(B)]


def unpack_outputs(arr: np.ndarray, num_cameras: int, max_blobs: int,
                   num_objects: int, with_obs: bool = False,
                   num_bodies: int = 0) -> FrameOutputs:
    """Inverse of ``pack_outputs`` on one host row."""
    return unpack_outputs_batch(np.asarray(arr)[None], num_cameras,
                                max_blobs, num_objects, with_obs,
                                num_bodies)[0]


class MocapPipeline:
    """Rig geometry on one device and the per-frame step over it.

    ``step(state, frames, dt)`` runs ``frame_step`` on (C, H, W) float (or
    uint8) frames with the engine config's detection and matching settings
    and the rig's body sets; ``preprocess_frames`` blurs and sharpens them
    first.  ``device``: CUDA by default, "cpu" when asked."""

    def __init__(self, rig, engine, Rs, ts, to_world_matrix=None,
                 preprocess_frames: bool = True, device=None):
        self.rig = rig
        self.engine = engine
        self.device = dev = resolve_device(device)
        self.K = torch.as_tensor(rig.K_stack(), device=dev)
        self.dist = torch.as_tensor(rig.dist_stack(), device=dev)
        self.Rs = torch.as_tensor(np.asarray(Rs, np.float32), device=dev)
        self.ts = torch.as_tensor(np.asarray(ts, np.float32), device=dev)
        self.Ps = cam_ops.projection_matrix(self.K, self.Rs, self.ts)
        if to_world_matrix is None:
            to_world_matrix = np.eye(4, dtype=np.float32)
        self.to_world_matrix = torch.as_tensor(
            np.asarray(to_world_matrix, np.float32), device=dev)
        self.Fs = correspond._pairwise_fundamentals(self.Ps)
        self.preprocess_frames = preprocess_frames
        e = engine
        self._kw = dict(
            threshold=e.detect_threshold, max_blobs=e.max_blobs,
            cc_iters=e.cc_iters, gate_px=e.epipolar_gate_px,
            max_candidates=e.max_candidates_per_cam,
            marker_dist1=rig.marker_dist_short,
            marker_dist2=rig.marker_dist_long,
            marker_tol=rig.marker_dist_tol,
            marker_side_min=rig.marker_side_min,
            do_preprocess=preprocess_frames,
            body_sets=rig.body_sets_resolved())

        self._state = self._cal = None   # the compiled steps' buffers
        self._steps = {}                 # (shape, dtype) -> CompiledStep

    def init_state(self):
        return make_init_state(self.rig, device=self.device)

    def step(self, state, frames, dt):
        """One frame: (state, (C, H, W) frames, dt) -> (state, outputs).

        The compiled step (``runtime/compiled.py``; a CUDA graph on the
        card, one per shape and dtype of ``frames``): ``state`` is donated
        and the state returned is the pipeline's state buffers, which the
        next step overwrites; the outputs are the caller's.  The
        calibration tensors at the first step are the steps' buffers:
        change them in place; an attribute rebound since is copied into
        them at every step."""
        frames = torch.as_tensor(frames)
        key = (tuple(frames.shape), frames.dtype)
        cal = (self.Ps, self.K, self.dist, self.to_world_matrix, self.Fs)
        if self._state is None:
            self._state = tree.tree_map(torch.clone, state)
            self._cal = cal
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = compiled.CompiledStep(
                self._frame_step, self._state,
                torch.empty(key[0], dtype=key[1], device=self.device),
                torch.zeros((), dtype=torch.float32, device=self.device),
                *self._cal, name=f"MocapPipeline.step{key[0]}")
        state, out = step(state, frames, dt, *cal)
        return state, tree.tree_map(torch.clone, out)

    def _frame_step(self, state, frames, dt, *cal):
        return frame_step(state, frames, dt, *cal, **self._kw)


def make_init_state(rig, device=None):
    """Initial tracker state for this rig on ``device`` (CUDA by default):
    a KalmanState, or with body templates (KalmanState, (BodyTrackState
    per set, ...))."""
    ks = kalman.init_state(rig.num_objects, device=device)
    sets = rig.body_sets_resolved()
    if sets:
        return (ks, tuple(body_tracker.init_state(mi, device=device)
                          for _, mi in sets))
    return ks


def tail_kwargs(rig, cfg, with_obs: bool = False) -> dict:
    """The keyword options of ``track_from_blobs`` and
    ``scan_track_from_blobs`` that a rig and an ``EngineConfig`` set: one
    place for the Engine's tail and the camera-sharded step's."""
    return dict(gate_px=cfg.epipolar_gate_px,
                max_candidates=cfg.max_candidates_per_cam,
                marker_dist1=rig.marker_dist_short,
                marker_dist2=rig.marker_dist_long,
                marker_tol=rig.marker_dist_tol,
                marker_side_min=rig.marker_side_min,
                body_sets=rig.body_sets_resolved(),
                kalman_report=cfg.kalman_report,
                with_obs=with_obs)


def _resolve_sets(body_template, max_bodies, body_sets):
    """``body_template``/``max_bodies`` is single-set shorthand.  The result
    is a tuple with an int count, hashable for offline's cache keys."""
    if body_sets is None and body_template is not None:
        return ((body_template, int(max_bodies)),)
    return tuple(body_sets) if body_sets else ()


def _body_stage(body_states, pts, live, dt, body_sets):
    """One frame's bodies: each set fit over the points the previous sets
    left, seeded by its tracks' constant-velocity predictions, then
    tracked.  pts: (N, 3); live: (N,); dt: () tensor.  Returns (new body
    states, in the structure given — a bare BodyTrackState stays bare —,
    LocatedBodies and TrackedBodies over all slots in set order)."""
    legacy = isinstance(body_states, body_tracker.BodyTrackState)
    states = (body_states,) if legacy else body_states
    fits, tracks, new = [], [], []
    for si, (tmpl, max_inst) in enumerate(body_sets):
        bs = states[si]
        b, live = rigid_general.locate_bodies(
            pts, live, tmpl, max_instances=max_inst, return_live=True,
            seed_R=body_tracker.quat_to_rot(bs.quat),
            seed_t=bs.pos + bs.vel * dt, seed_ok=bs.active)
        nbs, tb = body_tracker.update(bs, b.t, b.R, b.rms, b.valid, dt)
        fits.append(b)
        tracks.append(tb)
        new.append(nbs)
    bodies = rigid_general.LocatedBodies(*(torch.cat(x) for x in zip(*fits)))
    tracked = body_tracker.TrackedBodies(*(torch.cat(x)
                                           for x in zip(*tracks)))
    return (new[0] if legacy else tuple(new)), bodies, tracked


def _locate_frame(blobs, blob_valid, Ps, K, dist, to_world_matrix, Fs, *,
                  gate_px, max_candidates, marker_dist1, marker_dist2,
                  marker_tol, marker_side_min, with_obs=False):
    """Frame-independent geometry over a (B, C, K, ...) batch: undistort ->
    epipolar match -> DLT -> world transform -> rigid-body triple fit.
    Returns (blobs_u, match dict, world points, LocatedObjects)."""
    blobs_u = cam_ops.undistort_points(blobs, K[:, None], dist[:, None])
    blobs_u = torch.where(blob_valid[..., None], blobs_u, 0.0)
    match = correspond.match_points(blobs_u, blob_valid, Ps, gate_px=gate_px,
                                    max_candidates=max_candidates, Fs=Fs,
                                    with_obs=with_obs)
    pts = world.to_world(match["object_points"], to_world_matrix)
    pts = torch.where(match["valid"][..., None], pts, 0.0)
    # heading/side axes (0, 2): the horizontal plane of the world frame
    located = rigid.locate_objects(pts, match["errors"], match["valid"],
                                   dist1=marker_dist1, dist2=marker_dist2,
                                   tol=marker_tol, side_min=marker_side_min,
                                   ax_h1=0, ax_h2=2)
    return blobs_u, match, pts, located


def _bank(state, located, dts, report, kalman_impl):
    """The Kalman bank over a (B, ...) batch of located objects.

    ``kalman_impl``: "auto" — the ``kalman_bank`` kernel for CUDA tensors,
    the plain chain for CPU tensors; "cuda" — the kernel (CUDA tensors
    only); "torch" — the plain chain."""
    args = (state, located.pos, located.heading, located.index,
            located.valid, dts)
    if kalman_impl == "torch":
        return kalman.update_scan(*args, report=report)
    if kalman_impl == "cuda" and dts.device.type != "cuda":
        raise ValueError("kalman_impl='cuda' needs CUDA tensors")
    if kalman_impl not in ("auto", "cuda"):
        raise ValueError(f"kalman_impl must be auto/cuda/torch: "
                         f"{kalman_impl!r}")
    return kalman_cuda.kalman_scan(*args, report=report)


def _batch_outputs(blobs_u, blob_valid, match, pts, located, tracked,
                   bodies=None, tracked_bodies=None):
    return FrameOutputs(
        blob_px=blobs_u, blob_valid=blob_valid, object_points=pts,
        point_errors=match["errors"], point_valid=match["valid"],
        objects=located, tracked=tracked, point_obs=match.get("obs"),
        point_obs_mask=match.get("obs_mask"), bodies=bodies,
        tracked_bodies=tracked_bodies)


def scan_track_from_blobs(state, blobs_b, blob_valid_b, dts, Ps, K, dist,
                          to_world_matrix, Fs, *, gate_px: float,
                          max_candidates: int, marker_dist1: float,
                          marker_dist2: float, marker_tol: float,
                          marker_side_min: float, body_template=None,
                          max_bodies: int = 2, body_sets=None,
                          with_obs: bool = False, kalman_report: str = "pre",
                          kalman_impl: str = "auto"):
    """Batched serving: B consecutive frames' geometry as batched ops, then
    the bank over the batch in one kernel launch, then (with body
    templates) the body stage frame by frame, as per-frame serving runs it.

    blobs_b: (B, C, K, 2); blob_valid_b: (B, C, K); dts: (B,), numbers or
    a tensor on the blobs' device.
    Returns (state after B frames, packed (B, L) rows).
    """
    body_sets = _resolve_sets(body_template, max_bodies, body_sets)
    if body_sets:
        state, body_states = state
    dts = torch.as_tensor(dts, dtype=torch.float32, device=blobs_b.device)
    state, (rows, pts, live) = scan_head(
        state, blobs_b, blob_valid_b, dts, Ps, K, dist, to_world_matrix, Fs,
        gate_px=gate_px, max_candidates=max_candidates,
        marker_dist1=marker_dist1, marker_dist2=marker_dist2,
        marker_tol=marker_tol, marker_side_min=marker_side_min,
        with_obs=with_obs, kalman_report=kalman_report,
        kalman_impl=kalman_impl)
    if body_sets:
        per = []
        for i in range(dts.shape[0]):
            body_states, row = body_row(body_states, pts[i], live[i], dts[i],
                                        body_sets=body_sets)
            per.append(row)
        rows = torch.cat([rows, torch.stack(per)], dim=-1)
        state = (state, body_states)
    return state, rows


def scan_head(state, blobs_b, blob_valid_b, dts, Ps, K, dist,
              to_world_matrix, Fs, *, gate_px: float, max_candidates: int,
              marker_dist1: float, marker_dist2: float, marker_tol: float,
              marker_side_min: float, with_obs: bool = False,
              kalman_report: str = "pre", kalman_impl: str = "auto"):
    """The batched program up to the body stage: B frames' geometry and the
    bank over them (one kernel launch).  ``state`` is the KalmanState; dts
    a (B,) tensor.  Returns (new KalmanState, (packed (B, L0) rows without
    the body fields, the world points (B, N, 3) and their validity (B, N)
    that the body stage takes))."""
    geo = _locate_frame(
        blobs_b, blob_valid_b, Ps, K, dist, to_world_matrix, Fs,
        gate_px=gate_px, max_candidates=max_candidates,
        marker_dist1=marker_dist1, marker_dist2=marker_dist2,
        marker_tol=marker_tol, marker_side_min=marker_side_min,
        with_obs=with_obs)
    state, tracked = _bank(state, geo[3], dts, kalman_report, kalman_impl)
    rows = pack_outputs(_batch_outputs(geo[0], blob_valid_b, *geo[1:],
                                       tracked))
    return state, (rows, geo[2], geo[1]["valid"])


def body_row(body_states, pts, live, dt, *, body_sets):
    """One frame's body stage (``_body_stage``) -> (new body states, the
    body fields of its packed row)."""
    body_states, bodies, tracked = _body_stage(body_states, pts, live, dt,
                                               body_sets)
    return body_states, _pack_bodies(bodies, tracked)


def track_from_blobs(state, blobs, blob_valid, dt, Ps, K, dist,
                     to_world_matrix, Fs=None, *, gate_px: float,
                     max_candidates: int, marker_dist1: float,
                     marker_dist2: float, marker_tol: float,
                     marker_side_min: float, body_template=None,
                     max_bodies: int = 2, body_sets=None,
                     with_obs: bool = False, kalman_report: str = "pre",
                     kalman_impl: str = "auto"):
    """Post-detection tail of one frame: (C, K, 2) blobs -> (new_state,
    FrameOutputs).  The batched code at B = 1.  ``dt``: a number, or a 0-d
    float32 tensor on the blobs' device."""
    body_sets = _resolve_sets(body_template, max_bodies, body_sets)
    if body_sets:
        state, body_states = state
    if Fs is None:
        Fs = correspond._pairwise_fundamentals(Ps)
    geo = _locate_frame(
        blobs[None], blob_valid[None], Ps, K, dist, to_world_matrix, Fs,
        gate_px=gate_px, max_candidates=max_candidates,
        marker_dist1=marker_dist1, marker_dist2=marker_dist2,
        marker_tol=marker_tol, marker_side_min=marker_side_min,
        with_obs=with_obs)
    dts = torch.as_tensor(dt, dtype=torch.float32,
                          device=blobs.device).reshape(1)
    state, tracked = _bank(state, geo[3], dts, kalman_report, kalman_impl)
    out = _batch_outputs(geo[0], blob_valid[None], *geo[1:], tracked)
    bodies = tracked_bodies = None
    if body_sets:
        body_states, bodies, tracked_bodies = _body_stage(
            body_states, geo[2][0], geo[1]["valid"][0], dts[0], body_sets)
        state = (state, body_states)
    return state, FrameOutputs(
        out.blob_px[0], out.blob_valid[0], out.object_points[0],
        out.point_errors[0], out.point_valid[0],
        rigid.LocatedObjects(*(t[0] for t in out.objects)),
        kalman.TrackedObjects(*(t[0] for t in out.tracked)),
        *(None if t is None else t[0]
          for t in (out.point_obs, out.point_obs_mask)),
        bodies=bodies, tracked_bodies=tracked_bodies)


def frame_step(state, frames, dt, Ps, K, dist, to_world_matrix, Fs=None, *,
               threshold: float, max_blobs: int, cc_iters: int,
               gate_px: float, max_candidates: int,
               marker_dist1: float, marker_dist2: float, marker_tol: float,
               marker_side_min: float, do_preprocess: bool,
               packed_input: bool = False, sparse_input: bool = False,
               image_shape: tuple[int, int, int] | None = None,
               body_template=None, max_bodies: int = 2, body_sets=None,
               with_obs: bool = False, kalman_report: str = "pre",
               kalman_impl: str = "auto"):
    """One frame: detection, then ``track_from_blobs``.

    ``packed_input=True`` takes (C, H, W//8) uint8 bit-packed binary frames
    (``ops.detect.pack_frames``); ``sparse_input=True`` takes (budget,)
    int32 lit-pixel indices (``ops.detect.sparse_ingest``) and needs
    ``image_shape`` = (C, H, W); otherwise (C, H, W) uint8 or float frames
    thresholded on the device, blurred and sharpened first with
    ``do_preprocess`` (which needs such frames: binary ones raise).
    Returns (new_state, FrameOutputs).
    """
    if do_preprocess and (sparse_input or packed_input):
        raise ValueError("do_preprocess blurs dense frames; sparse and "
                         "packed inputs are already thresholded")
    if sparse_input:
        if image_shape is None:
            raise ValueError("sparse_input needs image_shape = (C, H, W)")
        frames = detect.scatter_pixels(frames, image_shape)
        eff_threshold = 0.5
    elif packed_input:
        frames = detect.unpack_bits(frames)
        eff_threshold = 0.5
    else:
        if not frames.is_floating_point():
            frames = frames.to(torch.float32) * (1.0 / 255.0)
        if do_preprocess:
            frames = detect.preprocess(frames)
        eff_threshold = threshold
    blobs, blob_valid, _ = detect_cuda.find_blobs(
        frames, eff_threshold, max_blobs, cc_iters=cc_iters)
    return track_from_blobs(
        state, blobs, blob_valid, dt, Ps, K, dist, to_world_matrix, Fs,
        gate_px=gate_px, max_candidates=max_candidates,
        marker_dist1=marker_dist1, marker_dist2=marker_dist2,
        marker_tol=marker_tol, marker_side_min=marker_side_min,
        body_template=body_template, max_bodies=max_bodies,
        body_sets=body_sets, with_obs=with_obs,
        kalman_report=kalman_report, kalman_impl=kalman_impl)


def batched_track_from_blobs(states, blobs, blob_valid, dts, Ps, K, dist,
                             to_world_matrices, Fs, **kw):
    """Multi-rig serving: R independent rigs in one call, every argument
    with a leading rig axis (states stacked (R, ...), blobs (R, C, K, 2),
    per-rig calibrations).  Each rig runs ``track_from_blobs`` in turn —
    the bank kernel launches once per rig on the card.  All rigs share the
    static config (``kw``).  Returns (states (R, ...), FrameOutputs with
    (R, ...) leaves)."""
    new, outs = [], []
    for r in range(blobs.shape[0]):
        st, out = track_from_blobs(
            tree.tree_map(lambda x: x[r], states), blobs[r], blob_valid[r],
            dts[r], Ps[r], K[r], dist[r], to_world_matrices[r],
            None if Fs is None else Fs[r], **kw)
        new.append(st)
        outs.append(out)
    return tree.stack(new), tree.stack(outs)
