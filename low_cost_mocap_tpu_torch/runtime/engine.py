"""The streaming mocap engine of the port: capture loop + event surface.

The port's counterpart of ``low_cost_mocap_tpu/runtime/engine.py``: mode
flags (capture / triangulate / locate) that select which outputs to emit,
camera poses and the world matrix as server-side state with persistence
under ``artifacts_dir``, the reference's Socket.IO event surface, camera
health, the drone command link, and the capture loop.

Ingest paths, chosen at construction (the JAX engine's choice):

- **host detection** (the default on a CUDA engine): the native detector
  (``control/native/detect.cc``) turns each frame set into one (C, K, 3)
  [x, y, valid] tensor, written straight into a page-locked host buffer and
  uploaded without blocking; the card runs only ``track_from_blobs``, or,
  with ``EngineConfig.dispatch_batch`` = B > 1, one
  ``scan_track_from_blobs`` per B frames (the bank kernel once at B);
- **sparse / packed** (``host_detect=False``): the lit pixels' indices, or
  the 1-bit bitmap when more than ``sparse_budget`` pixels are lit, go up
  and the ``detect_blobs`` kernel detects on the card;
- **dense** (``fast_path=False``, and with ``preprocess_frames``): uint8
  frames go up whole, and with ``preprocess_frames`` are blurred and
  sharpened on the card before detection;
- **camera-sharded** (``mesh`` with a ``cam`` axis): frames are packed to
  1 bit on the host into a page-locked buffer laid out shard by shard,
  each shard of cameras goes to its device and is detected there by the
  ``detect_blobs`` kernel, and the blobs meet on the mesh's first device,
  the engine's, for the tail (``parallel/dist_pipeline.py``); with
  ``dispatch_batch`` = B > 1, one batched step per B frames.

Every step is compiled (``runtime/compiled.py``, the counterpart of the
JAX engine's ``_build_steps`` and of its camera-sharded
``_compiled_dist_step``/``_compiled_dist_scan_step``): on the card a CUDA
graph per kind of frame (host blobs, sparse, packed, dense, mesh, and the
batched program), captured at its first frame and replayed at every frame
(or batch), over static buffers for the payload (a shard's frames on the
shard's device), ``dt``, the tracker state (donated: ``_kalman_state`` is
the buffers) and the calibration (changed in place by
``set_calibration``); on the CPU the same buffers serve the step eagerly.
A capture that fails raises.  The camera-sharded step is one graph when
every shard is on the engine's card, and a graph a shard device plus the
tail's graph when the shards are on several cards (``_ShardedStep``).  A
mesh across processes (a ``torch.distributed`` group) runs its step op by
op, by construction: its gather is a collective, and gloo's cannot be
captured.  The steps are the engine's own, one per kind, and a rebuild
replaces them.

Each step's outputs come back as one packed row per frame.  With
``readback_pipeline_depth`` = d > 0 the row's copy into a page-locked host
buffer is issued without blocking, an event is recorded after it, and the
row is read ``d`` frames (or batches) later, once its event has completed.
``batch_emit_thread`` hands dispatched batches to a worker thread that
waits on their events, decodes and emits, and launches nothing on the
card.  Every path serves with the matcher's observations (``with_obs``),
which live recalibration collects.

A rig with body templates (``RigConfig.body_markers`` / ``body_sets``)
adds 6-DoF body fits and tracks to every row and ``bodies`` /
``tracked_bodies`` to the ``object-points`` payload.
``learn-body-template`` learns a template from the served points and can
apply it: the row layout, the readback ring and the tracker state are
rebuilt under the model lock, and rows still pending in the old layout
are dropped; every readback carries the ring and layout it was read with,
so no row is decoded with another layout.

The calibration workflow runs on the engine's device: extrinsics from a
wand capture (RANSAC pose bootstrap + bundle adjustment), scale, floor and
origin, live refinement from the served frames' observations, and
intrinsics from a dot-grid target.  ``run-trajectory`` drips a planned
trajectory to the drone link, one tick per decoded frame.
``record-frames`` keeps the raw frames for a replayable .npz, and
``capture-profile`` writes a ``torch.profiler`` trace of the serving loop
from a thread of its own.

No path changes quietly: a native library that does not build raises, and
a CPU engine is only ever one the caller asked for (``device="cpu"``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import tempfile
import threading
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from low_cost_mocap_tpu_torch.config import (CameraIntrinsics, EngineConfig,
                                             RigConfig)
from low_cost_mocap_tpu_torch.control import bindings
from low_cost_mocap_tpu_torch.device import resolve_device
from low_cost_mocap_tpu_torch.models import calibrator
from low_cost_mocap_tpu_torch.models.pipeline import (body_row, frame_step,
                                                      make_init_state,
                                                      pack_outputs,
                                                      row_length, scan_head,
                                                      tail_kwargs,
                                                      track_from_blobs,
                                                      unpack_outputs_batch)
from low_cost_mocap_tpu_torch.ops import ba as ba_ops
from low_cost_mocap_tpu_torch.ops import camera as cam_ops
from low_cost_mocap_tpu_torch.ops import correspond, intrinsics
from low_cost_mocap_tpu_torch.ops import triangulate as tri_ops
from low_cost_mocap_tpu_torch.ops import world
from low_cost_mocap_tpu_torch.ops.detect import (pack_frames, sparse_ingest,
                                                 threshold_cutoff)
from low_cost_mocap_tpu_torch.ops.rigid_general import learn_template
from low_cost_mocap_tpu_torch.ops.rotations import quat_to_matrix_np
from low_cost_mocap_tpu_torch.parallel.dist_pipeline import (
    detect_gather, detect_shard, dist_frame_step, dist_scan_frame_step)
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.runtime.compiled import HostRing
from low_cost_mocap_tpu_torch.runtime.health import CameraHealthMonitor
from low_cost_mocap_tpu_torch.utils import artifacts, profiling
from low_cost_mocap_tpu_torch.utils.recordings import save_recording


class _Readback(NamedTuple):
    """A packed row (or (B, L) rows) on its way back: the ring and slot it
    is copied into, the layout that decodes it and the body-slot ->
    template map of that layout."""

    ring: HostRing
    slot: int
    layout: tuple
    set_of_slot: np.ndarray


class Engine:
    def __init__(self, rig: RigConfig, cfg: EngineConfig, source, link,
                 preprocess_frames: bool = False,
                 fast_path: bool | None = None,
                 host_detect: bool | None = None,
                 artifacts_dir: str | None = None, device=None, mesh=None):
        """``device``: where the tracking step runs — CUDA by default
        (raises without it); ``"cpu"`` runs the plain versions of the
        kernels.

        ``preprocess_frames``: blur + sharpen dense frames on the device
        before detection; it needs dense ingest, so asking for it together
        with the fast path or host detection raises.
        ``fast_path`` (default: on for a CUDA engine, or when host detection
        is asked for; off with ``preprocess_frames``): 1-bit / sparse
        ingest; off means dense uint8 frames.  ``host_detect`` (default:
        the fast path) detects blobs on the host with the native library,
        which must build.  ``dispatch_batch > 1`` needs host detection or
        a mesh.

        ``mesh`` (``parallel.mesh.make_mesh`` with a ``cam`` axis):
        camera-sharded serving.  Each shard detects its cameras on its
        device from 1-bit packed frames, and the tail runs on the mesh's
        first device, which is the engine's (a ``device`` that differs
        raises).  The camera count must be divisible by the ``cam`` size;
        preprocessing, host detection and ``fast_path=False`` raise."""
        if mesh is not None:
            if device is not None and not _same_device(
                    resolve_device(device), mesh.tail_device):
                raise ValueError(
                    f"device {device} is not the mesh's first device "
                    f"{mesh.tail_device}")
            device = mesh.tail_device
            if "cam" not in mesh.shape:
                raise ValueError("mesh mode shards cameras over a 'cam' "
                                 f"axis; the mesh has {mesh.axis_names}")
            if rig.num_cameras % mesh.shape["cam"] != 0:
                raise ValueError(
                    f"{rig.num_cameras} cameras not divisible by cam axis "
                    f"size {mesh.shape['cam']}")
            if preprocess_frames:
                raise ValueError(
                    "mesh mode has no preprocess path (blur/sharpen); "
                    "use preprocess_frames=False")
            if host_detect:
                raise ValueError(
                    "mesh mode shards detection on the devices per camera "
                    "shard; host_detect does not apply")
            if fast_path is False:
                raise ValueError(
                    "mesh mode requires the packed fast path (per-shard "
                    "1-bit ingest); fast_path=False is not available")
            fast_path, host_detect = True, False
        self._mesh = mesh
        self.device = resolve_device(device)
        if preprocess_frames and (fast_path or host_detect):
            raise ValueError(
                "preprocess_frames blurs dense frames on the device; it "
                "takes neither the fast path nor host detection")
        self._preprocess = bool(preprocess_frames)
        if fast_path is None:
            fast_path = not self._preprocess and (
                self.device.type == "cuda" or bool(host_detect))
        if host_detect is None:
            host_detect = fast_path
        if host_detect and not fast_path:
            raise ValueError("host_detect is an ingest of the fast path; "
                             "fast_path=False asks for dense frames")
        self._fast = bool(fast_path)
        self._host_detect = bool(host_detect)
        if self._host_detect:
            bindings.get_lib()     # a failed build raises here
        self._batch = max(int(cfg.dispatch_batch), 1)
        if self._batch > 1 and not (self._host_detect or mesh is not None):
            raise ValueError(
                "dispatch_batch > 1 requires the host-detect ingest path "
                "(native detector + fast path) or mesh mode: the batched "
                "program runs pre-detected (or per-shard-detected) blobs "
                "through scan_track_from_blobs")

        self.rig = rig
        self.cfg = cfg
        self.source = source
        self.link = link
        if hasattr(link, "on_health"):
            # command-link health (PyserialLink): a ``link-health`` event,
            # and a stall disarms the local arm mirror (the firmware's 2 s
            # ping failsafe has cut the motors by then).  Chained after a
            # caller-installed callback.
            prev_cb = link.on_health

            def _chained(health, _prev=prev_cb):
                self._on_link_health(health)
                if _prev is not None:
                    _prev(health)

            link.on_health = _chained

        self.is_capturing_points = False
        self.is_triangulating_points = False
        self.is_locating_objects = False
        self.camera_poses: tuple[np.ndarray, np.ndarray] | None = None
        self.to_world_matrix = np.eye(4, dtype=np.float32)
        self.drone_armed = [False] * rig.num_objects
        self.captured_points: list = []
        # run-trajectory's state machine and refine-camera-pose's
        # collection are advanced by the thread that emits frames (the
        # capture loop, or the emit worker) and started and stopped by
        # server threads: both sit under _live_lock.  A lock rather than
        # handing the ticks back to the capture thread, because a tick needs
        # its frame's decoded outputs, which only the emitting thread has,
        # in frame order.  Reentrant: a tick emits, and a listener may
        # answer with an event of its own.
        self._live_lock = threading.RLock()
        self._traj: dict | None = None
        self._refine_obs: list | None = None
        self._intrinsics_capture: dict | None = None
        self._learning_frames: list | None = None
        # record-frames: the capture thread appends under _frame_lock
        self._recording: list | None = None
        self._recording_cap = 0
        self.artifacts_dir = artifacts_dir
        if artifacts_dir:
            # persisted intrinsics replace the rig's before K is built
            self.rig = rig = self._load_intrinsics_artifact(rig)

        # _model_lock guards the step's state (calibration tensors, the
        # tracker state, the row layout and readback ring, the pending
        # readbacks and the batch being filled) against server threads
        # swapping it while the capture loop steps;
        # _frame_lock guards the frames and outputs the stream displays
        self._model_lock = threading.Lock()
        self._frame_lock = threading.Lock()
        self._batch_cond = threading.Condition(self._model_lock)

        dev = self.device
        self._K = torch.as_tensor(rig.K_stack(), device=dev)
        self._dist = torch.as_tensor(rig.dist_stack(), device=dev)
        self._Ps = torch.eye(3, 4, device=dev).repeat(rig.num_cameras, 1, 1)
        self._F = correspond._pairwise_fundamentals(self._Ps)
        self._F_np = None          # host copy for the epiline overlay
        self._F_np_src = None      # ... of this calibration version
        self._cal_version = 0
        self._M = torch.as_tensor(self.to_world_matrix, device=dev)
        self._kalman_state = make_init_state(rig, device=dev)
        if artifacts_dir:
            self._load_calibration_artifact()   # resume the calibration

        self._cutoff = threshold_cutoff(cfg.detect_threshold)
        C, K = rig.num_cameras, cfg.max_blobs
        # host buffers for host-detect ingest: one frame set, or two
        # batches so one fills while the other's upload may be in flight;
        # in mesh mode the packed frames, shard by shard: (d, [B,] C/d,
        # H, W/8), so each shard's part is one contiguous upload
        self._ingest_ring = None
        lead = (self._batch,) if self._batch > 1 else ()
        if mesh is not None:
            H, W = rig.image_hw()
            d = mesh.shape["cam"]
            self._ingest_ring = HostRing(
                2 if self._batch > 1 else 4,
                (d,) + lead + (C // d, H, W // 8), dev, torch.uint8)
        elif self._batch > 1 or self._host_detect:
            self._ingest_ring = HostRing(2 if self._batch > 1 else 4,
                                         lead + (C, K, 3), dev)
        self._configure_step()
        # dispatched (readback, dts) in dispatch order, per frame or batched
        self._pending: collections.deque = collections.deque()
        self._batch_slot: int | None = None    # ingest slot being filled
        self._batch_dts: list = []

        self.timer = profiling.StageTimer()
        self._listeners: dict[str, list[Callable[[Any], None]]] = {}
        self._thread: threading.Thread | None = None
        self._running = False
        self._last_frames: np.ndarray | None = None
        self._last_out = None
        self._emit_worker: threading.Thread | None = None
        self._emit_worker_busy = False
        if cfg.batch_emit_thread and self._batch > 1:
            self._start_emit_worker()
        self.fps = 0.0
        self.frame_count = 0
        self.health = (CameraHealthMonitor(
            rig.num_cameras, freeze_frames=cfg.health_freeze_frames,
            dark_frames=cfg.health_dark_frames,
            interval=cfg.health_interval)
            if cfg.health_enabled else None)

    def _configure_step(self) -> None:
        """The step's arguments, the packed-row layout and the readback
        ring for ``self.rig``: at construction, and under the model lock
        when learn-body-template applies a template (the row grows by 25
        floats a body slot)."""
        rig, cfg = self.rig, self.cfg
        self._tail_kw = tail_kwargs(rig, cfg, with_obs=True)
        sets = self._tail_kw["body_sets"]
        self._step_kw = dict(threshold=cfg.detect_threshold,
                             max_blobs=cfg.max_blobs, cc_iters=cfg.cc_iters,
                             do_preprocess=self._preprocess, **self._tail_kw)
        # body output slot -> template (set) index, for client payloads
        self._body_set_of_slot = np.asarray(
            [si for si, (_, mi) in enumerate(sets) for _ in range(mi)],
            np.int32)
        # rows carry the observations, and the body slots
        self._layout = (rig.num_cameras, cfg.max_blobs, rig.num_objects,
                        True, len(self._body_set_of_slot))
        L = row_length(*self._layout)
        # the row ring outlasts the deepest pipeline plus the emit
        # worker's backlog
        self._row_ring = HostRing(max(cfg.readback_pipeline_depth, 4) + 2,
                                  (self._batch, L) if self._batch > 1
                                  else (L,), self.device)
        self._steps = self._build_steps()

    def _calibration(self) -> tuple:
        """The calibration buffers every step reads: (Ps, K, dist, M, F)."""
        return (self._Ps, self._K, self._dist, self._M, self._F)

    def _build_steps(self) -> dict:
        """One compiled step for each kind of frame this engine takes, over
        the tracker state ``_kalman_state`` and the calibration buffers,
        each captured at its first frame.  A mesh across processes has
        none: its step runs op by op (``_step``)."""
        rig, cfg, dev = self.rig, self.cfg, self.device
        C, K = rig.num_cameras, cfg.max_blobs
        H, W = rig.image_hw()
        state, cal = self._kalman_state, self._calibration()
        if self._mesh is not None:
            return {} if self._mesh.distributed else self._mesh_steps()

        def frame_kind(name, payload, **ingest):
            return compiled.CompiledStep(
                functools.partial(_frame_row, **self._step_kw, **ingest),
                state, payload, _f32((), dev), *cal, name=name)

        if self._batch > 1:
            return {"batched": _ScanStep(
                state, _f32((self._batch, C, K, 3), dev),
                _f32((self._batch,), dev), cal, self._tail_kw, C * K)}
        if self._host_detect:
            return {"blobs": compiled.CompiledStep(
                functools.partial(_tail_row, **self._tail_kw), state,
                _f32((C, K, 3), dev), _f32((), dev), *cal, name="blobs")}
        if self._fast:
            return {"sparse": frame_kind(
                        "sparse", torch.zeros(cfg.sparse_budget,
                                              dtype=torch.int32, device=dev),
                        sparse_input=True, image_shape=(C, H, W)),
                    "packed": frame_kind(
                        "packed", torch.zeros((C, H, W // 8),
                                              dtype=torch.uint8, device=dev),
                        packed_input=True)}
        return {"dense": frame_kind("dense", torch.zeros(
            (C, H, W), dtype=torch.uint8, device=dev))}

    def _mesh_steps(self) -> dict:
        """The camera-sharded step, per frame ("mesh") or batched: each
        shard's packed frames in a buffer on its device.  One step over
        every shard when they all lie on the engine's device; else a
        ``_ShardedStep``."""
        rig, cfg, dev, B = self.rig, self.cfg, self.device, self._batch
        C, K = rig.num_cameras, cfg.max_blobs
        H, W = rig.image_hw()
        state, cal = self._kalman_state, self._calibration()
        shards = self._mesh.axis_shards("cam")
        lead = (B,) if B > 1 else ()
        bufs = tuple(torch.zeros(lead + (C // len(shards), H, W // 8),
                                 dtype=torch.uint8, device=sdev)
                     for _, sdev in shards)
        kw = dict(mesh=self._mesh, cfg=cfg)
        if all(_same_device(sdev, dev) for _, sdev in shards):
            if B > 1:
                return {"batched": _ScanStep(
                    state, bufs, _f32((B,), dev), cal, self._tail_kw, C * K,
                    head=functools.partial(_mesh_scan_rows, **kw))}
            return {"mesh": compiled.CompiledStep(
                functools.partial(_mesh_row, **kw, **self._tail_kw), state,
                bufs, _f32((), dev), *cal, name="mesh")}
        if B > 1:
            tail = _ScanStep(state, _f32((B, C, K, 3), dev), _f32((B,), dev),
                             cal, self._tail_kw, C * K)
        else:
            tail = compiled.CompiledStep(
                functools.partial(_tail_row, **self._tail_kw), state,
                _f32((C, K, 3), dev), _f32((), dev), *cal, name="mesh tail")
        return {"batched" if B > 1 else "mesh": _ShardedStep(
            [sdev for _, sdev in shards], bufs, tail, cfg, dim=len(lead))}

    def _apply_rig(self, rig: RigConfig) -> None:
        """Serve ``rig`` (new body templates) from the next frame on: a new
        row layout and readback ring and a fresh tracker state; the rows
        and frames still pending in the old layout are dropped.  A batch
        the emit worker has already taken decodes with the ring and layout
        it was read with."""
        with self._model_lock:
            old, old_steps = self._row_ring, self._steps
            self.rig = rig
            # new state buffers (the body sets change) and new steps over
            # them, captured at their first frame
            self._kalman_state = make_init_state(rig, device=self.device)
            self._configure_step()
            self._pending.clear()
            self._batch_slot = None
            self._batch_dts = []
            # copies into the dropped rows may still be in flight: the old
            # ring's page-locked buffers, and the old graphs' rows they
            # copy, must outlive them
            for i in range(len(old.bufs)):
                old.wait(i)
            del old_steps
            self._batch_cond.notify_all()

    # ------------------------------------------------------------ events

    def on(self, event: str, cb: Callable[[Any], None]) -> None:
        self._listeners.setdefault(event, []).append(cb)

    def off(self, event: str, cb: Callable[[Any], None]) -> None:
        """Remove a listener added with ``on`` (an unknown cb is a no-op).
        The server detaches its fan-out while no client is connected, which
        gates payload construction off (``_emit_frame_outputs``)."""
        cbs = self._listeners.get(event)
        if cbs is not None:
            try:
                cbs.remove(cb)
            except ValueError:
                pass

    def emit(self, event: str, data: Any) -> None:
        # a snapshot: server threads attach and detach listeners while the
        # capture loop emits
        for cb in tuple(self._listeners.get(event, ())):
            cb(data)

    # ---------------------------------------------------- client handlers
    # One method per reference Socket.IO event.

    def handle(self, event: str, data: Any) -> None:
        fn = getattr(self, "handle_" + event.replace("-", "_"), None)
        if fn is None:
            raise KeyError(f"unknown event {event!r}")
        fn(data if data is not None else {})

    def handle_update_camera_settings(self, data):
        # computer_code/api/index.py:212-216
        self.source.set_settings(data["exposure"], data["gain"])

    def handle_capture_points(self, data):
        # computer_code/api/index.py:218-227
        if data["startOrStop"] == "start":
            self.captured_points = []
            self.is_capturing_points = True
        else:
            self.flush_batches()   # emit in-flight pipelined outputs
            self.is_capturing_points = False

    def handle_locate_objects(self, data):
        # computer_code/api/index.py:279-288
        self.is_locating_objects = data["startOrStop"] == "start"

    def handle_triangulate_points(self, data):
        # computer_code/api/index.py:312-323
        if data["startOrStop"] == "start":
            Rs, ts = serializable_to_camera_poses(data["cameraPoses"])
            self.set_camera_poses(Rs, ts)
            if data.get("toWorldCoordsMatrix") is not None:
                self.set_to_world_matrix(
                    np.asarray(data["toWorldCoordsMatrix"], np.float32))
            with self._model_lock:
                # into the state buffers the compiled steps read
                compiled.assign(self._kalman_state,
                                make_init_state(self.rig, device=self.device))
                self._pending.clear()      # pre-reset in-flight readbacks
                self._batch_slot = None    # pre-reset buffered frames
                self._batch_dts = []
            self.is_capturing_points = True
            self.is_triangulating_points = True
        else:
            # emit in-flight pipelined outputs BEFORE dropping the mode
            # flags, so the stream ends complete
            self.flush_batches()
            self.is_capturing_points = False
            self.is_triangulating_points = False

    def handle_calculate_camera_pose(self, data):
        # computer_code/api/index.py:229-277
        raw = data["cameraPoints"]   # (frames, cameras, 2) with None entries
        C = self.rig.num_cameras
        pts = np.zeros((len(raw), C, 2), np.float32)
        mask = np.zeros((len(raw), C), bool)
        for f, per_cam in enumerate(raw):
            for c, p in enumerate(per_cam):
                if p is not None and p[0] is not None:
                    pts[f, c] = p
                    mask[f, c] = True

        def progress(Rs_i, ts_i, iters_done):
            # intermediate poses between BA chunks, as the reference streams
            # them on every residual evaluation
            self.emit("camera-pose", {
                "error": None,
                "camera_poses": camera_poses_to_serializable(Rs_i, ts_i),
                "ba_iters": int(iters_done),
            })

        # seeded afresh for every capture, as the JAX engine's PRNGKey(0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        res = calibrator.calibrate(
            torch.as_tensor(pts, device=self.device),
            torch.as_tensor(mask, device=self.device), self._K,
            ransac_iters=self.cfg.ransac_iters,
            threshold_px=self.cfg.ransac_threshold_px,
            ba_iters=self.cfg.ba_max_iters, progress_cb=progress,
            generator=gen)
        Rs, ts = res.Rs.cpu().numpy(), res.ts.cpu().numpy()
        self.set_camera_poses(Rs, ts)
        self.emit("camera-pose", {
            "error": float(res.mean_error),
            "camera_poses": camera_poses_to_serializable(Rs, ts),
        })

    def handle_determine_scale(self, data):
        # computer_code/api/index.py:290-309
        pairs = np.asarray([p for p in data["objectPoints"] if len(p) == 2],
                           np.float32)
        Rs, ts = serializable_to_camera_poses(data["cameraPoses"])
        _, ts2 = world.determine_scale(
            torch.as_tensor(pairs, device=self.device),
            torch.as_tensor(ts, device=self.device),
            wand_length=self.rig.wand_length)
        ts2 = ts2.cpu().numpy()
        self.set_camera_poses(Rs, ts2)
        self.emit("camera-pose", {
            "error": None,
            "camera_poses": camera_poses_to_serializable(Rs, ts2),
        })

    def handle_acquire_floor(self, data):
        # computer_code/api/index.py:158-194, with the levelling rotation
        # applied consistently (ops/world.py:fit_floor)
        pts = np.asarray([p for sub in data["objectPoints"] for p in sub],
                         np.float32)
        M = world.fit_floor(torch.as_tensor(pts, device=self.device),
                            torch.as_tensor(self.to_world_matrix,
                                            device=self.device)).cpu().numpy()
        self.set_to_world_matrix(M)
        self.emit("to-world-coords-matrix",
                  {"to_world_coords_matrix": M.tolist()})

    def handle_set_origin(self, data):
        # computer_code/api/index.py:197-210
        M = world.set_origin(
            torch.as_tensor(np.asarray(data["objectPoint"], np.float32),
                            device=self.device),
            torch.as_tensor(np.asarray(data["toWorldCoordsMatrix"],
                                       np.float32),
                            device=self.device)).cpu().numpy()
        self.set_to_world_matrix(M)
        self.emit("to-world-coords-matrix",
                  {"to_world_coords_matrix": M.tolist()})

    def handle_refine_camera_pose(self, data):
        """Live recalibration from the matcher's observations collected
        while tracking runs.

        start: collect the winners' observations of every served frame's
        valid points.  stop: bundle-adjust the extrinsics (focals pinned)
        from the current poses over the collected points, keep camera 0's
        absolute pose and the total baseline length, apply, and emit
        ``camera-pose`` with the refined error."""
        if data["startOrStop"] == "start":
            with self._live_lock:
                self._refine_obs = []
            return
        with self._live_lock:
            obs_frames, self._refine_obs = self._refine_obs, None
        if self.camera_poses is None:
            self.emit("camera-pose", {"error": None,
                                      "refine_error": "not calibrated"})
            return
        C = self.rig.num_cameras
        pts = (np.concatenate([o for o, _ in obs_frames])
               if obs_frames else np.zeros((0, C, 2), np.float32))
        msk = (np.concatenate([m for _, m in obs_frames])
               if obs_frames else np.zeros((0, C), bool))
        keep = msk.sum(axis=1) >= 2
        pts, msk = pts[keep], msk[keep]
        if len(pts) < 24:
            self.emit("camera-pose", {
                "error": None,
                "refine_error": f"only {len(pts)} usable points"})
            return
        Rs0, ts0 = self.camera_poses
        # BA anchors camera 0 at identity: gauge the poses into camera 0's
        # frame, refine, and un-gauge, so that camera 0's absolute pose (and
        # the world matrix made under it) stays the anchor
        R0, t0 = np.asarray(Rs0[0]), np.asarray(ts0[0]).reshape(3)
        Rs_g = np.einsum("cij,kj->cik", np.asarray(Rs0), R0)   # R_i R0ᵀ
        ts_g = (np.asarray(ts0).reshape(-1, 3)
                - np.einsum("cij,j->ci", Rs_g, t0))
        dev = self.device
        pts_t = torch.as_tensor(pts, device=dev)
        msk_t = torch.as_tensor(msk, device=dev)
        K = self._K
        res = ba_ops.bundle_adjust(
            pts_t, msk_t, K, torch.as_tensor(Rs_g.astype(np.float32),
                                             device=dev),
            torch.as_tensor(ts_g.astype(np.float32), device=dev),
            num_cameras=C, max_iters=self.cfg.ba_max_iters,
            ftol=self.cfg.ba_ftol, freeze_focals=True)
        Rg, tg = res.Rs.cpu().numpy(), res.ts.cpu().numpy()
        # the free-point BA's scale gauge is re-anchored, so the wand's
        # metric scale cannot drift over repeated refinements
        norm0 = float(np.linalg.norm(ts_g[1:], axis=-1).sum())
        norm1 = float(np.linalg.norm(tg[1:], axis=-1).sum())
        if norm1 > 1e-9 and norm0 > 1e-9:
            tg = tg * (norm0 / norm1)
        Rs = np.einsum("cij,jk->cik", Rg, R0)
        ts = tg + np.einsum("cij,j->ci", Rg, t0)
        Ps = cam_ops.projection_matrix(
            K, torch.as_tensor(Rs, device=dev),
            torch.as_tensor(ts.astype(np.float32), device=dev))
        X, _ = tri_ops.triangulate_points(pts_t, Ps, msk_t)
        errs = tri_ops.reprojection_errors(pts_t, X, Ps, msk_t)
        mean_err = float(np.sqrt(np.mean(errs.cpu().numpy())))
        self.set_camera_poses(Rs, ts)
        self.emit("camera-pose", {
            "error": mean_err,
            "camera_poses": camera_poses_to_serializable(Rs, ts),
            "refined_from_points": int(len(pts)),
        })

    def handle_learn_body_template(self, data):
        """Learn a rigid-body template from the served points
        (``ops/rigid_general.learn_template``, on the engine's device).

        start: collect every triangulated frame's points.  stop: learn and
        emit ``body-template`` {markers, frames_used}; with ``apply``, track
        the learned template from the next frame on (``maxBodies``
        instances, default ``rig.max_bodies``)."""
        if data["startOrStop"] == "start":
            with self._live_lock:
                self._learning_frames = []
            return
        with self._live_lock:
            frames, self._learning_frames = self._learning_frames, None
        if not frames:
            self.emit("body-template", {"error": "no frames captured"})
            return
        try:
            tmpl = learn_template(np.stack([f[0] for f in frames]),
                                  np.stack([f[1] for f in frames]),
                                  device=self.device)
        except ValueError as e:
            self.emit("body-template", {"error": str(e)})
            return
        payload = {"markers": [list(m) for m in tmpl.markers],
                   "frames_used": len(frames), "error": None}
        if data.get("apply"):
            self._apply_rig(dataclasses.replace(
                self.rig, body_markers=tmpl.markers,
                max_bodies=int(data.get("maxBodies", self.rig.max_bodies))))
            payload["applied"] = True
        self.emit("body-template", payload)

    def handle_record_frames(self, data):
        """Record the raw camera stream to a replayable .npz
        (``utils/recordings.py``, replayed by ``RecordedSource``).  start:
        keep every frame set read, up to ``maxFrames`` (default 600); stop:
        save to ``path`` (default: a timestamped file in the artifacts or
        temporary directory) and emit ``recording`` {path, frames}."""
        if data["startOrStop"] == "start":
            with self._frame_lock:
                self._recording_cap = int(data.get("maxFrames", 600))
                self._recording = []
            return
        # swapped under the frame lock, which the capture thread appends
        # under, so no append lands while the frames are stacked
        with self._frame_lock:
            frames, self._recording = self._recording, None
        if not frames:
            self.emit("recording", {"error": "no frames recorded"})
            return
        path = data.get("path") or os.path.join(
            self.artifacts_dir or tempfile.gettempdir(),
            f"recording-{int(time.time())}.npz")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_recording(path, np.stack(frames), fps=max(self.fps, 1.0),
                       meta={"num_cameras": self.rig.num_cameras})
        self.emit("recording",
                  {"path": path, "frames": len(frames), "error": None})

    def handle_capture_profile(self, data):
        """Trace the serving loop with ``torch.profiler`` for ``durationMs``
        (default 500) from a thread of its own while the capture loop goes
        on (``utils/profiling.device_trace``: the card's kernels, whichever
        thread launched them, on a CUDA engine; the profiler starts and
        stops under the model lock, which the step's launches hold).  Emits
        ``profile`` with the Chrome trace's path, or with ``error`` when the
        profiler cannot start (one is already running) or lost the kernel
        records."""
        duration_s = float(data.get("durationMs", 500)) / 1e3
        log_dir = data.get("path") or os.path.join(
            self.artifacts_dir or tempfile.gettempdir(), "profiles",
            f"trace-{int(time.time())}")
        os.makedirs(log_dir, exist_ok=True)

        def capture():
            try:
                with profiling.device_trace(log_dir, self.device,
                                            self._model_lock) as path:
                    time.sleep(duration_s)
            except Exception as e:   # reported to the client
                self.emit("profile", {"error": str(e)})
                return
            self.emit("profile", {"path": path,
                                  "durationMs": duration_s * 1e3,
                                  "error": None})

        threading.Thread(target=capture, daemon=True,
                         name="lcm-profile").start()

    def handle_calibrate_intrinsics(self, data):
        """Intrinsic calibration from a handheld dot-grid target
        (``ops/intrinsics.py``, Zhang's method).

        start: ``{"startOrStop": "start", "cameraIndex": c, "rows": r,
        "cols": k, "spacing": m}``; every frame in which camera ``c`` sees
        exactly r*k blobs that order into a grid, with the board moved
        since the last view kept, is kept as a view (``intrinsics-views``
        events).  stop: calibrate over the views, emit
        ``camera-intrinsics`` ``{K, dist, rms_px, views}``, apply to the rig
        (unless ``"apply": false``) and persist."""
        if data["startOrStop"] == "start":
            rows = int(data.get("rows", 4))
            cols = int(data.get("cols", 5))
            spacing = float(data.get("spacing", 0.03))
            self._intrinsics_capture = {
                "camera": int(data.get("cameraIndex", 0)),
                "rows": rows, "cols": cols, "spacing": spacing,
                "board": intrinsics.make_grid(rows, cols, spacing),
                "min_sep_px": float(data.get("minSeparationPx", 8.0)),
                "max_views": int(data.get("maxViews", 40)),
                "views": [],
            }
            return
        cap, self._intrinsics_capture = self._intrinsics_capture, None
        if cap is None or len(cap["views"]) < 3:
            n = 0 if cap is None else len(cap["views"])
            self.emit("camera-intrinsics", {
                "error": f"only {n} usable views captured (need >= 3); "
                         "move the board through varied tilts"})
            return
        res = intrinsics.calibrate_intrinsics(cap["board"],
                                              np.stack(cap["views"]),
                                              device=self.device)
        K = res.K.cpu().numpy().astype(np.float64)
        dist = res.dist.cpu().numpy().astype(np.float64)
        if not (np.isfinite(K).all() and np.isfinite(dist).all()):
            self.emit("camera-intrinsics",
                      {"error": "calibration diverged; recapture"})
            return
        payload = {
            "cameraIndex": cap["camera"],
            "K": K.tolist(),
            "dist": dist.tolist(),
            "rms_px": float(res.rms_px),
            "views": len(cap["views"]),
            "error": None,
        }
        if data.get("apply", True):
            self._apply_intrinsics(cap["camera"], K, dist)
            payload["applied"] = True
        self.emit("camera-intrinsics", payload)

    def _intrinsics_step(self, frames: np.ndarray) -> None:
        """Per-frame hook of calibrate-intrinsics: native host detection on
        the target camera (with a budget of rows*cols + 8 blobs, whatever
        ``max_blobs``), grid ordering, and a movement gate."""
        cap = self._intrinsics_capture
        if cap is None or len(cap["views"]) >= cap["max_views"]:
            return
        c, rows, cols = cap["camera"], cap["rows"], cap["cols"]
        n = rows * cols
        try:
            blobs, valid, _ = bindings.ingest_detect(
                np.ascontiguousarray(frames[c:c + 1]),
                threshold_cutoff(self.cfg.detect_threshold), n + 8,
                weighted=self.cfg.weighted_centroids)
        except RuntimeError as e:     # the native library did not build
            self._intrinsics_capture = None
            self.emit("camera-intrinsics",
                      {"error": f"native detector unavailable: {e}"})
            return
        pts = blobs[0][valid[0].astype(bool)]
        if len(pts) != n:
            return
        order, _ = intrinsics.order_grid(pts, rows, cols)
        if order is None:
            return
        ordered = pts[order].astype(np.float32)
        if cap["views"]:
            sep = float(np.linalg.norm(
                ordered - cap["views"][-1], axis=-1).mean())
            if sep < cap["min_sep_px"]:
                return                      # the board has not moved enough
        cap["views"].append(ordered)
        self.emit("intrinsics-views",
                  {"camera": c, "views": len(cap["views"])})

    def _apply_intrinsics(self, camera_index: int, K: np.ndarray,
                          dist: np.ndarray) -> None:
        """Install one camera's calibrated intrinsics: the rig, K and dist
        on the device, the projection matrices and pairwise fundamentals,
        and the persisted artifact."""
        cams = list(self.rig.cameras)
        cams[camera_index] = CameraIntrinsics(
            intrinsic_matrix=tuple(tuple(float(x) for x in row)
                                   for row in K),
            distortion_coef=tuple(float(x) for x in dist),
            rotation=cams[camera_index].rotation)
        rig = dataclasses.replace(self.rig, cameras=tuple(cams))
        K_dev = torch.as_tensor(rig.K_stack(), device=self.device)
        dist_dev = torch.as_tensor(rig.dist_stack(), device=self.device)
        parts = dict(K=K_dev, dist=dist_dev)
        if self.camera_poses is not None:
            Rs, ts = self.camera_poses
            parts["Ps"] = cam_ops.projection_matrix(
                K_dev, torch.as_tensor(np.asarray(Rs, np.float32),
                                       device=self.device),
                torch.as_tensor(np.asarray(ts, np.float32),
                                device=self.device))
            parts["F"] = correspond._pairwise_fundamentals(parts["Ps"])
        with self._model_lock:
            self.rig = rig
            self.set_calibration(**parts)
        self._save_intrinsics_artifact()

    def _save_intrinsics_artifact(self) -> None:
        if not self.artifacts_dir:
            return
        os.makedirs(self.artifacts_dir, exist_ok=True)
        artifacts.save_intrinsics(
            os.path.join(self.artifacts_dir, "intrinsics.json"),
            self.rig.cameras)

    def handle_run_trajectory(self, data):
        """Fly a planned trajectory with the reference's fly-to-start gate:
        command every drone to the plan's first setpoint and hold until
        each tracked position is within ``arrivalTol`` metres, then drip
        the setpoints at ``timestep`` cadence, one tick per processed
        frame.  Emits ``trajectory-status``: fly-to-start -> executing ->
        done (or aborted / stopped)."""
        if data.get("startOrStop") == "stop":
            with self._live_lock:
                if self._traj is not None:
                    self._traj = None
                    self.emit("trajectory-status", {"phase": "stopped"})
            return
        sps = [[float(x) for x in sp] for sp in data["setpoints"]]
        n = self.rig.num_objects
        if not sps or any(len(sp) != 3 * n for sp in sps):
            raise ValueError(
                f"setpoints must be non-empty rows of {3 * n} floats")
        timestep = float(data.get("timestep", 0.05))
        if not timestep > 0.0:
            raise ValueError(f"timestep must be positive, got {timestep}")
        drones = [int(d) for d in data.get("droneIndices", range(n))]
        if any(not 0 <= d < n for d in drones):
            raise ValueError(f"droneIndices out of range 0..{n - 1}: {drones}")
        with self._live_lock:
            self._traj = {
                "setpoints": sps,
                "timestep": timestep,
                "drones": drones,
                "tol": float(data.get("arrivalTol", 0.15)),
                "timeout": float(data.get("arrivalTimeout", 20.0)),
                "phase": "fly-to-start", "t": 0.0, "idx": -1,
                "wait": 0.0, "resend": 0.0,
            }
            for d in drones:
                self.link.send(d, {"setpoint": sps[0][3 * d:3 * d + 3]})
            self.emit("trajectory-status",
                      {"phase": "fly-to-start", "setpoints": len(sps)})

    def _advance_trajectory(self, out, dt: float) -> None:
        """One tick of the run-trajectory state machine, per processed
        frame; ``out`` gives the tracked positions for the arrival gate."""
        if self._traj is None:
            return
        with self._live_lock:
            tr = self._traj
            if tr is None:
                return
            sps = tr["setpoints"]
            if tr["phase"] == "fly-to-start":
                tr["wait"] += dt
                tr["resend"] += dt
                tv, tp = out.tracked.valid, out.tracked.pos
                arrived = True
                for d in tr["drones"]:
                    target = np.asarray(sps[0][3 * d:3 * d + 3])
                    if not (d < len(tv) and tv[d]):
                        arrived = False
                        break
                    # engine world [x, up, z] -> firmware [x, y, alt], the
                    # mapping of the armed pose feed
                    fw = np.array([tp[d][0], tp[d][2], tp[d][1]])
                    if np.linalg.norm(fw - target) > tr["tol"]:
                        arrived = False
                        break
                if self._traj is not tr:   # stopped or replaced mid-tick
                    return
                if arrived:
                    tr["phase"] = "executing"
                    tr["t"] = 0.0
                    tr["idx"] = 0          # the gate itself asserted sps[0]
                    self.emit("trajectory-status",
                              {"phase": "executing",
                               "waited_s": round(tr["wait"], 3)})
                elif tr["wait"] > tr["timeout"]:
                    self._traj = None
                    self.emit("trajectory-status",
                              {"phase": "aborted",
                               "reason": "fly-to-start timeout"})
                elif tr["resend"] >= 0.5:
                    # keep asserting the start setpoint
                    tr["resend"] = 0.0
                    for d in tr["drones"]:
                        self.link.send(
                            d, {"setpoint": sps[0][3 * d:3 * d + 3]})
                return
            tr["t"] += dt
            # drip every index up to the elapsed-time target: never skip a
            # setpoint to float accumulation (dt == timestep sends them all)
            target = min(int(tr["t"] / tr["timestep"] + 1e-6), len(sps) - 1)
            while tr["idx"] < target:
                if self._traj is not tr:   # stopped or replaced mid-tick
                    return
                tr["idx"] += 1
                for d in tr["drones"]:
                    self.link.send(
                        d, {"setpoint": sps[tr["idx"]][3 * d:3 * d + 3]})
            if tr["idx"] >= len(sps) - 1 and self._traj is tr:
                self._traj = None
                self.emit("trajectory-status", {"phase": "done"})

    def handle_arm_drone(self, data):
        # computer_code/api/index.py:114-128
        self.drone_armed = list(data["droneArmed"])
        for i in range(self.rig.num_objects):
            self.link.send(i, {"armed": bool(self.drone_armed[i])})

    def handle_set_drone_pid(self, data):
        # computer_code/api/index.py:130-137
        self.link.send(int(data["droneIndex"]),
                       {"pid": [float(x) for x in data["dronePID"]]})

    def handle_set_drone_setpoint(self, data):
        # computer_code/api/index.py:139-146
        self.link.send(int(data["droneIndex"]),
                       {"setpoint": [float(x)
                                     for x in data["droneSetpoint"]]})

    def handle_set_drone_trim(self, data):
        # computer_code/api/index.py:148-155
        self.link.send(int(data["droneIndex"]),
                       {"trim": [int(x) for x in data["droneTrim"]]})

    def _on_link_health(self, health: dict) -> None:
        if health.get("state") == "stalled" and any(self.drone_armed):
            self.drone_armed = [False] * len(self.drone_armed)
            health = dict(health, disarmed=True)
        self.emit("link-health", health)

    # ------------------------------------------------------------- state

    def set_camera_poses(self, Rs: np.ndarray, ts: np.ndarray) -> None:
        Ps = cam_ops.projection_matrix(
            self._K, torch.as_tensor(np.asarray(Rs, np.float32),
                                     device=self.device),
            torch.as_tensor(np.asarray(ts, np.float32), device=self.device))
        # the pairwise fundamentals change only with the calibration
        F = correspond._pairwise_fundamentals(Ps)
        with self._model_lock:
            self.camera_poses = (Rs, ts)
            self.set_calibration(Ps=Ps, F=F)
        self._save_calibration_artifact()

    def set_to_world_matrix(self, M: np.ndarray) -> None:
        M = np.asarray(M, np.float32)
        M_dev = torch.as_tensor(M, device=self.device)
        with self._model_lock:
            self.to_world_matrix = M
            self.set_calibration(M=M_dev)
        self._save_calibration_artifact()

    def set_calibration(self, *, Ps=None, K=None, dist=None, M=None,
                        F=None) -> None:
        """Copy new calibration tensors into the buffers the compiled steps
        read, in place, on the stream the steps run on, so that the next
        frame uses them (the caller holds the model lock).  Rebinding the
        buffers instead would leave a captured graph reading the old
        ones."""
        for name, new in (("_Ps", Ps), ("_K", K), ("_dist", dist),
                          ("_M", M), ("_F", F)):
            if new is not None:
                compiled.assign(getattr(self, name), new)
        self._cal_version += 1

    def _save_calibration_artifact(self) -> None:
        """Persist the calibration server-side (the reference keeps the
        extrinsics and world matrix as browser state only)."""
        if not self.artifacts_dir or self.camera_poses is None:
            return
        os.makedirs(self.artifacts_dir, exist_ok=True)
        Rs, ts = self.camera_poses
        artifacts.save_calibration(
            os.path.join(self.artifacts_dir, "calibration.json"),
            artifacts.Calibration(Rs=np.asarray(Rs), ts=np.asarray(ts),
                                  focals=None,
                                  to_world_matrix=self.to_world_matrix))

    def _load_calibration_artifact(self) -> None:
        path = os.path.join(self.artifacts_dir, "calibration.json")
        if not os.path.exists(path):
            return
        calib = artifacts.load_calibration(path)
        self.set_camera_poses(calib.Rs, calib.ts)
        self.set_to_world_matrix(calib.to_world_matrix)

    def _load_intrinsics_artifact(self, rig: RigConfig) -> RigConfig:
        path = os.path.join(self.artifacts_dir, "intrinsics.json")
        if not os.path.exists(path):
            return rig
        cams = artifacts.load_intrinsics(path)
        if len(cams) != rig.num_cameras:
            return rig                      # stale artifact, rig changed
        return dataclasses.replace(rig, cameras=cams)

    # -------------------------------------------------------------- loop

    def _start_emit_worker(self) -> None:
        self._emit_worker = threading.Thread(
            target=self._emit_worker_loop, daemon=True,
            name="lcm-batch-emit")
        self._emit_worker.start()

    def start(self) -> None:
        if self._running:
            return
        if (self.cfg.batch_emit_thread and self._batch > 1
                and self._emit_worker is None):
            self._start_emit_worker()   # again after a stop()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.flush_batches()
        worker = self._emit_worker
        if worker is not None:
            with self._batch_cond:
                self._emit_worker = None    # the worker exits once drained
                self._batch_cond.notify_all()
            worker.join(timeout=5)

    def flush_batches(self) -> None:
        """Decode and emit, in order, every output whose readback is still
        pending (pipelined batches, and pipelined per-frame rows), so the
        output stream is complete.  Called at ``stop()`` and when capture
        stops.  Frames still filling a batch are not dispatched: batched
        mode emits whole batches only.  With the emit worker this waits for
        the worker to drain instead."""
        if self._emit_worker is not None:
            with self._batch_cond:
                while self._pending or self._emit_worker_busy:
                    self._batch_cond.wait(timeout=0.1)
            return
        while self._retire() is not None:
            pass

    def _emit_worker_loop(self) -> None:
        """batch_emit_thread worker: pop dispatched batches in order, wait
        for their readback event, decode and emit — off the capture loop,
        and without launching anything on the card."""
        while True:
            with self._batch_cond:
                while not self._pending:
                    if self._emit_worker is None:   # stop() requested
                        return
                    self._batch_cond.wait(timeout=0.2)
                item = self._pending.popleft()
                self._emit_worker_busy = True
                self._batch_cond.notify_all()       # release backpressure
            try:
                self._retire(item, taken=True)
            except Exception as e:   # a bad batch must not wedge the drain
                self.emit("engine-error",
                          {"error": f"batch emit worker: {e}"})
            finally:
                with self._batch_cond:
                    self._emit_worker_busy = False
                    self._batch_cond.notify_all()   # flush_batches waiters

    def _loop(self) -> None:
        interval = 1.0 / self.cfg.target_fps
        last = time.monotonic()
        consecutive_errors = 0
        while self._running:
            now = time.monotonic()
            if now - last < interval:
                time.sleep(last + interval - now)
            dt = max(time.monotonic() - last, 1e-4)
            last = time.monotonic()
            try:
                with self.timer.stage("read"):
                    frames = self.source.read()
                with self.timer.stage("process"):
                    self.process_frame(frames, dt)
                consecutive_errors = 0
            except Exception as e:
                # a camera hiccup or a transient device error must not kill
                # the capture loop
                consecutive_errors += 1
                self.emit("engine-error",
                          {"error": str(e), "count": consecutive_errors})
                if consecutive_errors >= 50:
                    self.emit("engine-error",
                              {"error": "too many consecutive failures; "
                                        "stopping capture", "fatal": True})
                    self.is_capturing_points = False
                    consecutive_errors = 0
                time.sleep(0.05)
                continue
            self.frame_count += 1
            self.fps = 0.9 * self.fps + 0.1 * (1.0 / dt)
            if self.frame_count % 10 == 0:
                self.emit("fps", {"fps": round(self.fps)})
            if self.frame_count % 120 == 0:
                self.emit("metrics", self.timer.summary())

    # -------------------------------------------------------------- frames

    def _readback(self, rows: torch.Tensor) -> _Readback:
        """Enqueue the copy of a packed row (or (B, L) rows) into the next
        host slot, with its event after it (under the model lock)."""
        ring = self._row_ring
        i = ring.acquire()
        ring.bufs[i].copy_(rows, non_blocking=True)
        ring.fence(i)
        return _Readback(ring, i, self._layout, self._body_set_of_slot)

    @staticmethod
    def _decode(rb: _Readback) -> list:
        """The readback's rows, once its event has completed, decoded with
        the layout they were written in: one FrameOutputs a row."""
        rb.ring.wait(rb.slot)
        # a copy: the slot is reused
        rows = rb.ring.bufs[rb.slot].numpy().copy()
        return unpack_outputs_batch(rows.reshape(-1, rows.shape[-1]),
                                    *rb.layout)

    def _ingest_host_detect(self, frames: np.ndarray, slot: int,
                            index=()) -> None:
        """Native threshold + pack + connected components straight into an
        ingest slot (row ``index`` of a batch slot)."""
        buf = self._ingest_ring.bufs[slot][index]
        bindings.ingest_detect_packed(
            frames, self._cutoff, self.cfg.max_blobs,
            weighted=self.cfg.weighted_centroids, out=buf.numpy())

    def process_frame(self, frames: np.ndarray, dt: float):
        """One (C, H, W) uint8 frame set through the step and the
        reference-shaped emits.  Returns the decoded FrameOutputs (numpy
        leaves) of the newest frame whose readback completed, or None while
        not capturing, while a batch fills, or while the pipeline fills."""
        with self._frame_lock:
            self._last_frames = frames
            # record-frames swaps the list under this lock; always a copy,
            # since a source may reuse its read buffer
            rec = self._recording
            if rec is not None and len(rec) < self._recording_cap:
                rec.append(np.array(frames, np.uint8))

        if self.health is not None:
            # frozen-transport detection on the raw stream (the recording
            # keeps it unmasked); a frozen camera
            # is masked below and rejoins when its frames move again
            for cam, status in self.health.update(frames):
                self.emit("camera-health",
                          {"camera": int(cam), "status": status})

        if self._intrinsics_capture is not None:
            # dot-grid capture for calibrate-intrinsics: host detection on
            # one camera, whatever the mode flags
            self._intrinsics_step(frames)

        if not self.is_capturing_points:
            return None

        if self.health is not None:
            frozen = self.health.frozen_mask
            if frozen.any():
                # a copy, never the source's buffer (RecordedSource returns
                # views of its array); zeroed frames give no blobs on every
                # ingest path
                frames = frames.copy()
                frames[frozen] = 0

        dt32 = np.float32(dt)
        if self._batch > 1:
            return self._run_batched(frames, dt32)

        # the payload stays on the host: the step copies it into its
        # buffer on the card (from the page-locked ingest ring without
        # blocking), then replays
        slot = None
        with self.timer.stage("ingest"):
            if self._mesh is not None:
                # 1-bit packed on the host, shard by shard; the step
                # uploads each shard's part to its device
                slot = self._ingest_ring.acquire()
                self._ingest_mesh(frames, slot)
                payload = self._ingest_ring.bufs[slot]
                kind = "mesh"
            elif self._host_detect:
                slot = self._ingest_ring.acquire()
                self._ingest_host_detect(frames, slot)
                payload = self._ingest_ring.bufs[slot]
                kind = "blobs"
            elif self._fast:
                idx, ok, packed = sparse_ingest(
                    frames, self.cfg.detect_threshold, self.cfg.sparse_budget)
                # the dense 1-bit bitmap is exact when the budget overflows
                kind = "sparse" if ok else "packed"
                payload = torch.from_numpy(idx if ok else packed)
            else:
                kind = "dense"
                payload = torch.from_numpy(np.ascontiguousarray(frames))

        with self._model_lock:
            with self.timer.stage("step"):
                self._kalman_state, row = self._step(kind, payload, dt32)
                if slot is not None:
                    self._ingest_ring.fence(slot)
                # the row is the graph's: its copy is enqueued before the
                # next replay overwrites it
                rb = self._readback(row)
        # each row keeps its own frame's dt for the trajectory tick
        return self._retire((rb, [dt]))

    def _ingest_mesh(self, frames: np.ndarray, slot: int,
                     row: int | None = None) -> None:
        """1-bit pack a frame set into an ingest slot (into row ``row`` of
        each shard's part of a batch slot), shard by shard."""
        buf = self._ingest_ring.bufs[slot].numpy()
        if row is not None:
            buf = buf[:, row]
        buf[...] = pack_frames(frames, self.cfg.detect_threshold).reshape(
            buf.shape)

    def _step(self, kind: str, payload: torch.Tensor, dt32):
        """One frame's step on the device (under the model lock): (the
        state, its packed row).  A mesh payload is the (d, C/d, H, W/8)
        ingest slot: its shards go to the compiled step, or whole to the
        op-by-op step of a mesh across processes."""
        cal = self._calibration()
        if kind == "mesh" and self._mesh.distributed:
            state, out = dist_frame_step(
                self._mesh, self._kalman_state,
                payload.reshape(-1, *payload.shape[2:]), dt32, *cal,
                self.rig, self.cfg, packed=True, with_obs=True)
            return state, pack_outputs(out)
        if kind == "mesh":
            payload = tuple(payload)
        return self._steps[kind](self._kalman_state, payload, dt32, *cal)

    def _run_batched(self, frames: np.ndarray, dt32):
        """Batched dispatch: each frame's host detection goes into slot i
        of a page-locked (B, C, K, 3) buffer (in mesh mode, its packed
        frames into row i of a (B, C, H, W/8) buffer); every
        ``dispatch_batch`` frames, one upload and the compiled batched
        program (``_ScanStep``: ``scan_track_from_blobs``, the bank kernel
        once at B; in mesh mode one ``dist_scan_frame_step``), one (B, L)
        readback, pipelined like the per-frame rows.  Returns the newest
        frame's outputs, or None while the batch (or the pipeline)
        fills."""
        with self._model_lock:
            with self.timer.stage("batch-ingest"):
                i = len(self._batch_dts)
                if self._batch_slot is None:
                    self._batch_slot = self._ingest_ring.acquire()
                if self._mesh is not None:
                    self._ingest_mesh(frames, self._batch_slot, i)
                else:
                    self._ingest_host_detect(frames, self._batch_slot, i)
                self._batch_dts.append(dt32)
            if len(self._batch_dts) < self._batch:
                return None
            slot, dl = self._batch_slot, np.asarray(self._batch_dts,
                                                    np.float32)
            self._batch_slot, self._batch_dts = None, []
            with self.timer.stage("batch-dispatch"):
                cal = self._calibration()
                payload = self._ingest_ring.bufs[slot]
                if self._mesh is not None and self._mesh.distributed:
                    # (d, B, C/d, H, W/8) -> (B, C, H, W/8)
                    self._kalman_state, rows = dist_scan_frame_step(
                        self._mesh, self._kalman_state,
                        payload.transpose(0, 1).reshape(
                            payload.shape[1], -1, *payload.shape[3:]),
                        dl, *cal, self.rig, self.cfg, packed=True,
                        with_obs=True)
                else:
                    self._kalman_state, rows = self._steps["batched"](
                        self._kalman_state,
                        tuple(payload) if self._mesh is not None
                        else payload, dl, *cal)
                self._ingest_ring.fence(slot)
                # the readback carries the layout of the rows it reads,
                # the dts go along for the trajectory ticks
                rb = self._readback(rows)
        return self._retire((rb, dl))

    def _retire(self, item=None, *, taken: bool = False):
        """The one way back for served rows, in dispatch order.

        ``item``, a dispatched ``(readback, dts)`` (a per-frame row carries
        ``[dt]``, a batch its B dts), joins the pending queue.  While the
        emit worker runs, the worker takes it from there, and the capture
        loop waits only while more than max(depth, 4) are pending, never on
        a readback.  Otherwise the oldest pending readback is decoded under
        the model lock once ``readback_pipeline_depth`` newer ones follow
        it, so batch N - depth decodes while the card computes batch N; with
        no ``item`` (a flush) at once.  The worker passes the item it has
        ``taken`` off the queue, decoded outside the lock.  The outputs are
        emitted outside the lock.  Returns the newest frame's outputs, or
        None when nothing was emitted."""
        batched = self._batch > 1
        stage = "batch-decode" if batched else "readback"
        if taken:
            rb, dts = item
            with self.timer.stage(stage):
                outs = self._decode(rb)
        else:
            with self._batch_cond:
                depth = 0
                if item is not None:
                    self._pending.append(item)
                    depth = self.cfg.readback_pipeline_depth
                    if self._emit_worker is not None:
                        self._batch_cond.notify_all()
                        while len(self._pending) > max(depth, 4):
                            self._batch_cond.wait(timeout=1.0)
                        return None
                if len(self._pending) <= depth:
                    return None
                rb, dts = self._pending.popleft()
                with self.timer.stage(stage):
                    outs = self._decode(rb)
        with (self.timer.stage("batch-emit") if batched
              else contextlib.nullcontext()):
            return self._emit_batch_outs(outs, dts, rb.set_of_slot)

    def _emit_batch_outs(self, outs: list, dts, set_of_slot):
        """Emit outputs in frame order (outside the model lock), one
        trajectory tick each, and return the newest."""
        for o, dt in zip(outs, dts):
            self._emit_frame_outputs(o, set_of_slot)
            self._advance_trajectory(o, float(dt))
        with self._frame_lock:
            self._last_out = outs[-1]
        return outs[-1]

    def _emit_frame_outputs(self, out, set_of_slot) -> None:
        """Per-frame fan-out: health counters, the mode-gated reference
        emits (image-points / object-points, with the body fits and tracks
        of a rig with templates: ``set_of_slot`` maps each body slot to its
        template), the armed drones' pose feed and the live collections.
        Shared by the per-frame and batched paths."""
        if self.health is not None:
            counts = np.asarray(out.blob_valid).sum(axis=1)
            for cam, status in self.health.update_blobs(counts):
                self.emit("camera-health",
                          {"camera": int(cam), "status": status})

        if self.is_capturing_points and not self.is_triangulating_points:
            # first blob per camera, [None, None] when absent
            # (computer_code/api/helpers.py:91-92)
            blobs, valid = out.blob_px, out.blob_valid
            image_points = [
                blobs[c, 0].tolist() if valid[c, 0] else [None, None]
                for c in range(self.rig.num_cameras)]
            if any(v[0] is not None for v in image_points):
                self.captured_points.append(image_points)
                self.emit("image-points", image_points)
        elif self.is_triangulating_points:
            pv = out.point_valid
            with self._live_lock:
                # learn-body-template keeps every frame's points; live
                # recalibration this frame's valid points' observations
                # (capped, so that a refinement never stopped cannot grow
                # without bound)
                if self._learning_frames is not None:
                    self._learning_frames.append((out.object_points, pv))
                obs = self._refine_obs
                if (obs is not None and pv.any()
                        and sum(len(o) for o, _ in obs) < 4096):
                    obs.append((out.point_obs[pv], out.point_obs_mask[pv]))
            # payloads are built only for listeners; the armed pose feed
            # runs at full rate regardless
            want_payload = bool(self._listeners.get("object-points"))
            objects, filtered = [], []
            if self.is_locating_objects:
                o = out.objects
                if want_payload:
                    for i in np.where(o.valid)[0]:
                        objects.append({
                            "pos": o.pos[i].tolist(),
                            "heading": float(o.heading[i]),
                            "error": float(o.error[i]),
                            "droneIndex": int(o.index[i]),
                        })
                tr = out.tracked
                for d in np.where(tr.valid)[0]:
                    armed = self.drone_armed[d]
                    if not (want_payload or armed):
                        continue
                    pos, vel = tr.pos[d], tr.vel[d]
                    heading = float(tr.heading[d])
                    if want_payload:
                        filtered.append({
                            "pos": pos.tolist(),
                            "vel": vel.tolist(),
                            "heading": heading,
                            "droneIndex": int(d),
                        })
                    if armed:
                        # pose + velocity feed (computer_code/api/
                        # helpers.py:113-122).  The engine's world frame is
                        # [x, up, z]; the firmware reads pos[2] as altitude,
                        # so send [x, z, up].
                        self.link.send(int(d), {
                            "pos": [round(float(pos[0]), 4),
                                    round(float(pos[2]), 4),
                                    round(float(pos[1]), 4),
                                    round(heading, 4)],
                            "vel": [round(float(vel[0]), 4),
                                    round(float(vel[2]), 4),
                                    round(float(vel[1]), 4)],
                        })
            if not want_payload:
                return
            payload = {
                "object_points": out.object_points[pv].tolist(),
                "errors": out.point_errors[pv].tolist(),
                "objects": objects,
                "filtered_objects": filtered,
            }
            if out.bodies is not None:
                # 6-DoF body fits and their tracks (fields the reference
                # client ignores)
                b, tb = out.bodies, out.tracked_bodies
                payload["bodies"] = [{
                    "R": b.R[i].tolist(),
                    "t": b.t[i].tolist(),
                    "rms": float(b.rms[i]),
                    "templateIndex": int(set_of_slot[i]),
                } for i in np.where(b.valid)[0]]
                payload["tracked_bodies"] = [{
                    "bodyIndex": int(i),
                    "templateIndex": int(set_of_slot[i]),
                    "pos": tb.pos[i].tolist(),
                    "vel": tb.vel[i].tolist(),
                    "quat": tb.quat[i].tolist(),
                    "R": quat_to_matrix_np(tb.quat[i]).tolist(),
                } for i in np.where(tb.valid)[0]]
            self.emit("object-points", payload)

    # ------------------------------------------------------------ frames

    def latest_frame_strip(self) -> np.ndarray | None:
        """(H, C*W) uint8 montage for the MJPEG stream
        (``computer_code/api/helpers.py:137-141``): detected blobs marked
        with a crosshair, a box and their pixel coordinates, and, while
        triangulating, each blob's epipolar line in the later cameras."""
        with self._frame_lock:
            if self._last_frames is None:
                return None
            frames = self._last_frames
            out = self._last_out
        strip = np.hstack(list(frames)).copy()
        if out is not None and self.is_capturing_points:
            H, W = frames.shape[1], frames.shape[2]
            blobs, bvalid = out.blob_px, out.blob_valid
            for c in range(frames.shape[0]):
                for k in np.where(bvalid[c])[0]:
                    bx, by = blobs[c, k, 0], blobs[c, k, 1]
                    x = int(np.clip(bx, 0, W - 1)) + c * W
                    y = int(np.clip(by, 0, H - 1))
                    x0, x1 = max(x - 4, 0), min(x + 5, strip.shape[1])
                    y0, y1 = max(y - 4, 0), min(y + 5, H)
                    strip[y, x0:x1] = 255   # crosshair
                    strip[y0:y1, x] = 255
                    strip[y0:y1, x0] = 255  # box at the blob boundary
                    strip[y0:y1, x1 - 1] = 255
                    strip[y0, x0:x1] = 255
                    strip[y1 - 1, x0:x1] = 255
                    _draw_text(strip, x + 6, y - 6, f"{bx:.0f},{by:.0f}")
            if self.is_triangulating_points:
                version = self._cal_version
                if self._F_np_src != version:
                    # one device readback per calibration, not per frame
                    self._F_np = self._F.cpu().numpy()
                    self._F_np_src = version
                C = frames.shape[0]
                for b in range(1, C):
                    for a in range(b):
                        for k in np.where(bvalid[a])[0]:
                            ph = np.array([blobs[a, k, 0], blobs[a, k, 1],
                                           1.0])
                            _draw_epiline(strip, self._F_np[a, b] @ ph,
                                          b * W, W, H)
        return strip


# 3x5 bitmap glyphs for the stream's coordinate labels (digits, ',' '-'
# '.'), row-major bits
_GLYPHS = {
    "0": 0b111101101101111, "1": 0b010110010010111, "2": 0b111001111100111,
    "3": 0b111001111001111, "4": 0b101101111001001, "5": 0b111100111001111,
    "6": 0b111100111101111, "7": 0b111001010010010, "8": 0b111101111101111,
    "9": 0b111101111001111, ",": 0b000000010010100, "-": 0b000000111000000,
    ".": 0b000000000000010,
}


def _draw_text(img: np.ndarray, x: int, y: int, text: str,
               value: int = 255) -> None:
    """Render 3x5 bitmap text into a grayscale image in place (clipped)."""
    H, W = img.shape
    for ch in text:
        bits = _GLYPHS.get(ch)
        if bits is None:
            x += 4
            continue
        for r in range(5):
            for col in range(3):
                if bits >> (14 - r * 3 - col) & 1:
                    yy, xx = y + r, x + col
                    if 0 <= yy < H and 0 <= xx < W:
                        img[yy, xx] = value
        x += 4


def _draw_epiline(strip: np.ndarray, line, x_off: int, W: int, H: int,
                  value: int = 150) -> None:
    """Draw the epipolar line ``ax + by + c = 0`` into the tile starting at
    column ``x_off`` of the strip (the reference's ``drawlines``,
    ``computer_code/api/helpers.py:497-504``), dim grey and max-blended so
    blob marks stay visible where a line crosses them."""
    a, b, c = (float(v) for v in line)
    if abs(a) < 1e-12 and abs(b) < 1e-12:
        return
    n = 2 * max(W, H)
    if abs(b) >= abs(a):
        xs = np.linspace(0.0, W - 1.0, n)
        ys = -(c + a * xs) / b
    else:
        ys = np.linspace(0.0, H - 1.0, n)
        xs = -(c + b * ys) / a
    m = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
    if not m.any():
        return
    xi = xs[m].astype(np.intp) + x_off
    yi = ys[m].astype(np.intp)
    strip[yi, xi] = np.maximum(strip[yi, xi], value)


def _f32(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _tail_row(state, payload, dt, *cal, **kw):
    """The host-detect step: one (C, K, 3) [x, y, valid] frame set through
    ``track_from_blobs`` -> (state, packed row)."""
    state, out = track_from_blobs(state, payload[..., :2],
                                  payload[..., 2] > 0.5, dt, *cal, **kw)
    return state, pack_outputs(out)


def _frame_row(state, payload, dt, *cal, **kw):
    """The device-detect steps: ``frame_step`` -> (state, packed row)."""
    state, out = frame_step(state, payload, dt, *cal, **kw)
    return state, pack_outputs(out)


def _scan_rows(state, payload, dts, *cal, **kw):
    return scan_head(state, payload[..., :2], payload[..., 2] > 0.5, dts,
                     *cal, **kw)


def _mesh_row(state, shards, dt, *cal, mesh, cfg, **kw):
    """The camera-sharded step on one device: each shard's (C/d, H, W/8)
    packed frames detected, the blobs gathered, ``_tail_row``."""
    return _tail_row(state, detect_gather(mesh, shards, cfg, packed=True),
                     dt, *cal, **kw)


def _mesh_scan_rows(state, shards, dts, *cal, mesh, cfg, **kw):
    """The batched camera-sharded head on one device: (B, C/d, H, W/8) a
    shard, detected and gathered, then ``_scan_rows``."""
    return _scan_rows(state, detect_gather(mesh, shards, cfg, packed=True,
                                           dim=1), dts, *cal, **kw)


def _detect_rows(state, shards, *, cfg):
    """One device's shards detected: ((), their (..., C/d, K, 3) blobs)."""
    return state, tuple(detect_shard(s, cfg, True) for s in shards)


class _ShardedStep:
    """The camera-sharded step with its shards on several devices: a
    compiled detection step for each shard device (its shards' packed
    frames -> their blobs, on that device's stream), the blobs copied into
    the tail step's payload on the engine's device (a copy between two
    cards first waits for both cards' current streams, and the tail's
    stream waits for it: PyTorch's rule for such copies), then the tail
    step (the host-blob kind, per frame or batched).  Called with (state,
    the shards' frames, dt or dts, *calibration) like the one-device
    step."""

    def __init__(self, devices, bufs, tail, cfg, dim: int):
        groups: dict = {}
        for k, dev in enumerate(devices):
            groups.setdefault(dev, []).append(k)
        self.heads = [(idx, compiled.CompiledStep(
            functools.partial(_detect_rows, cfg=cfg), (),
            tuple(bufs[k] for k in idx), name=f"mesh detect {dev}"))
            for dev, idx in groups.items()]
        self.tail = tail
        self.payload = (tail.head if isinstance(tail, _ScanStep)
                        else tail).args[0]
        self.dim = dim
        self.cams = bufs[0].shape[dim]

    @property
    def steps(self) -> tuple:
        return tuple(h for _, h in self.heads) + getattr(
            self.tail, "steps", (self.tail,))

    def __call__(self, state, shards, dts, *cal):
        for idx, head in self.heads:
            _, blobs = head((), tuple(shards[k] for k in idx))
            for k, b in zip(idx, blobs):
                self.payload.narrow(self.dim, k * self.cams,
                                    self.cams).copy_(b)
        return self.tail(state, self.payload, dts, *cal)


class _ScanStep:
    """The batched program compiled (the JAX engine's ``_step_scan``):
    ``scan_track_from_blobs`` over B host-detected frame sets (``head``
    ``_scan_rows``), or over the blobs of B camera-sharded frame sets
    detected on the device (``_mesh_scan_rows``; ``payload`` then the
    shards' buffers).

    The geometry and the bank over the batch are one compiled step.  With
    body templates the body stage, which runs frame by frame, is a second
    one over static per-frame slots (the frame's world points, their
    validity and its dt), replayed B times after the first: one graph of
    B body stages would hold about B times 9,300 nodes.  Each frame's body
    fields are copied into the batch's rows after its replay.  Called with
    (state, (B, C, K, 3) payload, (B,) dts, *calibration) -> (state, (B, L)
    rows); ``state`` is donated and the rows are overwritten by the next
    call.  ``points``: the world points a frame, C * K."""

    def __init__(self, state, payload, dts, cal, tail_kw, points: int,
                 head=_scan_rows):
        kw = dict(tail_kw)
        sets = kw.pop("body_sets")
        self.state = state
        kstate, body_states = state if sets else (state, None)
        self.head = compiled.CompiledStep(
            functools.partial(head, **kw), kstate, payload, dts, *cal,
            name="batched")
        self.body = self.rows = None
        if sets:
            dev = dts.device
            self.body = compiled.CompiledStep(
                functools.partial(body_row, body_sets=sets), body_states,
                _f32((points, 3), dev),
                torch.zeros(points, dtype=torch.bool, device=dev),
                _f32((), dev), name="body stage")

    @property
    def steps(self) -> tuple:
        return (self.head,) + ((self.body,) if self.body else ())

    def __call__(self, state, payload, dts, *cal):
        compiled.assign(self.state, state)
        kstate = self.state[0] if self.body else self.state
        _, (rows, pts, live) = self.head(kstate, payload, dts, *cal)
        if self.body is None:
            return self.state, rows
        dts_buf = self.head.args[1]
        B, L0 = rows.shape
        for i in range(B):
            # the body step's row is overwritten by its next replay
            _, row = self.body(self.state[1], pts[i], live[i], dts_buf[i])
            if self.rows is None:
                self.rows = torch.empty((B, L0 + row.shape[0]),
                                        dtype=torch.float32,
                                        device=rows.device)
            self.rows[i, L0:].copy_(row)
        self.rows[:, :L0].copy_(rows)
        return self.state, self.rows


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one; ``cuda`` is the current CUDA device."""
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def camera_poses_to_serializable(Rs: np.ndarray, ts: np.ndarray):
    """Reference wire shape (``computer_code/api/helpers.py:526-530``)."""
    return [{"R": R.tolist(), "t": np.asarray(t).reshape(-1).tolist()}
            for R, t in zip(np.asarray(Rs), np.asarray(ts))]


def serializable_to_camera_poses(poses):
    """Reference wire shape [{"R": 3x3, "t": 3}, ...] -> (Rs, ts)."""
    Rs = np.asarray([p["R"] for p in poses], np.float32)
    ts = np.asarray([np.asarray(p["t"], np.float32).reshape(-1)
                     for p in poses], np.float32)
    return Rs, ts
