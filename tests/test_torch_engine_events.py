"""PyTorch port: the Engine's rigid-body, recording, profiling and
preprocessing surface on the CPU.

- a rig with two body templates: the port's ``object-points`` payloads
  (``bodies``, ``tracked_bodies``, ``templateIndex``) against the JAX
  Engine's on the same frames;
- ``learn-body-template`` with ``apply`` while rows are in flight
  (pipelined per-frame readback, batches with the emit worker): the
  learned template, a clean switch of the row layout, the learned body
  tracked;
- ``record-frames`` read back by both packages' ``RecordedSource`` and
  replayed through a fresh engine;
- ``capture-profile``: a trace file, and the error event while another
  profiler runs;
- ``preprocess`` and ``frame_step(do_preprocess=True)`` against JAX, and
  the Engine's ``preprocess_frames`` ingest rules;
- ``serve.build`` with ``--body-markers`` / ``--body-sets``.

Discrete fields are equal; floats within 1e-5 m (positions) and 1e-4
(rotation and quaternion entries), as in ``test_torch_bodies.py``.
"""

import dataclasses
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
from low_cost_mocap_tpu.config import RigConfig as JRigConfig
from low_cost_mocap_tpu.models import pipeline as jpipe
from low_cost_mocap_tpu.ops import detect as jdetect
from low_cost_mocap_tpu.ops import kalman as jkalman
from low_cost_mocap_tpu.runtime.sources import \
    RecordedSource as JRecordedSource
from low_cost_mocap_tpu_torch import serve
from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.models import pipeline
from low_cost_mocap_tpu_torch.ops import detect, kalman
from low_cost_mocap_tpu_torch.runtime.engine import Engine
from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
from low_cost_mocap_tpu_torch.runtime.sources import (RecordedSource,
                                                      SyntheticSource)
from low_cost_mocap_tpu_torch.utils import profiling
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
R_TOL = dict(atol=1e-4, rtol=0)
TMPL_A = ((0.0, 0.0, 0.0), (0.12, 0.0, 0.0), (0.0, 0.09, 0.0),
          (0.05, 0.04, 0.07))
TMPL_B = ((0.0, 0.0, 0.0), (0.2, 0.0, 0.0), (0.1, 0.16, 0.0),
          (0.02, 0.05, 0.11))
DT = 1 / 60


def _rot_y(a):
    """A turn about the display world's up axis."""
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _pose_a(i):
    """Prop A at frame i: circling 8 cm at 0.2 Hz while its yaw swings,
    tilted so that no two of its markers' blobs merge in any camera."""
    ph = 2 * np.pi * 0.2 * i * DT
    return (_rot_y(0.4 + 0.4 * np.sin(ph)) @ _rot_x(0.6),
            np.array([-0.3 + 0.08 * np.cos(ph), 0.25, 0.1 + 0.08 * np.sin(ph)],
                     np.float32))


def _pose_b(i):
    ph = 2 * np.pi * 0.2 * i * DT + 1.0
    return (_rot_y(2.15 + 0.4 * np.sin(ph)) @ _rot_x(0.3),
            np.array([0.3 + 0.08 * np.cos(ph), 0.25, -0.1 + 0.08 * np.sin(ph)],
                     np.float32))


def _render(rig, Rs, ts, bodies):
    """uint8 frames of (template, R, t) bodies posed in the display world
    frame ([x, up, z]), mapped back to the triangulation frame."""
    Xw = np.concatenate([np.asarray(m, np.float32) @ R.T + t
                         for m, R, t in bodies])
    X = Xw[:, [0, 2, 1]] * np.array([-1.0, -1.0, 1.0], np.float32)
    pts, mask = syn.observe(X, Rs, ts, rig)
    return (syn.render_frames(pts, mask, rig.image_size, sigma=0.8)
            * 255).astype(np.uint8)


def _two_body_frames(rig, Rs, ts, n):
    return [_render(rig, Rs, ts, [(TMPL_A, *_pose_a(i)),
                                  (TMPL_B, *_pose_b(i))]) for i in range(n)]


def _poses(Rs, ts):
    return [{"R": R.tolist(), "t": t.tolist()} for R, t in zip(Rs, ts)]


def _serve(eng, frames, Rs, ts):
    got = []
    eng.on("object-points", got.append)
    eng.handle("triangulate-points", {"startOrStop": "start",
                                      "cameraPoses": _poses(Rs, ts)})
    eng.handle("locate-objects", {"startOrStop": "start"})
    for f in frames:
        eng.process_frame(f, DT)
    eng.flush_batches()
    return got


def test_body_payloads_match_the_jax_engine():
    Rs, ts, rig0 = syn.ring_rig(num_cameras=4)
    rig = dataclasses.replace(rig0, body_markers=TMPL_A, max_bodies=1,
                              body_sets=((TMPL_B, 2),))
    jrig = JRigConfig(num_cameras=4, body_markers=TMPL_A, max_bodies=1,
                      body_sets=((TMPL_B, 2),))
    frames = _two_body_frames(rig, Rs, ts, 4)
    eng = Engine(rig, EngineConfig(max_blobs=16), None, CollectingLink(),
                 device="cpu", host_detect=True)
    from low_cost_mocap_tpu.runtime.engine import Engine as JEngine
    from low_cost_mocap_tpu.runtime.serial_link import \
        CollectingLink as JCollectingLink
    jeng = JEngine(jrig, JEngineConfig(max_blobs=16), None,
                   JCollectingLink(), fast_path=True, host_detect=True)
    assert eng._layout[4] == jeng._num_bodies == 3
    np.testing.assert_array_equal(eng._body_set_of_slot,
                                  jeng._body_set_of_slot)
    got, want = _serve(eng, frames, Rs, ts), _serve(jeng, frames, Rs, ts)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["object_points"], w["object_points"],
                                   **TOL)
        assert [b["templateIndex"] for b in g["bodies"]] == \
            [b["templateIndex"] for b in w["bodies"]]
        for gb, wb in zip(g["bodies"], w["bodies"]):
            np.testing.assert_allclose(gb["t"], wb["t"], **TOL)
            np.testing.assert_allclose(gb["R"], wb["R"], **R_TOL)
            np.testing.assert_allclose(gb["rms"], wb["rms"], atol=1e-6)
        assert [(b["bodyIndex"], b["templateIndex"])
                for b in g["tracked_bodies"]] == \
            [(b["bodyIndex"], b["templateIndex"])
             for b in w["tracked_bodies"]]
        for gb, wb in zip(g["tracked_bodies"], w["tracked_bodies"]):
            for k, tol in (("pos", TOL), ("vel", dict(atol=1e-3)),
                           ("quat", R_TOL), ("R", R_TOL)):
                np.testing.assert_allclose(gb[k], wb[k], **tol)
    last = got[-1]
    assert sorted(b["templateIndex"] for b in last["bodies"]) == [0, 1]
    for b in last["bodies"]:
        R, t = (_pose_a if b["templateIndex"] == 0 else _pose_b)(3)
        np.testing.assert_allclose(b["t"], t, atol=5e-3)
        np.testing.assert_allclose(b["R"], R, atol=0.02)


@pytest.mark.parametrize("mode", ["per-frame depth 2", "batched emit worker"])
def test_learn_body_template_and_apply_with_rows_in_flight(mode):
    """Learn prop A from 16 served frames, apply while pipelined rows (or
    batches the emit worker holds) are still in flight, then track it: the
    learned markers match A's, the stream switches layout cleanly (no
    errors, no body fields before, body fields on every event after), and
    the tracked markers R m + t land on A's true markers."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    cfg = (EngineConfig(max_blobs=16, readback_pipeline_depth=2)
           if mode.startswith("per-frame") else
           EngineConfig(max_blobs=16, dispatch_batch=4,
                        batch_emit_thread=True))
    eng = Engine(rig, cfg, None, CollectingLink(), device="cpu",
                 host_detect=True)
    errors, templates = [], []
    eng.on("engine-error", errors.append)
    eng.on("body-template", templates.append)
    # every 5th frame of the path, so that the views vary while learning
    frames = [_render(rig, Rs, ts, [(TMPL_A, *_pose_a(5 * i))])
              for i in range(32)]
    try:
        events = _serve(eng, [], Rs, ts)
        eng.handle("learn-body-template", {"startOrStop": "start"})
        for f in frames[:18]:
            eng.process_frame(f, DT)
        eng.flush_batches()
        n_before = len(events)
        for f in frames[18:20]:            # rows / a batch left in flight
            eng.process_frame(f, DT)
        eng.handle("learn-body-template", {"startOrStop": "stop",
                                           "apply": True, "maxBodies": 1})
        for f in frames[20:]:
            eng.process_frame(f, DT)
        eng.flush_batches()
    finally:
        eng.stop()
    assert not errors, errors
    (tp,) = templates
    assert tp["error"] is None and tp["applied"] and tp["frames_used"] >= 16
    learned = np.asarray(tp["markers"], np.float32)
    D = lambda m: np.sort(np.linalg.norm(m[:, None] - m[None], axis=-1),
                          axis=None)
    np.testing.assert_allclose(D(learned), D(np.asarray(TMPL_A, np.float32)),
                               atol=2e-3)
    assert eng._layout[4] == 1 and eng.rig.max_bodies == 1
    assert all("bodies" not in e for e in events[:n_before])
    after = [e for e in events if "bodies" in e]
    assert len(after) >= 8 and "bodies" in events[-1]
    assert len(after) + n_before <= len(events)
    tb = after[-1]["tracked_bodies"]
    assert [b["templateIndex"] for b in tb] == [0]
    R, t = np.asarray(tb[0]["R"]), np.asarray(tb[0]["pos"])
    R_true, t_true = _pose_a(5 * 31)
    tracked = learned @ R.T + t
    truth = np.asarray(TMPL_A, np.float32) @ R_true.T + t_true
    err = np.linalg.norm(tracked[:, None] - truth[None], axis=-1).min(1)
    assert err.max() < 0.01, err


def test_learn_body_template_errors():
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    eng = Engine(rig, EngineConfig(), None, CollectingLink(), device="cpu",
                 host_detect=True)
    out = []
    eng.on("body-template", out.append)
    eng.handle("learn-body-template", {"startOrStop": "stop"})
    _serve(eng, [], Rs, ts)
    eng.handle("learn-body-template", {"startOrStop": "start"})
    eng.process_frame(np.zeros((4, 320, 320), np.uint8), DT)
    eng.handle("learn-body-template", {"startOrStop": "stop"})
    assert out[0]["error"] == "no frames captured"
    assert ">= 3 valid points" in out[1]["error"]
    assert eng._layout[4] == 0


def test_record_frames_replay_through_both_recorded_sources(tmp_path):
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    frames = [src.read_at(i * DT) for i in range(8)]
    eng = Engine(rig, EngineConfig(), src, CollectingLink(), device="cpu",
                 host_detect=True, artifacts_dir=str(tmp_path))
    recs = []
    eng.on("recording", recs.append)
    eng.handle("record-frames", {"startOrStop": "stop"})
    assert recs[0]["error"] == "no frames recorded"
    eng.handle("record-frames", {"startOrStop": "start", "maxFrames": 6})
    live = _serve(eng, frames, Rs, ts)
    eng.handle("record-frames", {"startOrStop": "stop"})
    rec = recs[1]
    assert rec["error"] is None and rec["frames"] == 6
    assert rec["path"].startswith(str(tmp_path))
    for Source in (RecordedSource, JRecordedSource):
        s = Source(rec["path"])
        assert s.num_cameras == 4 and s.image_size == 320
        for f in frames[:6]:
            np.testing.assert_array_equal(s.read(), f)
    replay = Engine(rig, EngineConfig(), RecordedSource(rec["path"]),
                    CollectingLink(), device="cpu", host_detect=True)
    got = _serve(replay, [replay.source.read() for _ in range(6)], Rs, ts)
    for g, w in zip(got, live[:6]):
        assert g["object_points"] == w["object_points"]
        assert g["filtered_objects"] == w["filtered_objects"]


def test_capture_profile_writes_a_trace_and_reports_a_busy_profiler(
        tmp_path):
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    eng = Engine(rig, EngineConfig(), None, CollectingLink(), device="cpu",
                 host_detect=True)
    got, done = [], threading.Event()
    eng.on("profile", lambda d: (got.append(d), done.set()))
    eng.handle("capture-profile", {"durationMs": 100,
                                   "path": str(tmp_path / "p1")})
    assert done.wait(30)
    assert got[0]["error"] is None
    with open(got[0]["path"]) as f:
        assert "traceEvents" in json.load(f)
    with pytest.raises(ValueError):
        eng.handle("capture-profile", {"durationMs": "soon"})
    # a profiler already running: the event reports it, nothing crashes
    for holder in (lambda: profiling.device_trace(str(tmp_path / "held"),
                                                  "cpu"),
                   lambda: torch.profiler.profile(
                       activities=[torch.profiler.ProfilerActivity.CPU])):
        done.clear()
        with holder():
            eng.handle("capture-profile", {"durationMs": 10,
                                           "path": str(tmp_path / "p2")})
            assert done.wait(30)
        assert "already running" in got[-1]["error"]
    assert profiling.time_compiled(lambda x: x + 1, torch.ones(3),
                                   iters=5)["iters"] == 5
    # a CUDA trace that kept the launches but lost every kernel is refused
    launch = '{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel"}'
    kernel = '{"ph": "X", "cat": "kernel", "name": "kalman_bank_kernel"}'
    assert profiling.lost_kernels(f'{{"traceEvents": [{launch}]}}')
    assert not profiling.lost_kernels(
        f'{{"traceEvents": [{launch}, {kernel}]}}')
    assert not profiling.lost_kernels('{"traceEvents": []}')


def test_device_trace_starts_and_stops_under_the_quiesce_lock(tmp_path):
    """The profiler starts and stops only while it holds ``quiesce``, the
    lock the launching threads hold (on the card CUPTI loses the kernels of
    a thread that launches across a start or stop), and not in between."""
    lock, entered, leave = threading.Lock(), threading.Event(), \
        threading.Event()
    res = {}

    def trace():
        with profiling.device_trace(str(tmp_path), "cpu", lock) as path:
            entered.set()
            leave.wait(30)
        res["path"] = path

    with lock:                          # a launch in progress
        th = threading.Thread(target=trace)
        th.start()
        assert not entered.wait(0.3)    # the start waits for it
    assert entered.wait(30)
    with lock:                          # the window is open meanwhile
        leave.set()
        time.sleep(0.3)
        assert "path" not in res        # the stop waits again
    th.join(30)
    assert os.path.exists(res["path"])


def test_preprocess_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.random((3, 40, 56)).astype(np.float32)
    frames[:, 10:14, 20:24] = 1.0
    np.testing.assert_array_equal(detect.fused_preprocess_kernel(),
                                  jdetect.fused_preprocess_kernel())
    want = np.asarray(jdetect.preprocess(jnp.asarray(frames)))
    got = detect.preprocess(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got.min() == 0.0 and got.max() == 1.0


def test_frame_step_with_preprocessing_matches_jax():
    Rs, ts, rig = syn.ring_rig(num_cameras=4, image_size=160)
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    from low_cost_mocap_tpu.ops import camera as jcam
    from low_cost_mocap_tpu.ops import correspond as jcorr
    from low_cost_mocap_tpu_torch.utils.convert import \
        calibration_from_numpy

    K, dist, M = rig.K_stack(), rig.dist_stack(), np.eye(4, dtype=np.float32)
    Ps = np.asarray(jcam.projection_matrix(jnp.asarray(K), jnp.asarray(Rs),
                                           jnp.asarray(ts)))
    Fs = np.asarray(jcorr._pairwise_fundamentals(jnp.asarray(Ps)))
    c = calibration_from_numpy(K, dist, Ps, Fs, M, device="cpu")
    kw = dict(threshold=0.2, max_blobs=8, cc_iters=24, gate_px=5.0,
              max_candidates=2, marker_dist1=rig.marker_dist_short,
              marker_dist2=rig.marker_dist_long,
              marker_tol=rig.marker_dist_tol,
              marker_side_min=rig.marker_side_min, do_preprocess=True)
    jst, st = jkalman.init_state(2), kalman.init_state(2, device="cpu")
    for i in range(2):
        f = src.read_at(i * DT)
        jst, jout = jpipe.frame_step(
            jst, jnp.asarray(f), np.float32(DT),
            *(jnp.asarray(a) for a in (Ps, K, dist, M, Fs)), **kw)
        st, out = pipeline.frame_step(st, torch.from_numpy(f),
                                      np.float32(DT), c.Ps, c.K, c.dist,
                                      c.to_world, c.Fs, **kw)
        np.testing.assert_array_equal(out.blob_valid.numpy(),
                                      np.asarray(jout.blob_valid))
        np.testing.assert_allclose(out.blob_px.numpy(),
                                   np.asarray(jout.blob_px), **TOL)
        np.testing.assert_array_equal(out.point_valid.numpy(),
                                      np.asarray(jout.point_valid))
        np.testing.assert_allclose(out.object_points.numpy(),
                                   np.asarray(jout.object_points), **TOL)
    # at 160 px the blur merges each drone's LEDs into fewer blobs
    assert int(out.blob_valid.sum()) >= 8
    with pytest.raises(ValueError, match="dense frames"):
        pipeline.frame_step(st, torch.zeros(256, dtype=torch.int32),
                            DT, c.Ps, c.K, c.dist, c.to_world, c.Fs,
                            sparse_input=True, image_shape=(4, 160, 160),
                            **kw)


def test_engine_preprocess_frames_ingest_rules():
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    src = SyntheticSource(rig, Rs, ts, num_drones=1)
    for opt in (dict(host_detect=True), dict(fast_path=True)):
        with pytest.raises(ValueError, match="preprocess_frames"):
            Engine(rig, EngineConfig(), src, CollectingLink(), device="cpu",
                   preprocess_frames=True, **opt)
    eng = Engine(rig, EngineConfig(), src, CollectingLink(), device="cpu",
                 preprocess_frames=True)
    assert not eng._fast and not eng._host_detect
    assert eng._step_kw["do_preprocess"]
    got = _serve(eng, [src.read_at(i * DT) for i in range(2)], Rs, ts)
    assert len(got) == 2 and len(got[-1]["object_points"]) == 3


def test_serve_build_with_body_templates(tmp_path):
    args = serve.parse_args([
        "--port", "0", "--link", "none", "--artifacts-dir", str(tmp_path),
        "--body-markers", json.dumps(TMPL_A), "--max-bodies", "1",
        "--body-sets", json.dumps([[TMPL_B, 2]])])
    engine, server, source, link = serve.build(args, device="cpu")
    assert engine.rig.body_markers == TMPL_A
    assert engine.rig.body_sets == ((TMPL_B, 2),)
    assert engine._layout[4] == 3
    np.testing.assert_array_equal(engine._body_set_of_slot, [0, 1, 1])
    assert isinstance(engine._kalman_state, tuple)
