"""PyTorch port: the serving engine on the CPU.

The port's host-detect engine against the JAX package's on the same
frames (discrete outputs equal, floats within atol 1e-5); batched,
pipelined and emit-worker serving bitwise equal to the port's own
per-frame serving; the sparse, packed and host-detect paths equal; camera
health; the capture loop's fault tolerance; the reference handlers, the
drone link, calibration persistence and the MJPEG strip; and no quiet
fallback when the native library does not build.
"""

import time

import numpy as np
import pytest
import torch

from low_cost_mocap_tpu_torch.config import EngineConfig, RigConfig
from low_cost_mocap_tpu_torch.control import bindings
from low_cost_mocap_tpu_torch.runtime.engine import (
    Engine, camera_poses_to_serializable)
from low_cost_mocap_tpu_torch.runtime.health import CameraHealthMonitor
from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _rig_source(num_drones=2, **kw):
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    src = SyntheticSource(rig, Rs, ts, num_drones=num_drones,
                          headings=(0.0, np.pi)[:num_drones], **kw)
    return Rs, ts, rig, src


def _tracking(eng, Rs, ts):
    payloads = []
    eng.on("object-points", payloads.append)
    eng.handle("triangulate-points", {
        "startOrStop": "start",
        "cameraPoses": camera_poses_to_serializable(Rs, ts),
        "toWorldCoordsMatrix": np.eye(4).tolist()})
    eng.handle("locate-objects", {"startOrStop": "start"})
    return payloads


def _cpu_engine(rig, cfg, src, link=None, **kw):
    kw.setdefault("host_detect", True)
    return Engine(rig, cfg, src, link or CollectingLink(), device="cpu",
                  **kw)


def test_host_detect_engine_matches_jax_engine():
    from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
    from low_cost_mocap_tpu.config import RigConfig as JRigConfig
    from low_cost_mocap_tpu.runtime.engine import Engine as JEngine
    from low_cost_mocap_tpu.runtime.serial_link import \
        CollectingLink as JCollectingLink

    Rs, ts, rig, src = _rig_source()
    eng = _cpu_engine(rig, EngineConfig(), src)
    jeng = JEngine(JRigConfig(num_cameras=4, image_size=rig.image_size),
                   JEngineConfig(), src, JCollectingLink(), fast_path=True,
                   host_detect=True)
    assert eng._host_detect and jeng._host_detect
    for e in (eng, jeng):
        _tracking(e, Rs, ts)
    for i in range(8):
        frames = src.read_at(i / 60)
        got = eng.process_frame(frames, 1 / 60)
        want = jeng.process_frame(frames, 1 / 60)
        for name in ("blob_valid", "point_valid"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)))
        for name in ("blob_px", "object_points", "point_errors"):
            np.testing.assert_allclose(getattr(got, name),
                                       np.asarray(getattr(want, name)), **TOL)
        for field in ("valid", "index"):
            np.testing.assert_array_equal(
                getattr(got.objects, field),
                np.asarray(getattr(want.objects, field)))
        np.testing.assert_array_equal(got.tracked.valid,
                                      np.asarray(want.tracked.valid))
        for a, b in (*zip(got.objects, want.objects),
                     *zip(got.tracked, want.tracked)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert got.tracked.valid.all()


@pytest.mark.parametrize("extra", [
    dict(), dict(readback_pipeline_depth=1), dict(batch_emit_thread=True)],
    ids=["depth0", "depth1", "emit_worker"])
def test_batched_dispatch_bitwise_equal_to_per_frame(extra):
    B = 4
    Rs, ts, rig, src = _rig_source()
    frames = [src.read_at(i / 60) for i in range(2 * B)]
    events = []
    for cfg in (EngineConfig(), EngineConfig(dispatch_batch=B, **extra)):
        eng = _cpu_engine(rig, cfg, src)
        got = _tracking(eng, Rs, ts)
        rets = [eng.process_frame(f, 1 / 60) for f in frames]
        if cfg.dispatch_batch == 1:
            assert all(r is not None for r in rets)
        elif extra.get("readback_pipeline_depth"):
            # the pipelined decode lags one batch; the flush emits it
            assert [r is None for r in rets] == [i != 2 * B - 1
                                                 for i in range(2 * B)]
            assert len(got) == B
        elif not extra:
            # outputs appear only when a batch completes
            assert [r is None for r in rets] == \
                [(i + 1) % B != 0 for i in range(2 * B)]
        eng.handle("triangulate-points", {"startOrStop": "stop"})
        eng.stop()
        events.append(got)
    assert len(events[0]) == len(events[1]) == 2 * B
    assert events[0] == events[1]
    assert len(events[0][-1]["filtered_objects"]) == 2


def test_pipelined_per_frame_readback_equals_depth_zero():
    Rs, ts, rig, src = _rig_source()
    frames = [src.read_at(i / 60) for i in range(6)]
    events = []
    for depth in (0, 2):
        eng = _cpu_engine(rig, EngineConfig(readback_pipeline_depth=depth),
                          src)
        got = _tracking(eng, Rs, ts)
        rets = [eng.process_frame(f, 1 / 60) for f in frames]
        assert sum(r is None for r in rets) == depth
        eng.flush_batches()          # drains the last `depth` rows in order
        events.append(got)
    assert len(events[1]) == 6
    assert events[0] == events[1]


def test_sparse_packed_and_host_detect_paths_agree():
    Rs, ts, rig, src = _rig_source()
    frames = [src.read_at(i / 60) for i in range(3)]
    events = []
    for cfg, kw in ((EngineConfig(), dict(host_detect=True)),
                    (EngineConfig(), dict(fast_path=True,
                                          host_detect=False)),
                    # a 4-pixel budget overflows: the packed bitmap goes up
                    (EngineConfig(sparse_budget=4),
                     dict(fast_path=True, host_detect=False))):
        eng = _cpu_engine(rig, cfg, src, **kw)
        got = _tracking(eng, Rs, ts)
        for f in frames:
            eng.process_frame(f, 1 / 60)
        events.append(got)
    assert events[0] == events[1] == events[2]
    assert events[0][-1]["object_points"]


class FreezableSource:
    """When frozen, camera ``cam`` replays its last buffer (a stalled USB
    pipeline)."""

    def __init__(self, inner, cam):
        self.inner = inner
        self.cam = cam
        self.num_cameras = inner.num_cameras
        self.image_size = inner.image_size
        self.frozen = False
        self._stale = None

    def read(self):
        f = self.inner.read()
        if self.frozen and self._stale is not None:
            f[self.cam] = self._stale
        else:
            self._stale = f[self.cam].copy()
        return f

    def set_settings(self, e, g):
        pass

    def close(self):
        pass


def test_frozen_camera_is_masked_and_recovers():
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    cfg = EngineConfig(health_freeze_frames=4, health_interval=1)
    src = FreezableSource(
        SyntheticSource(rig, Rs, ts, num_drones=1, orbit_hz=0.0), cam=2)
    eng = _cpu_engine(rig, cfg, src)
    health = []
    eng.on("camera-health", health.append)
    points = _tracking(eng, Rs, ts)
    for i in range(3):   # a gain wobble keeps the other cameras moving
        src.inner.gain = 10.0 + 0.5 * (i % 2)
        eng.process_frame(src.read(), 1 / 60)
    assert health == []
    src.frozen = True
    for i in range(10):
        src.inner.gain = 10.0 + 0.5 * (i % 2)
        frames = src.read()
        keep = frames.copy()
        out = eng.process_frame(frames, 1 / 60)
        np.testing.assert_array_equal(frames, keep)   # masks a copy
    assert {"camera": 2, "status": "frozen"} in health
    assert not out.blob_valid[2].any()
    assert out.tracked.valid.any()        # tracking goes on on 3 cameras
    exp = (np.asarray(src.inner.drone_pose(0, 0.0)[0])
           * np.array([-1.0, -1.0, 1.0]))[[0, 2, 1]]
    assert np.linalg.norm(
        np.asarray(points[-1]["filtered_objects"][0]["pos"]) - exp) < 0.05
    src.frozen = False
    for i in range(3):
        src.inner.gain = 10.0 + 0.5 * (i % 2)
        out = eng.process_frame(src.read(), 1 / 60)
    assert {"camera": 2, "status": "ok"} in health
    assert out.blob_valid[2].any()


def test_health_monitor_rejects_an_interval_below_one():
    for bad in (0, -4):
        with pytest.raises(ValueError, match="interval"):
            CameraHealthMonitor(4, interval=bad)
    with pytest.raises(ValueError, match="interval"):
        Rs, ts, rig, src = _rig_source()
        _cpu_engine(rig, EngineConfig(health_interval=0), src)


class FlakySource:
    """Fails every third read (a camera dropout)."""

    def __init__(self, inner):
        self.inner = inner
        self.num_cameras = inner.num_cameras
        self.image_size = inner.image_size
        self.calls = 0

    def read(self):
        self.calls += 1
        if self.calls % 3 == 0:
            raise RuntimeError("USB transfer failed")
        return self.inner.read()

    def set_settings(self, e, g):
        pass

    def close(self):
        pass


class DeadSource(FlakySource):
    def read(self):
        raise RuntimeError("camera gone")


@pytest.mark.parametrize("dead", [False, True], ids=["flaky", "dead"])
def test_capture_loop_survives_a_flaky_source_and_gives_up_on_a_dead_one(
        dead):
    Rs, ts, rig = syn.ring_rig(num_cameras=2, image_size=96)
    inner = SyntheticSource(rig, Rs, ts, num_drones=0)
    src = (DeadSource if dead else FlakySource)(inner)
    eng = _cpu_engine(rig, EngineConfig(target_fps=60 if not dead else 500),
                      src)
    errors = []
    eng.on("engine-error", errors.append)
    eng.handle("capture-points", {"startOrStop": "start"})
    eng.start()
    try:
        if dead:
            deadline = time.time() + 10
            while (time.time() < deadline
                   and not any(e.get("fatal") for e in errors)):
                time.sleep(0.1)
        else:
            time.sleep(1.5)
    finally:
        eng.stop()
    assert eng._thread is None
    if dead:
        assert any(e.get("fatal") for e in errors)
        assert not eng.is_capturing_points   # capture off, loop alive
    else:
        assert eng.frame_count > 10
        assert len(errors) >= 3
        assert not any(e.get("fatal") for e in errors)


def test_capture_mode_emits_image_points():
    Rs, ts, rig, src = _rig_source(num_drones=1)
    eng = _cpu_engine(rig, EngineConfig(), src)
    got = []
    eng.on("image-points", got.append)
    eng.handle("capture-points", {"startOrStop": "start"})
    out = eng.process_frame(src.read_at(0.0), 1 / 60)
    assert len(got) == 1 and len(got[0]) == 4
    for c, p in enumerate(got[0]):
        if out.blob_valid[c, 0]:
            assert p == out.blob_px[c, 0].tolist()
        else:
            assert p == [None, None]
    assert eng.captured_points == got
    eng.handle("capture-points", {"startOrStop": "stop"})
    assert eng.process_frame(src.read_at(0.0), 1 / 60) is None


def test_drone_handlers_and_armed_pose_feed_reach_the_link():
    Rs, ts, rig, src = _rig_source()
    link = CollectingLink()
    eng = _cpu_engine(rig, EngineConfig(), src, link)
    eng.handle("arm-drone", {"droneArmed": [True, False]})
    eng.handle("set-drone-pid", {"droneIndex": 1, "dronePID": [1, 2, 3]})
    eng.handle("set-drone-setpoint", {"droneIndex": 0,
                                      "droneSetpoint": [0.1, 0.2, 0.3]})
    eng.handle("set-drone-trim", {"droneIndex": 1, "droneTrim": [1, 2]})
    assert link.frames == [
        b'0{"armed": true}', b'1{"armed": false}',
        b'1{"pid": [1.0, 2.0, 3.0]}', b'0{"setpoint": [0.1, 0.2, 0.3]}',
        b'1{"trim": [1, 2]}']
    # armed drone 0's pose feed runs without any listener (no payloads),
    # in the firmware's axes [x, z, up, heading]
    link.frames.clear()
    eng.handle("triangulate-points", {
        "startOrStop": "start",
        "cameraPoses": camera_poses_to_serializable(Rs, ts)})
    eng.handle("locate-objects", {"startOrStop": "start"})
    for i in range(4):
        out = eng.process_frame(src.read_at(i / 60), 1 / 60)
    assert out.tracked.valid[0]
    feed = [f for f in link.frames if f.startswith(b'0{"pos"')]
    assert len(feed) == 4 and not any(f.startswith(b"1") for f in
                                      link.frames)
    import json
    last = json.loads(feed[-1][1:])
    p, v = out.tracked.pos[0], out.tracked.vel[0]
    assert last["pos"] == [round(float(p[0]), 4), round(float(p[2]), 4),
                           round(float(p[1]), 4),
                           round(float(out.tracked.heading[0]), 4)]
    assert last["vel"] == [round(float(v[0]), 4), round(float(v[2]), 4),
                           round(float(v[1]), 4)]


def test_link_stall_disarms_and_is_reported():
    class Link(CollectingLink):
        on_health = None

    seen = []
    link = Link()
    link.on_health = seen.append
    Rs, ts, rig, src = _rig_source()
    eng = _cpu_engine(rig, EngineConfig(), src, link)
    health = []
    eng.on("link-health", health.append)
    eng.handle("arm-drone", {"droneArmed": [True, True]})
    link.on_health({"state": "stalled"})
    assert eng.drone_armed == [False, False]
    assert health == [{"state": "stalled", "disarmed": True}]
    assert seen == [{"state": "stalled"}]   # the caller's callback chained


def test_calibration_persists_and_resumes(tmp_path):
    Rs, ts, rig, src = _rig_source()
    eng = _cpu_engine(rig, EngineConfig(), src, artifacts_dir=str(tmp_path))
    M = np.eye(4, dtype=np.float32)
    M[:3, 3] = [0.1, 0.2, 0.3]
    eng.set_camera_poses(Rs, ts)
    eng.set_to_world_matrix(M)
    assert (tmp_path / "calibration.json").exists()
    again = _cpu_engine(rig, EngineConfig(), src,
                        artifacts_dir=str(tmp_path))
    np.testing.assert_allclose(again.camera_poses[0], Rs, atol=1e-7)
    np.testing.assert_allclose(again.camera_poses[1], ts, atol=1e-7)
    np.testing.assert_array_equal(again.to_world_matrix, M)
    assert torch.equal(again._Ps, eng._Ps)
    assert torch.equal(again._M, eng._M)


def test_frame_strip_marks_blobs_and_epilines():
    Rs, ts, rig, src = _rig_source(num_drones=1)
    eng = _cpu_engine(rig, EngineConfig(), src)
    assert eng.latest_frame_strip() is None
    _tracking(eng, Rs, ts)
    frames = src.read_at(0.0)
    out = eng.process_frame(frames, 1 / 60)
    strip = eng.latest_frame_strip()
    H, W = rig.image_hw()
    assert strip.shape == (H, 4 * W) and strip.dtype == np.uint8
    c, k = np.argwhere(out.blob_valid)[0]
    x = int(out.blob_px[c, k, 0]) + c * W
    y = int(out.blob_px[c, k, 1])
    assert strip[y, x - 4] == 255 and strip[y - 4, x] == 255
    assert (strip == 150).any()          # epipolar lines while triangulating
    np.testing.assert_array_equal(frames, src.read_at(0.0))   # untouched


def test_unported_and_unknown_events_and_options_raise():
    Rs, ts, rig, src = _rig_source()
    eng = _cpu_engine(rig, EngineConfig(), src)
    # the events of the later slices are ported: each reaches its handler
    got = []
    for event in ("body-template", "recording"):
        eng.on(event, got.append)
    eng.handle("learn-body-template", {"startOrStop": "stop"})
    eng.handle("record-frames", {"startOrStop": "stop"})
    assert [g["error"] for g in got] == ["no frames captured",
                                         "no frames recorded"]
    with pytest.raises(ValueError):
        eng.handle("capture-profile", {"durationMs": "soon"})
    with pytest.raises(KeyError, match="bogus"):
        eng.handle("bogus", {})
    # mesh mode is ported; it serves the engine's own device only
    from low_cost_mocap_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="first device"):
        Engine(rig, EngineConfig(), src, CollectingLink(), device="cpu",
               mesh=make_mesh({"cam": 2}, devices=["cuda:0", "cuda:0"]))
    with pytest.raises(ValueError, match="dispatch_batch"):
        Engine(rig, EngineConfig(dispatch_batch=4), src, CollectingLink(),
               device="cpu")
    with pytest.raises(ValueError, match="fast path"):
        Engine(rig, EngineConfig(), src, CollectingLink(), device="cpu",
               fast_path=False, host_detect=True)
    with pytest.raises(ValueError, match=">= 3 markers"):
        Engine(RigConfig(body_markers=((0, 0, 0),)), EngineConfig(), src,
               CollectingLink(), device="cpu")
    # a CPU engine is dense unless host detection is asked for
    assert not Engine(rig, EngineConfig(), src, CollectingLink(),
                      device="cpu")._fast


def test_failing_native_build_raises_and_does_not_fall_back(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(bindings, "CXX", "false")   # a compiler that fails
    Rs, ts, rig, src = _rig_source()
    for cfg in (EngineConfig(), EngineConfig(dispatch_batch=4)):
        with pytest.raises(RuntimeError, match="failed to build"):
            _cpu_engine(rig, cfg, src)
    with pytest.raises(RuntimeError, match="failed to build"):
        bindings.ingest_detect(np.zeros((1, 8, 8), np.uint8), 52, 4)
    assert not list(tmp_path.glob("*.so"))


def test_loopback_link_flies_like_the_jax_one():
    """The port's LoopbackLink runs its own copy of the native cascade and
    simulator: the same commands give the same simulated flight."""
    from low_cost_mocap_tpu.runtime.serial_link import \
        LoopbackLink as JLoopbackLink
    from low_cost_mocap_tpu_torch.runtime.serial_link import LoopbackLink

    links = (LoopbackLink(2), JLoopbackLink(2))
    for link in links:
        link.send(0, {"armed": True})
        link.send(0, {"setpoint": [0.0, 0.0, 0.5]})
        for k in range(300):
            link.send(0, {"pos": [0.0, 0.0, 0.04 + k * 1e-3, 0.0],
                          "vel": [0.0, 0.0, 0.0]})
            link.tick(0.002)
    (p, v, yaw), (jp, jv, jyaw) = (link.drone_state(0) for link in links)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(v, jv)
    assert yaw == jyaw and p[2] > 0.04      # armed and climbing


class _FakeSerial:
    """serial.Serial stand-in: records writes; can wedge (block + raise)."""

    def __init__(self, device, baud, write_timeout=0.25):
        self.writes, self.wedged, self.closed = [], False, False

    def write(self, data):
        if self.wedged:
            time.sleep(0.01)
            raise TimeoutError("write timeout (wedged dongle)")
        self.writes.append(bytes(data))
        return len(data)

    def close(self):
        self.closed = True


def test_pyserial_link_order_and_a_stall_that_disarms_the_engine():
    import types

    from low_cost_mocap_tpu_torch.runtime.serial_link import PyserialLink

    fake = types.SimpleNamespace(instances=[])
    fake.Serial = lambda *a, **k: fake.instances.append(
        _FakeSerial(*a, **k)) or fake.instances[-1]
    link = PyserialLink("/dev/fake", serial_module=fake, pacing_s=0.0,
                        stall_after_s=0.05)
    ser = fake.instances[0]
    Rs, ts, rig, src = _rig_source()
    eng = _cpu_engine(rig, EngineConfig(), src, link)
    health = []
    eng.on("link-health", health.append)
    eng.handle("arm-drone", {"droneArmed": [True, True]})
    eng.handle("set-drone-pid", {"droneIndex": 1, "dronePID": [1, 2]})
    assert link.flush(2.0)
    assert ser.writes == [b'0{"armed": true}', b'1{"armed": true}',
                          b'1{"pid": [1.0, 2.0]}']
    ser.wedged = True
    deadline = time.monotonic() + 2.0
    while not health and time.monotonic() < deadline:
        link.send(0, {"pos": [0, 0, 0.5, 0], "vel": [0, 0, 0]})
        time.sleep(0.01)
    assert health and health[-1]["state"] == "stalled"
    assert health[-1]["disarmed"] and eng.drone_armed == [False, False]
    ser.wedged = False
    link.close()
    assert ser.closed


def test_pseyepy_source_layout_and_settings_through_the_engine(monkeypatch):
    import sys
    import types

    from low_cost_mocap_tpu_torch.config import CameraIntrinsics
    from low_cost_mocap_tpu_torch.runtime.sources import PseyepySource

    rng = np.random.default_rng(0)
    sensor = [rng.integers(0, 255, (240, 320), np.uint8) for _ in range(2)]

    class Camera:
        RES_SMALL = "small"

        def __init__(self, fps, resolution, gain, exposure):
            self.gain, self.exposure, self.ended = [gain] * 2, [exposure] * 2, \
                False

        def read(self):
            return [f.copy() for f in sensor], [0.0, 0.0]

        def end(self):
            self.ended = True

    monkeypatch.setitem(sys.modules, "pseyepy",
                        types.SimpleNamespace(Camera=Camera))
    cams = tuple(CameraIntrinsics(((272.0, 0, 120), (0, 272.0, 160),
                                   (0, 0, 1)), (0.0,) * 5, rotation=1)
                 for _ in range(2))
    rig = RigConfig(num_cameras=2, image_size=(320, 240), cameras=cams)
    src = PseyepySource(rig)
    out = src.read()
    assert out.shape == (2, 320, 240)
    for i in range(2):
        np.testing.assert_array_equal(out[i], np.rot90(sensor[i], 1))
    eng = _cpu_engine(rig, EngineConfig(), src)
    eng.handle("update-camera-settings", {"exposure": 55, "gain": 3})
    assert src._cam.exposure == [55, 55] and src._cam.gain == [3, 3]
    src.close()
    assert src._cam.ended


# ---------------------------------------------------------------- calibration


def _wand_capture(rig, Rs, ts, n=50, seed=0):
    """A captured wand sweep, one dot per camera per frame, in the
    ``cameraPoints`` wire shape (None where a camera missed it)."""
    rng = np.random.default_rng(seed)
    X = syn.random_points(rng, n)
    pts, mask = syn.observe(X, Rs, ts, rig, noise_px=0.3, rng=rng)
    return [[pts[f, c].tolist() if mask[f, c] else [None, None]
             for c in range(rig.num_cameras)] for f in range(n)]


def _jax_engine(rig, **cfg):
    from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
    from low_cost_mocap_tpu.config import RigConfig as JRigConfig
    from low_cost_mocap_tpu.runtime.engine import Engine as JEngine
    from low_cost_mocap_tpu.runtime.serial_link import \
        CollectingLink as JCollectingLink

    return JEngine(JRigConfig(num_cameras=rig.num_cameras,
                              image_size=rig.image_size),
                   JEngineConfig(**cfg), None, JCollectingLink(),
                   fast_path=False)


def _rel_rots(poses):
    Rs = np.asarray([p["R"] for p in poses])
    return np.einsum("cij,kj->cik", Rs, Rs[0])


def test_calculate_camera_pose_event_matches_jax_engine():
    """50 wand frames through both engines: the same progress events
    (``ba_iters`` 8, 16) and a final event, errors under 1 px², and the
    same relative rotations (to 1e-2: the two engines draw their RANSAC
    samples from different generators) — which are the rig's own."""
    Rs, ts, rig, src = _rig_source()
    cfg = dict(ransac_iters=128, ba_max_iters=16)
    captured = _wand_capture(rig, Rs, ts)
    got = {}
    for name, eng in (("port", _cpu_engine(rig, EngineConfig(**cfg), src)),
                      ("jax", _jax_engine(rig, **cfg))):
        events = []
        eng.on("camera-pose", events.append)
        eng.handle("calculate-camera-pose", {"cameraPoints": captured})
        got[name] = events
        assert eng.camera_poses is not None
    port, jax_ = got["port"], got["jax"]
    assert [e.get("ba_iters") for e in port] == \
        [e.get("ba_iters") for e in jax_] == [8, 16, None]
    assert all(e["error"] is None for e in port[:-1])
    assert port[-1]["error"] < 1.0 and jax_[-1]["error"] < 1.0
    rel = _rel_rots(port[-1]["camera_poses"])
    assert np.abs(rel - _rel_rots(jax_[-1]["camera_poses"])).max() < 1e-2
    truth = np.einsum("cij,kj->cik", Rs, Rs[0])
    assert np.abs(rel - truth).max() < 1e-2
    # a fixed seed: the port's engine calibrates the same way every time
    eng = _cpu_engine(rig, EngineConfig(**cfg), src)
    again = []
    eng.on("camera-pose", again.append)
    eng.handle("calculate-camera-pose", {"cameraPoints": captured})
    assert again == port


def test_scale_floor_and_origin_events_match_jax_engine():
    Rs, ts, rig, src = _rig_source()
    rng = np.random.default_rng(1)
    base = rng.normal(size=(12, 3))
    d = rng.normal(size=(12, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True) * 0.05
    pairs = np.stack([base, base + d], axis=1).tolist() + [[[0, 0, 0]]]
    xy = rng.normal(size=(40, 2))
    cloud = np.column_stack([xy[:, 0], 0.1 * xy[:, 0] + 0.05 * xy[:, 1] + 0.3,
                             xy[:, 1]])
    got = {}
    for name, eng in (("port", _cpu_engine(rig, EngineConfig(), src)),
                      ("jax", _jax_engine(rig))):
        poses, mats = [], []
        eng.on("camera-pose", poses.append)
        eng.on("to-world-coords-matrix", mats.append)
        eng.handle("determine-scale", {
            "objectPoints": pairs,
            "cameraPoses": camera_poses_to_serializable(Rs, ts)})
        eng.handle("acquire-floor", {"objectPoints": [cloud[:20].tolist(),
                                                      cloud[20:].tolist()]})
        eng.handle("set-origin", {
            "objectPoint": [0.1, 0.2, 0.3],
            "toWorldCoordsMatrix": mats[-1]["to_world_coords_matrix"]})
        got[name] = (poses, mats, eng.to_world_matrix, eng.camera_poses)
    (pp, pm, pM, pcp), (jp, jm, jM, jcp) = got["port"], got["jax"]
    np.testing.assert_allclose(
        [p["t"] for p in pp[0]["camera_poses"]],
        [p["t"] for p in jp[0]["camera_poses"]], atol=1e-5)
    np.testing.assert_allclose(pcp[1], ts * 3.0, rtol=1e-5)   # 0.15 / 0.05
    assert len(pm) == len(jm) == 2
    for a, b in zip(pm, jm):
        np.testing.assert_allclose(a["to_world_coords_matrix"],
                                   b["to_world_coords_matrix"], atol=1e-5)
    np.testing.assert_allclose(pM, jM, atol=1e-5)


def _perturbed(Rs, ts, seed=7):
    rng = np.random.default_rng(seed)

    def small_rot(r):
        a, b, _ = r
        Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                       [0, np.sin(a), np.cos(a)]])
        Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                       [-np.sin(b), 0, np.cos(b)]])
        return (Rx @ Ry).astype(np.float32)

    Rs_p = np.stack([small_rot(rng.normal(scale=0.01, size=3)) @ R
                     for R in Rs]).astype(np.float32)
    ts_p = (ts + rng.normal(scale=0.01, size=ts.shape)).astype(np.float32)
    return Rs_p, ts_p


def _sweep_frame(i, rig, Rs, ts):
    """The drone swept through the volume on a script."""
    phase = 2 * np.pi * i / 40.0
    pos = np.array([0.35 * np.cos(phase), 0.35 * np.sin(phase),
                    0.6 + 0.15 * np.sin(2 * phase)], np.float32)
    pts, mask = syn.observe(syn.drone_markers(pos, 0.0, rig), Rs, ts, rig)
    return (syn.render_frames(pts, mask, rig.image_size, sigma=0.8)
            * 255).astype(np.uint8)


@pytest.mark.parametrize("extra", [
    dict(), dict(dispatch_batch=5), dict(dispatch_batch=5,
                                         batch_emit_thread=True)],
    ids=["per_frame", "batched", "emit_worker"])
def test_refine_camera_pose_halves_the_error(extra):
    """Live recalibration from slightly-off poses, as
    ``tests/test_runtime.py`` checks the JAX engine: the median error of
    the points served afterwards at least halves.  Batched serving, inline
    or through the emit worker, collects the same observations and so
    refines to the same poses as per-frame serving."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    Rs_p, ts_p = _perturbed(Rs, ts)
    frames = [_sweep_frame(i, rig, Rs, ts) for i in range(40)]
    src = SyntheticSource(rig, Rs, ts, num_drones=0)
    results = []
    for cfg in (EngineConfig(), EngineConfig(**extra)):
        eng = _cpu_engine(rig, cfg, src)
        events, poses = [], []
        eng.on("object-points", events.append)
        eng.on("camera-pose", poses.append)
        eng.handle("triangulate-points", {
            "startOrStop": "start",
            "cameraPoses": camera_poses_to_serializable(Rs_p, ts_p),
            "toWorldCoordsMatrix": np.eye(4).tolist()})
        eng.handle("refine-camera-pose", {"startOrStop": "start"})
        for f in frames[:30]:
            eng.process_frame(f, 1 / 60)
        eng.flush_batches()
        before = float(np.median([e for ev in events for e in ev["errors"]]))
        eng.handle("refine-camera-pose", {"startOrStop": "stop"})
        assert len(poses) == 1 and poses[0]["refined_from_points"] >= 30
        events.clear()
        for f in frames[30:]:
            eng.process_frame(f, 1 / 60)
        eng.flush_batches()
        eng.stop()
        after = float(np.median([e for ev in events for e in ev["errors"]]))
        assert after < before * 0.5, (before, after)
        assert after < 0.3
        results.append(poses[0])
        if not extra:
            break
    assert all(r == results[0] for r in results)


def test_refine_camera_pose_needs_a_calibration_and_points():
    Rs, ts, rig, src = _rig_source()
    eng = _cpu_engine(rig, EngineConfig(), src)
    poses = []
    eng.on("camera-pose", poses.append)
    eng.handle("refine-camera-pose", {"startOrStop": "start"})
    eng.handle("refine-camera-pose", {"startOrStop": "stop"})
    assert poses[-1]["refine_error"] == "not calibrated"
    eng.set_camera_poses(Rs, ts)
    eng.handle("refine-camera-pose", {"startOrStop": "stop"})
    assert poses[-1]["refine_error"] == "only 0 usable points"


def test_calibrate_intrinsics_event_applies_and_persists(tmp_path):
    """The calibrate-intrinsics event end to end, as
    ``tests/test_intrinsics.py`` drives the JAX engine: rendered dot-grid
    frames in, views with progress events, K within 3% applied to the live
    rig and persisted, and reloaded by a fresh engine."""
    cv2 = pytest.importorskip("cv2")
    from low_cost_mocap_tpu_torch.ops.intrinsics import make_grid

    Rs, ts, rig = syn.ring_rig(num_cameras=2)
    src = SyntheticSource(rig, Rs, ts, num_drones=0)
    eng = _cpu_engine(rig, EngineConfig(), src, artifacts_dir=str(tmp_path))
    eng.set_camera_poses(Rs, ts)
    rows, cols, spacing = 4, 5, 0.05
    board = make_grid(rows, cols, spacing).astype(np.float64)
    obj3 = np.concatenate([board, np.zeros((len(board), 1))], axis=-1)
    S = rig.image_size
    K_t = np.array([[0.8 * S, 0.0, S / 2 + 3.0], [0.0, 0.79 * S, S / 2 - 4.0],
                    [0.0, 0.0, 1.0]])
    got = {"views": 0, "result": None}
    eng.on("intrinsics-views", lambda d: got.__setitem__("views", d["views"]))
    eng.on("camera-intrinsics", lambda d: got.__setitem__("result", d))
    eng.handle("calibrate-intrinsics",
               {"startOrStop": "start", "cameraIndex": 0, "rows": rows,
                "cols": cols, "spacing": spacing})
    rng = np.random.default_rng(9)
    fed = 0
    while fed < 10 and got["views"] < 6:
        rvec = np.deg2rad(rng.uniform(-25, 25, size=3) * [1, 1, 0.7])
        t = np.array([-0.10 + rng.uniform(-0.02, 0.02),
                      -0.08 + rng.uniform(-0.02, 0.02),
                      rng.uniform(0.5, 0.7)])
        uv = cv2.projectPoints(obj3, rvec, t, K_t, np.zeros(5))[0].reshape(
            -1, 2)
        if not ((uv > 4).all() and (uv < S - 5).all()):
            continue
        f0 = syn.render_frames(uv[:, None, :].astype(np.float32),
                               np.ones((len(uv), 1), bool), S, sigma=1.2)
        frames = np.zeros((rig.num_cameras, S, S), np.uint8)
        frames[0] = (f0[0] * 255).astype(np.uint8)
        eng.process_frame(frames, 1 / 60)
        fed += 1
    assert got["views"] >= 3
    eng.handle("calibrate-intrinsics", {"startOrStop": "stop"})
    res = got["result"]
    assert res["error"] is None and res["applied"]
    K = np.asarray(res["K"])
    np.testing.assert_allclose(K[0, 0], K_t[0, 0], rtol=0.03)
    np.testing.assert_allclose(K[1, 1], K_t[1, 1], rtol=0.03)
    np.testing.assert_allclose(eng.rig.cameras[0].K(), K, rtol=1e-5)
    np.testing.assert_allclose(eng._K[0].numpy(), K, rtol=1e-5)
    # the projection matrices follow the new K
    Ps = eng._K @ torch.cat([torch.as_tensor(Rs),
                             torch.as_tensor(ts)[..., None]], -1)
    np.testing.assert_allclose(eng._Ps.numpy(), Ps.numpy(), rtol=1e-6)
    again = _cpu_engine(rig, EngineConfig(), src, artifacts_dir=str(tmp_path))
    np.testing.assert_allclose(again.rig.cameras[0].K(), K, rtol=1e-5)
    # too few views: an error event, nothing applied
    eng.handle("calibrate-intrinsics", {"startOrStop": "start"})
    eng.handle("calibrate-intrinsics", {"startOrStop": "stop"})
    assert "only 0 usable views" in got["result"]["error"]
