"""PyTorch port: server-side run-trajectory, the fly-to-start gate and the
timed drip, on a CPU engine.  Mirrors ``tests/test_trajectory_run.py``,
and holds the port's link sends and ``trajectory-status`` events equal to
the JAX engine's on the same frames, per frame and at ``dispatch_batch``
4 (inline and with the emit worker)."""

import json

import numpy as np
import pytest
import torch

from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.runtime.engine import (
    Engine, camera_poses_to_serializable)
from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)


def _start_tracking(eng, Rs, ts):
    eng.handle("triangulate-points", {
        "startOrStop": "start",
        "cameraPoses": camera_poses_to_serializable(Rs, ts),
        "toWorldCoordsMatrix": np.eye(4).tolist()})
    eng.handle("locate-objects", {"startOrStop": "start"})


def _tracking_engine(cfg=None):
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    source = SyntheticSource(rig, Rs, ts, num_drones=1, orbit_hz=0.0)
    link = CollectingLink()
    eng = Engine(rig, cfg or EngineConfig(), source, link, device="cpu",
                 host_detect=True)
    _start_tracking(eng, Rs, ts)
    out = None
    for _ in range(5):
        out = eng.process_frame(source.read_at(0.0), 1 / 60)
    d = int(np.argmax(out.tracked.valid))
    assert out.tracked.valid[d]
    w = out.tracked.pos[d]
    fw = [float(w[0]), float(w[2]), float(w[1])]   # world -> firmware
    return eng, source, link, d, fw


def _row(n_objects, d, xyz):
    row = [0.0] * (3 * n_objects)
    row[3 * d:3 * d + 3] = [float(v) for v in xyz]
    return row


def _setpoint_frames(link, drone):
    out = []
    for f in link.frames:
        if int(chr(f[0])) != drone:
            continue
        payload = json.loads(f[1:])
        if "setpoint" in payload:
            out.append(payload["setpoint"])
    return out


def test_fly_to_start_gates_execution():
    eng, source, link, d, fw = _tracking_engine()
    statuses = []
    eng.on("trajectory-status", statuses.append)
    start = [fw[0] + 1.0, fw[1], fw[2]]
    mid = [fw[0] + 1.2, fw[1], fw[2]]
    n = eng.rig.num_objects
    sps = [_row(n, d, start), _row(n, d, mid)] * 5
    link.frames.clear()
    eng.handle("run-trajectory", {"setpoints": sps, "timestep": 0.05,
                                  "droneIndices": [d], "arrivalTol": 0.12,
                                  "arrivalTimeout": 0.5})
    assert statuses[-1]["phase"] == "fly-to-start"
    for _ in range(20):          # 0.33 s, under the timeout
        eng.process_frame(source.read_at(0.0), 1 / 60)
    sent = _setpoint_frames(link, d)
    # only the start setpoint was commanded: no drip, no step input
    assert sent and all(sp == start for sp in sent)
    assert statuses[-1]["phase"] == "fly-to-start"
    for _ in range(15):          # the drone never arrives: timeout
        eng.process_frame(source.read_at(0.0), 1 / 60)
    assert statuses[-1]["phase"] == "aborted"
    assert "timeout" in statuses[-1]["reason"]


def test_execution_drips_in_order_when_already_at_start():
    eng, source, link, d, fw = _tracking_engine()
    statuses = []
    eng.on("trajectory-status", statuses.append)
    T = 12
    plan = [[fw[0] + 0.01 * k, fw[1], fw[2]] for k in range(T)]
    sps = [_row(eng.rig.num_objects, d, p) for p in plan]
    link.frames.clear()
    eng.handle("run-trajectory", {"setpoints": sps, "timestep": 1 / 60,
                                  "droneIndices": [d], "arrivalTol": 0.2})
    for _ in range(T + 3):
        eng.process_frame(source.read_at(0.0), 1 / 60)
    phases = [s["phase"] for s in statuses]
    assert phases == ["fly-to-start", "executing", "done"]
    sent = _setpoint_frames(link, d)
    assert sent == plan     # the gate commanded plan[0], then the drip
    eng.handle("run-trajectory", {"startOrStop": "stop"})
    assert statuses[-1]["phase"] == "done"     # stop after done is a no-op
    with pytest.raises(ValueError, match="timestep"):
        eng.handle("run-trajectory", {"setpoints": sps, "timestep": 0})
    with pytest.raises(ValueError, match="droneIndices"):
        eng.handle("run-trajectory", {"setpoints": sps, "droneIndices": [5]})


def test_stop_cancels_run():
    eng, source, link, d, fw = _tracking_engine()
    statuses = []
    eng.on("trajectory-status", statuses.append)
    sps = [_row(eng.rig.num_objects, d, [fw[0] + 1.0, fw[1], fw[2]])] * 3
    eng.handle("run-trajectory", {"setpoints": sps, "timestep": 0.05,
                                  "droneIndices": [d]})
    eng.process_frame(source.read_at(0.0), 1 / 60)
    eng.handle("run-trajectory", {"startOrStop": "stop"})
    assert statuses[-1]["phase"] == "stopped"
    before = len(link.frames)
    eng.process_frame(source.read_at(0.0), 1 / 60)
    assert len(link.frames) == before


def test_server_forwards_trajectory_status():
    from low_cost_mocap_tpu_torch.runtime.server import MocapServer

    eng, source, link, d, fw = _tracking_engine()
    srv = MocapServer(eng, port=0)
    assert "trajectory-status" in {ev for ev, _ in srv._event_cbs}
    assert not eng._listeners.get("trajectory-status")   # idle: detached

    class _FakeClient:
        def __init__(self):
            self.sent = []

        def send_text(self, text):
            self.sent.append(text)
            return True

    c = _FakeClient()
    srv._add_client(c)
    eng.handle("run-trajectory", {
        "setpoints": [_row(eng.rig.num_objects, d, fw)], "droneIndices": [d]})
    assert any("trajectory-status" in t for t in c.sent)
    srv._remove_client(c)
    assert not eng._listeners.get("trajectory-status")


def _jax_engine(rig):
    from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
    from low_cost_mocap_tpu.config import RigConfig as JRigConfig
    from low_cost_mocap_tpu.runtime.engine import Engine as JEngine
    from low_cost_mocap_tpu.runtime.serial_link import \
        CollectingLink as JCollectingLink

    return JEngine(JRigConfig(num_cameras=rig.num_cameras,
                              image_size=rig.image_size), JEngineConfig(),
                   None, JCollectingLink(), fast_path=True, host_detect=True)


@pytest.mark.parametrize("extra", [
    dict(), dict(dispatch_batch=4), dict(dispatch_batch=4,
                                         batch_emit_thread=True)],
    ids=["per_frame", "batched", "emit_worker"])
def test_link_sends_and_status_match_the_jax_engine(extra):
    """The same frames through the JAX engine (per frame) and the port's:
    the drone link's bytes and the status events are equal.  The plan
    starts after a whole batch, so the batched engine ticks the same
    frames as the per-frame ones, a batch later and in order."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi),
                          orbit_hz=0.0)
    frames = [src.read_at(0.0)] * 16
    engines = {"port": Engine(rig, EngineConfig(**extra), src,
                              CollectingLink(), device="cpu",
                              host_detect=True),
               "jax": _jax_engine(rig)}
    plan, got = None, {}
    for name, e in engines.items():
        statuses = []
        e.on("trajectory-status", statuses.append)
        _start_tracking(e, Rs, ts)
        for f in frames[:4]:
            e.process_frame(f, 1 / 60)
        e.flush_batches()
        if plan is None:     # both drones start where the port tracks them
            pos = e._last_out.tracked.pos
            fw = [[float(p[0]), float(p[2]), float(p[1])] for p in pos]
            plan = [[fw[0][0] + 0.01 * k, fw[0][1], fw[0][2]] + fw[1]
                    for k in range(8)]
        e.link.frames.clear()
        e.handle("run-trajectory", {"setpoints": plan, "timestep": 1 / 60,
                                    "arrivalTol": 0.04})
        for f in frames[4:]:
            e.process_frame(f, 1 / 60)
        e.flush_batches()
        e.stop()
        got[name] = (list(e.link.frames), statuses)
    assert [s["phase"] for s in got["port"][1]] == ["fly-to-start",
                                                    "executing", "done"]
    assert got["port"] == got["jax"]
    # the gate's command to both drones, then seven drips to each
    assert len(got["port"][0]) == 2 + 2 * 7
