"""PyTorch port: the Socket.IO server and the ``serve`` launcher, on a CPU
engine.  Mirrors ``tests/test_server.py`` against the port's server: the
websocket and polling handshakes and the upgrade, the event round trip,
the error reply to unknown and unported events, the trajectory route,
MJPEG, 404 and ``ui_decimation``."""

import http.client
import json
import socket
import time

import numpy as np
import pytest
import torch

from low_cost_mocap_tpu_torch import serve
from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.runtime import wsproto
from low_cost_mocap_tpu_torch.runtime.engine import Engine
from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
from low_cost_mocap_tpu_torch.runtime.server import MocapServer
from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
from low_cost_mocap_tpu_torch.utils import synthetic as syn

torch.set_num_threads(1)


class SioClient:
    """Minimal Socket.IO-over-WebSocket client (stdlib only)."""

    def __init__(self, host, port, timeout=5.0, query=""):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.parser = wsproto.FrameParser()
        self.packets = []
        key = "dGhlIHNhbXBsZSBub25jZQ=="
        req = (f"GET /socket.io/?EIO=4&transport=websocket{query} HTTP/1.1\r\n"
               f"Host: {host}:{port}\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
               f"Sec-WebSocket-Version: 13\r\n\r\n")
        self.sock.sendall(req.encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += self.sock.recv(4096)
        head, rest = buf.split(b"\r\n\r\n", 1)
        assert b"101" in head.split(b"\r\n")[0], head
        assert wsproto.accept_key(key).encode() in head
        if rest:
            self.packets += [p.decode() for op, p in self.parser.feed(rest)
                             if op == 0x1]

    def _pump(self, deadline):
        try:
            self.sock.settimeout(max(deadline - time.time(), 0.05))
            data = self.sock.recv(65536)
        except socket.timeout:
            return
        for op, p in self.parser.feed(data):
            if op == 0x1:
                self.packets.append(p.decode())

    def wait_packet(self, pred, timeout=5.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for p in self.packets:
                if pred(p):
                    return p
            self._pump(deadline)
        raise TimeoutError(f"no packet matching; got {self.packets[-5:]}")

    def send_text(self, text: str):
        self.sock.sendall(wsproto.encode_frame(text.encode(), mask=True))

    def emit(self, event, data):
        self.send_text(wsproto.sio_event(event, data))

    def events(self, name):
        out = []
        for p in self.packets:
            evt = wsproto.parse_sio_event(p)
            if evt and evt[0] == name:
                out.append(evt[1][0] if evt[1] else None)
        return out

    def connect(self):
        self.wait_packet(lambda p: p.startswith("0{"))   # engine.io open
        self.send_text("40")
        self.wait_packet(lambda p: p.startswith("40{"))  # socket.io ack
        return self

    def close(self):
        self.sock.close()


class PollingClient:
    """Engine.IO v4 HTTP long-polling client (the default first transport
    of socket.io-client)."""

    def __init__(self, host, port, timeout=10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self.n = 0
        packets = self.get(sid=None)
        open_pkts = [p for p in packets if p.startswith("0")]
        assert open_pkts, packets
        self.handshake = json.loads(open_pkts[0][1:])
        self.sid = self.handshake["sid"]

    def _url(self, sid):
        self.n += 1
        url = f"/socket.io/?EIO=4&transport=polling&t=t{self.n}"
        return url + (f"&sid={sid}" if sid else "")

    def get(self, sid="default"):
        sid = self.sid if sid == "default" else sid
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        conn.request("GET", self._url(sid))
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        body = resp.read().decode()
        conn.close()
        return [p for p in body.split("\x1e") if p]

    def post(self, *packets):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        conn.request("POST", self._url(self.sid), "\x1e".join(packets),
                     {"Content-Type": "text/plain; charset=UTF-8"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        return resp.status, body

    def wait_packet(self, pred, timeout=5.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for p in self.get():
                if pred(p):
                    return p
        raise TimeoutError("no matching packet over polling")


def _engine(**cfg):
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    source = SyntheticSource(rig, Rs, ts, num_drones=1)
    eng = Engine(rig, EngineConfig(**cfg), source, CollectingLink(),
                 host_detect=True, device="cpu")
    return eng, source, Rs, ts


@pytest.fixture(scope="module")
def server():
    eng, source, _, _ = _engine()
    srv = MocapServer(eng, port=0)
    srv.start()
    yield srv, eng, source
    srv.stop()


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def test_socketio_handshake_and_event_roundtrip(server):
    srv, eng, source = server
    c = SioClient("127.0.0.1", srv.port).connect()
    c.emit("capture-points", {"startOrStop": "start"})
    assert _wait(lambda: eng.is_capturing_points)
    eng.process_frame(source.read(), 1 / 60)
    c.wait_packet(lambda p: p.startswith('42["image-points"'))
    eng.handle("capture-points", {"startOrStop": "stop"})
    c.close()


def test_polling_default_client_handshake(server):
    srv, eng, source = server
    c = PollingClient("127.0.0.1", srv.port)
    assert "websocket" in c.handshake["upgrades"]
    assert c.handshake["pingInterval"] > 0
    status, body = c.post("40")
    assert status == 200 and body == b"ok"
    ack = c.wait_packet(lambda p: p.startswith("40{"))
    assert json.loads(ack[2:])["sid"]
    c.post(wsproto.sio_event("capture-points", {"startOrStop": "start"}))
    assert _wait(lambda: eng.is_capturing_points)
    eng.process_frame(source.read(), 1 / 60)
    c.wait_packet(lambda p: p.startswith('42["image-points"'))
    eng.handle("capture-points", {"startOrStop": "stop"})
    status, _ = c.post("3")             # heartbeat pong
    assert status == 200
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
    conn.request("GET", "/socket.io/?EIO=4&transport=polling&sid=nope")
    assert conn.getresponse().status == 400
    conn.close()
    c.post("1")                         # engine.io close


def test_polling_upgrade_to_websocket(server):
    srv, eng, source = server
    c = PollingClient("127.0.0.1", srv.port)
    c.post("40")
    c.wait_packet(lambda p: p.startswith("40{"))
    ws = SioClient("127.0.0.1", srv.port, query=f"&sid={c.sid}")
    ws.send_text("2probe")
    ws.wait_packet(lambda p: p == "3probe")
    assert not any(p.startswith("0{") for p in ws.packets)
    ws.send_text("5")                   # commit the upgrade
    time.sleep(0.1)
    eng.emit("fps", {"fps": 42})
    ws.wait_packet(lambda p: (wsproto.parse_sio_event(p) or (None,))[0]
                   == "fps")
    assert c.get() == ["6"]             # a later poll releases with noop
    ws.emit("locate-objects", {"startOrStop": "start"})
    assert _wait(lambda: eng.is_locating_objects)
    eng.handle("locate-objects", {"startOrStop": "stop"})
    ws.close()


@pytest.mark.parametrize("event", ["bogus-event", "capture-profile"])
def test_unknown_and_unported_events_return_server_error(server, event):
    """An unknown event, and an event whose handler raises (a profile of
    no duration), get ``server-error``."""
    srv, eng, source = server
    c = SioClient("127.0.0.1", srv.port).connect()
    c.emit(event, {"durationMs": "soon"} if event == "capture-profile"
           else {"x": 1})
    p = c.wait_packet(lambda p: p.startswith('42["server-error"'))
    assert event in p
    # the connection and the engine go on serving
    c.emit("locate-objects", {"startOrStop": "start"})
    assert _wait(lambda: eng.is_locating_objects)
    eng.handle("locate-objects", {"startOrStop": "stop"})
    c.close()


def test_object_points_stream_over_the_capture_loop(server):
    srv, eng, source = server
    c = SioClient("127.0.0.1", srv.port).connect()
    c.emit("triangulate-points", {
        "startOrStop": "start",
        "cameraPoses": [{"R": R.tolist(), "t": t.tolist()}
                        for R, t in zip(source.Rs, source.ts)]})
    c.emit("locate-objects", {"startOrStop": "start"})
    eng.start()
    try:
        deadline = time.time() + 20
        while (time.time() < deadline and not any(
                e["filtered_objects"] for e in c.events("object-points"))):
            c._pump(deadline)
    finally:
        eng.stop()
        eng.handle("triangulate-points", {"startOrStop": "stop"})
        eng.handle("locate-objects", {"startOrStop": "stop"})
    assert any(e["filtered_objects"] for e in c.events("object-points"))
    c.close()


def test_trajectory_planning_endpoint(server):
    srv, eng, source = server
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    body = json.dumps({
        "waypoints": [[0, 0, 0.5, 1, 1, 0.5, True],
                      [1, 0, 0.5, 0, 0, 0.5, True]],
        "maxVel": [1.0, 1.0, 1.0], "maxAccel": [1.0, 1.0, 1.0],
        "maxJerk": [4.0, 4.0, 4.0], "timestep": 0.05})
    conn.request("POST", "/api/trajectory-planning", body,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    sp = np.asarray(json.loads(resp.read())["setpoints"])
    assert sp.shape[1] == 6
    np.testing.assert_allclose(sp[-1], [1, 0, 0.5, 0, 0, 0.5], atol=1e-6)
    conn.close()
    # the same plan as the JAX package's planner
    from low_cost_mocap_tpu.models.trajectory import \
        plan_waypoint_route as jplan
    want = jplan(json.loads(body)["waypoints"], [1.0] * 3, [1.0] * 3,
                 [4.0] * 3, 0.05, num_objects=2)
    np.testing.assert_array_equal(sp, np.asarray(want))


def test_mjpeg_stream_and_console_and_404(server):
    srv, eng, source = server
    eng.process_frame(source.read(), 1 / 60)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request("GET", "/api/camera-stream")
    resp = conn.getresponse()
    assert resp.status == 200
    assert "multipart/x-mixed-replace" in resp.getheader("Content-Type")
    chunk = resp.read(16384)
    assert b"--frame" in chunk and b"image/" in chunk
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request("GET", "/")
    resp = conn.getresponse()
    assert resp.status == 200 and b"<html" in resp.read().lower()
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request("GET", "/definitely-not-here")
    assert conn.getresponse().status == 404
    conn.close()


def test_ui_decimation_thins_stream_events_only():
    eng, source, _, _ = _engine()
    srv = MocapServer(eng, port=0, ui_decimation=4)
    srv.start()
    try:
        c = SioClient("127.0.0.1", srv.port).connect()
        inproc = []
        eng.on("image-points", inproc.append)
        eng.handle("capture-points", {"startOrStop": "start"})
        for _ in range(8):
            eng.process_frame(source.read(), 1 / 60)
        assert len(inproc) == 8           # in-process listeners: every one
        deadline = time.time() + 5
        while len(c.events("image-points")) < 2 and time.time() < deadline:
            c._pump(deadline)
        assert len(c.events("image-points")) == 2   # frames 0 and 4
        for i in range(3):                # other events pass undecimated
            eng.emit("link-health", {"n": i})
        deadline = time.time() + 5
        while len(c.events("link-health")) < 3 and time.time() < deadline:
            c._pump(deadline)
        assert len(c.events("link-health")) == 3
        c.close()
    finally:
        srv.stop()


def test_serve_builds_on_the_card_by_default(monkeypatch, tmp_path):
    args = serve.parse_args(["--port", "0", "--link", "none",
                             "--artifacts-dir", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build(args)
    engine, server, source, link = serve.build(args, device="cpu")
    assert engine.device.type == "cpu" and engine.camera_poses is not None
    assert engine.cfg.readback_pipeline_depth == serve.READBACK_DEPTH
    assert (tmp_path / "calibration.json").exists()
    # camera-sharded serving needs the cards, or the CPU when asked
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build(serve.parse_args(["--cam-shards", "2"]))
    engine, *_ = serve.build(serve.parse_args(
        ["--cam-shards", "2", "--artifacts-dir", str(tmp_path)]),
        device="cpu")
    assert engine._mesh.shape == {"cam": 2} and engine.device.type == "cpu"
    # the body options are ported: a one-marker template is refused
    with pytest.raises(ValueError, match=">= 3 markers"):
        serve.build(serve.parse_args(["--body-markers", "[[0,0,0]]",
                                      "--artifacts-dir", str(tmp_path)]),
                    device="cpu")
    engine, *_ = serve.build(serve.parse_args(
        ["--body-sets", "[]", "--artifacts-dir", str(tmp_path)]),
        device="cpu")
    assert engine._layout[4] == 0
