"""HTTP + Socket.IO-compatible API server (stdlib only).

Reproduces the reference's L4 surface (``computer_code/api/index.py``):

  - Socket.IO events over WebSocket (the reference's 13 client events —
    SURVEY.md §2.3 — plus refine-camera-pose, learn-body-template,
    calibrate-intrinsics, record-frames, capture-profile and
    run-trajectory; server events: the reference's 5 plus metrics,
    camera-health, body-template, profile, recording, camera-intrinsics,
    intrinsics-views, trajectory-status, link-health and engine-error),
    speaking enough Engine.IO v4 / Socket.IO v5 for the reference's React
    client in websocket-only mode;
  - ``GET /api/camera-stream`` — multipart MJPEG montage
    (``computer_code/api/index.py:31-61``);
  - ``POST /api/trajectory-planning`` — jerk-limited route planning
    (``computer_code/api/index.py:63-84``).

No flask / flask-socketio dependency: the protocol subset needed is small
(see ``runtime/wsproto.py``).

The port's counterpart of ``low_cost_mocap_tpu/runtime/server.py``, bound
to the port's ``Engine``.  An event whose handler raises gets
the usual ``server-error`` reply, like an unknown event.
"""

from __future__ import annotations

import functools
import json
import socket
import threading
import time
import urllib.parse
import uuid
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from low_cost_mocap_tpu_torch.runtime import wsproto
from low_cost_mocap_tpu_torch.runtime.engine import Engine


def _encode_png_gray(img: np.ndarray) -> bytes:
    """Minimal PNG encoder (stdlib zlib) for the camera stream; used when
    OpenCV's JPEG encoder isn't available.  img: (H, W) uint8."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (len(data).to_bytes(4, "big") + tag + data
                + zlib.crc32(tag + data).to_bytes(4, "big"))

    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, 0, 0, 0, 0]))  # 8-bit grayscale
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def encode_frame_image(img: np.ndarray) -> tuple[bytes, str]:
    """(bytes, mime). JPEG via cv2 when present (display-only dependency),
    else stdlib PNG."""
    try:
        import cv2

        ok, buf = cv2.imencode(".jpg", img)
        if ok:
            return buf.tobytes(), "image/jpeg"
    except ImportError:
        pass
    return _encode_png_gray(img), "image/png"


class _Client:
    def __init__(self, handler: "_Handler"):
        self.handler = handler
        self.lock = threading.Lock()

    def send_text(self, text: str) -> bool:
        try:
            with self.lock:
                self.handler.wfile.write(
                    wsproto.encode_frame(text.encode(), opcode=0x1))
                self.handler.wfile.flush()
            return True
        except OSError:
            return False


class _PollSession:
    """One Engine.IO v4 HTTP long-polling session (default first transport
    of socket.io-client — ``socket.ts:3``; the reference serves it through
    flask-socketio, ``computer_code/api/index.py:23-25,326-327``).

    Doubles as a broadcast target: ``send_text`` enqueues for the next
    long-poll, or forwards straight to the WebSocket once the client
    upgrades (probe/upgrade handshake in ``MocapServer._serve_ws``).
    """

    PING_INTERVAL = 25.0
    PING_TIMEOUT = 20.0

    def __init__(self, sid: str):
        self.sid = sid
        self.queue: list[str] = []
        self.cond = threading.Condition()
        self.last_seen = time.time()
        self.connected = False          # socket.io "40" handshake done
        self.upgraded = False
        self.ws_client: _Client | None = None

    def send_text(self, text: str) -> bool:
        with self.cond:
            if self.upgraded and self.ws_client is not None:
                return self.ws_client.send_text(text)
            self.queue.append(text)
            self.cond.notify_all()
            return True

    def drain(self, hold_s: float) -> list[str]:
        """Long-poll: block until packets arrive, the session upgrades
        (release with an Engine.IO noop), or ``hold_s`` elapses (release
        with a server ping, which also drives the v4 heartbeat)."""
        with self.cond:
            deadline = time.time() + hold_s
            while (not self.queue and not self.upgraded
                   and time.time() < deadline):
                self.cond.wait(max(deadline - time.time(), 0.01))
            self.last_seen = time.time()
            if self.queue:
                packets, self.queue = self.queue, []
                return packets
            return ["6"] if self.upgraded else ["2"]

    def begin_upgrade(self, ws_client: _Client) -> None:
        """Probe accepted + "5" received: flush the polling queue over the
        socket and release any parked GET with a noop."""
        with self.cond:
            pending, self.queue = self.queue, []
            self.ws_client = ws_client
            self.upgraded = True
            self.cond.notify_all()
        for p in pending:
            ws_client.send_text(p)

    @property
    def expired(self) -> bool:
        ttl = self.PING_INTERVAL + self.PING_TIMEOUT
        with self.cond:
            if self.upgraded:
                return False        # lifetime now owned by the ws loop
            return time.time() - self.last_seen > ttl


class MocapServer:
    """Binds an Engine to the network surface."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 3001, ui_decimation: int = 1):
        self.engine = engine
        self.host = host
        self.port = port
        # Forward every Nth per-frame stream event (object-points /
        # image-points) to socket clients; all other events pass through
        # at full rate.  Default 1 = every frame (reference parity,
        # ``api/helpers.py:92,128-133`` emits per frame).  In batched
        # serving the engine can emit tens of thousands of frames/s —
        # far beyond what a browser scene consumes — and per-event JSON
        # encode + socket writes cost real serving throughput (measured
        # 8.8k -> 5.0k fps with one subscriber, engine_serving.py);
        # decimation is the documented lever when the subscriber is a UI,
        # not a recorder.  In-process listeners (recorders, the armed
        # pose feed) always see every frame regardless.
        self.ui_decimation = max(int(ui_decimation), 1)
        self._decim_count = {"object-points": 0, "image-points": 0}
        self._clients: set = set()          # _Client | _PollSession
        self._clients_lock = threading.Lock()
        self._sessions: dict[str, _PollSession] = {}
        self._sessions_lock = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

        # engine -> all socket.io clients (the reference's five server
        # events plus the new observability surface).  The subscriptions
        # are attached only while at least one client is connected: an
        # idle server must not make the engine build + JSON-encode every
        # per-frame payload (the engine gates payload construction on
        # listeners being present, runtime/engine.py _emit_frame_outputs).
        self._event_cbs = [
            (ev, functools.partial(self._on_engine_event, ev))
            for ev in ("image-points", "object-points", "camera-pose",
                       "to-world-coords-matrix", "fps", "metrics",
                       "engine-error", "body-template", "profile",
                       "recording", "camera-health", "camera-intrinsics",
                       "intrinsics-views", "trajectory-status",
                       "link-health")]
        self._subscribed = False

    # -------------------------------------------------------------- wiring

    def _on_engine_event(self, event: str, data) -> None:
        if self.ui_decimation > 1:
            n = self._decim_count.get(event)
            if n is not None:
                self._decim_count[event] = n + 1
                if n % self.ui_decimation:
                    return
        self.broadcast(event, data)

    def broadcast(self, event: str, data) -> None:
        with self._clients_lock:
            if not self._clients:
                return
            clients = list(self._clients)
        packet = wsproto.sio_event(event, data)
        dead = []
        for c in clients:
            if not c.send_text(packet):
                dead.append(c)
        if dead:
            with self._clients_lock:
                for c in dead:
                    self._clients.discard(c)
            self._sync_subscription()

    def _sync_subscription(self) -> None:
        """Attach/detach the engine->broadcast listeners to match whether
        any client is connected.  Caller must NOT hold _clients_lock."""
        with self._clients_lock:
            want = bool(self._clients)
            if want == self._subscribed:
                return
            self._subscribed = want
        if want:
            for ev, cb in self._event_cbs:
                self.engine.on(ev, cb)
        else:
            for ev, cb in self._event_cbs:
                self.engine.off(ev, cb)

    def _add_client(self, c: _Client) -> None:
        with self._clients_lock:
            self._clients.add(c)
        self._sync_subscription()

    def _remove_client(self, c: _Client) -> None:
        with self._clients_lock:
            self._clients.discard(c)
        self._sync_subscription()

    # -------------------------------------------------------------- server

    def start(self) -> None:
        server = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/socket.io/"):
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    if q.get("transport", ["polling"])[0] == "websocket":
                        server._serve_ws(self, q)
                    else:
                        server._serve_polling_get(self, q)
                elif self.path.startswith("/api/camera-stream"):
                    server._serve_mjpeg(self)
                elif self.path in ("/", "/index.html"):
                    server._serve_console(self)
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def do_POST(self):
                if self.path.startswith("/api/trajectory-planning"):
                    server._serve_trajectory(self)
                elif self.path.startswith("/socket.io/"):
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    server._serve_polling_post(self, q)
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # ----------------------------------------------------------- endpoints

    def _serve_console(self, handler: BaseHTTPRequestHandler) -> None:
        """The operator console (thin client over the same event surface —
        replaces the reference's React SPA, SURVEY.md §2.3)."""
        import pathlib

        page = (pathlib.Path(__file__).parent / "webui" / "index.html")
        body = page.read_bytes()
        handler.send_response(200)
        handler.send_header("Content-Type", "text/html; charset=utf-8")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _serve_ws(self, handler: BaseHTTPRequestHandler, q: dict) -> None:
        key = handler.headers.get("Sec-WebSocket-Key")
        if (handler.headers.get("Upgrade", "").lower() != "websocket"
                or key is None):
            handler.send_response(400)
            handler.send_header("Content-Length", "0")
            handler.end_headers()
            return
        handler.send_response(101, "Switching Protocols")
        handler.send_header("Upgrade", "websocket")
        handler.send_header("Connection", "Upgrade")
        handler.send_header("Sec-WebSocket-Accept", wsproto.accept_key(key))
        handler.end_headers()
        handler.close_connection = True

        client = _Client(handler)
        # transport upgrade from polling: the Engine.IO session already
        # exists — no new open packet; expect the probe/upgrade dance
        sid = q.get("sid", [None])[0]
        session = self._sessions.get(sid) if sid else None
        if sid is not None and session is None:
            client.send_text('4{"message":"Session ID unknown"}')
            return
        if session is None:
            sid = uuid.uuid4().hex[:16]
            client.send_text(wsproto.eio_open(sid))

        parser = wsproto.FrameParser()
        handler.connection.settimeout(30.0)
        try:
            while True:
                try:
                    data = handler.connection.recv(65536)
                except socket.timeout:
                    client.send_text("2")  # engine.io ping keeps idle alive
                    continue
                except OSError:
                    break              # peer reset/abort: normal teardown
                if not data:
                    break
                for opcode, payload in parser.feed(data):
                    if opcode == 0x8:  # close
                        return
                    if opcode == 0x9:  # ws ping -> pong
                        with client.lock:
                            handler.wfile.write(
                                wsproto.encode_frame(payload, opcode=0xA))
                        continue
                    if opcode != 0x1:
                        continue
                    text = payload.decode()
                    if text == "2":           # engine.io ping (client side)
                        client.send_text("3")
                    elif text == "3":         # pong
                        continue
                    elif text == "2probe":    # upgrade probe
                        client.send_text("3probe")
                    elif text == "5":         # upgrade commit
                        if session is not None:
                            session.begin_upgrade(client)
                    elif text == "40" or text.startswith("40{"):
                        # register BEFORE acking: a client that emits (or a
                        # broadcast that fires) right after seeing the ack
                        # must already be in the broadcast set
                        self._add_client(client)
                        client.send_text(wsproto.sio_connect_ack(sid))
                    else:
                        evt = wsproto.parse_sio_event(text)
                        if evt is not None:
                            name, args = evt
                            try:
                                self.engine.handle(
                                    name, args[0] if args else None)
                            except Exception as e:  # surface, don't die
                                client.send_text(wsproto.sio_event(
                                    "server-error",
                                    {"event": name, "error": str(e)}))
        finally:
            self._remove_client(client)
            if session is not None:
                self._remove_client(session)
                with self._sessions_lock:
                    self._sessions.pop(session.sid, None)

    # ------------------------------------------- Engine.IO HTTP polling

    def _respond_polling(self, handler, body: bytes, status: int = 200,
                         ctype: str = "text/plain; charset=UTF-8") -> None:
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Access-Control-Allow-Origin",
                            handler.headers.get("Origin", "*"))
        handler.send_header("Access-Control-Allow-Credentials", "true")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        try:
            handler.wfile.write(body)
        except OSError:
            pass

    def _reap_sessions(self) -> None:
        with self._sessions_lock:
            dead = [s for s in self._sessions.values() if s.expired]
            for s in dead:
                del self._sessions[s.sid]
        for s in dead:
            self._remove_client(s)

    def _serve_polling_get(self, handler, q: dict) -> None:
        """Engine.IO v4 polling GET: handshake (no sid) or long-poll drain.

        Conformance target: socket.io-client's default transport order
        tries THIS first (``socket.ts:3``); the reference serves it via
        flask-socketio (``computer_code/api/index.py:326-327``)."""
        self._reap_sessions()
        sid = q.get("sid", [None])[0]
        if sid is None:                       # open handshake
            sid = uuid.uuid4().hex[:16]
            session = _PollSession(sid)
            with self._sessions_lock:
                self._sessions[sid] = session
            open_pkt = wsproto.eio_open(
                sid, int(_PollSession.PING_INTERVAL * 1000),
                int(_PollSession.PING_TIMEOUT * 1000),
                upgrades=["websocket"])
            self._respond_polling(
                handler, wsproto.encode_polling_payload([open_pkt]))
            return
        session = self._sessions.get(sid)
        if session is None:
            self._respond_polling(
                handler, b'{"code":1,"message":"Session ID unknown"}', 400)
            return
        packets = session.drain(hold_s=min(
            _PollSession.PING_INTERVAL, 20.0))
        self._respond_polling(
            handler, wsproto.encode_polling_payload(packets))

    def _serve_polling_post(self, handler, q: dict) -> None:
        """Engine.IO v4 polling POST: client -> server packet batch."""
        sid = q.get("sid", [None])[0]
        session = self._sessions.get(sid) if sid else None
        if session is None:
            self._respond_polling(
                handler, b'{"code":1,"message":"Session ID unknown"}', 400)
            return
        length = int(handler.headers.get("Content-Length", 0))
        body = handler.rfile.read(length)
        session.last_seen = time.time()
        for text in wsproto.decode_polling_payload(body):
            if text == "3":               # heartbeat pong
                continue
            if text == "2":
                session.send_text("3")
            elif text == "40" or text.startswith("40{"):
                session.connected = True
                self._add_client(session)
                session.send_text(wsproto.sio_connect_ack(session.sid))
            elif text == "1":             # engine.io close
                with self._sessions_lock:
                    self._sessions.pop(session.sid, None)
                self._remove_client(session)
            else:
                evt = wsproto.parse_sio_event(text)
                if evt is not None:
                    name, args = evt
                    try:
                        self.engine.handle(name, args[0] if args else None)
                    except Exception as e:  # surface, don't die
                        session.send_text(wsproto.sio_event(
                            "server-error",
                            {"event": name, "error": str(e)}))
        self._respond_polling(handler, b"ok")

    def _serve_mjpeg(self, handler: BaseHTTPRequestHandler) -> None:
        handler.send_response(200)
        handler.send_header(
            "Content-Type", "multipart/x-mixed-replace; boundary=frame")
        handler.end_headers()
        interval = 1.0 / min(self.engine.cfg.target_fps, 30.0)  # display rate
        try:
            while True:
                strip = self.engine.latest_frame_strip()
                if strip is not None:
                    img, mime = encode_frame_image(strip)
                    handler.wfile.write(
                        b"--frame\r\nContent-Type: " + mime.encode()
                        + b"\r\n\r\n" + img + b"\r\n")
                    handler.wfile.flush()
                time.sleep(interval)
        except OSError:
            return

    def _serve_trajectory(self, handler: BaseHTTPRequestHandler) -> None:
        from low_cost_mocap_tpu_torch.models.trajectory import \
            plan_waypoint_route

        length = int(handler.headers.get("Content-Length", 0))
        data = json.loads(handler.rfile.read(length))
        setpoints = plan_waypoint_route(
            data["waypoints"], data["maxVel"], data["maxAccel"],
            data["maxJerk"], data["timestep"],
            num_objects=self.engine.rig.num_objects,
            blend=float(data.get("blend", 0.0)))
        body = json.dumps({"setpoints": setpoints}).encode()
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Access-Control-Allow-Origin", "*")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
