"""Minimal RFC 6455 WebSocket framing + Engine.IO/Socket.IO v4 helpers.

The reference's API surface is Socket.IO events over a Flask-SocketIO server
(``computer_code/api/index.py:23-25``, client at
``computer_code/src/shared/styles/scripts/socket.ts:3``).  This environment
has no flask/socketio packages, so the protocol is implemented directly on
the stdlib: enough of Engine.IO v4 (websocket transport only) and Socket.IO
v5 framing for the reference's React client (socket.io-client with
``transports: ["websocket"]``) to connect and exchange events.

Wire format summary:
  - WebSocket: standard handshake (Sec-WebSocket-Accept = b64(sha1(key +
    GUID))), client->server frames masked, server->client unmasked.
  - Engine.IO packet types (first char): 0 open, 2 ping, 3 pong, 4 message.
  - Socket.IO packets ride in Engine.IO messages: "40" connect,
    "42[event, data]" event.

The port's own copy of ``low_cost_mocap_tpu/runtime/wsproto.py``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import struct

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def accept_key(sec_websocket_key: str) -> str:
    digest = hashlib.sha1((sec_websocket_key + WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(payload: bytes, opcode: int = 0x1, mask: bool = False) -> bytes:
    """One WebSocket frame (FIN set). opcode 0x1 text, 0x2 binary, 0x8 close,
    0x9 ping, 0xA pong."""
    header = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0x00
    if n < 126:
        header.append(mask_bit | n)
    elif n < 65536:
        header.append(mask_bit | 126)
        header += struct.pack(">H", n)
    else:
        header.append(mask_bit | 127)
        header += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        header += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(header) + payload


class FrameParser:
    """Incremental WebSocket frame parser (handles masked + fragmented)."""

    def __init__(self):
        self._buf = bytearray()
        self._frag_opcode = None
        self._frag_data = bytearray()

    def feed(self, data: bytes):
        """Yields (opcode, payload) for each complete message."""
        self._buf += data
        out = []
        while True:
            frame = self._try_parse()
            if frame is None:
                break
            fin, opcode, payload = frame
            if opcode == 0x0:  # continuation
                self._frag_data += payload
                if fin and self._frag_opcode is not None:
                    out.append((self._frag_opcode, bytes(self._frag_data)))
                    self._frag_opcode = None
                    self._frag_data = bytearray()
            elif not fin:
                self._frag_opcode = opcode
                self._frag_data = bytearray(payload)
            else:
                out.append((opcode, payload))
        return out

    def _try_parse(self):
        buf = self._buf
        if len(buf) < 2:
            return None
        fin = bool(buf[0] & 0x80)
        opcode = buf[0] & 0x0F
        masked = bool(buf[1] & 0x80)
        n = buf[1] & 0x7F
        pos = 2
        if n == 126:
            if len(buf) < 4:
                return None
            n = struct.unpack(">H", bytes(buf[2:4]))[0]
            pos = 4
        elif n == 127:
            if len(buf) < 10:
                return None
            n = struct.unpack(">Q", bytes(buf[2:10]))[0]
            pos = 10
        if masked:
            if len(buf) < pos + 4 + n:
                return None
            key = bytes(buf[pos:pos + 4])
            pos += 4
            payload = bytes(b ^ key[i % 4]
                            for i, b in enumerate(bytes(buf[pos:pos + n])))
        else:
            if len(buf) < pos + n:
                return None
            payload = bytes(buf[pos:pos + n])
        del self._buf[:pos + n]
        return fin, opcode, payload


# ---------------------------------------------------------------------------
# Engine.IO / Socket.IO payloads
# ---------------------------------------------------------------------------


def eio_open(sid: str, ping_interval_ms: int = 25000,
             ping_timeout_ms: int = 20000, upgrades=()) -> str:
    return "0" + json.dumps({
        "sid": sid,
        "upgrades": list(upgrades),
        "pingInterval": ping_interval_ms,
        "pingTimeout": ping_timeout_ms,
        "maxPayload": 10_000_000,
    })


# Engine.IO v4 HTTP long-polling payload framing: packets joined by the
# U+001E record separator (one packet per GET response is also legal).
# This is the DEFAULT first transport of socket.io-client
# (``computer_code/src/shared/styles/scripts/socket.ts:3`` creates the
# client with default transports = ["polling", "websocket"]), served by
# flask-socketio in the reference (``computer_code/api/index.py:23-25``).
RECORD_SEP = "\x1e"


def encode_polling_payload(packets) -> bytes:
    return RECORD_SEP.join(packets).encode()


def decode_polling_payload(body: bytes) -> list[str]:
    text = body.decode()
    return [p for p in text.split(RECORD_SEP) if p]


def sio_connect_ack(sid: str) -> str:
    return "40" + json.dumps({"sid": sid})


def sio_event(event: str, *args) -> str:
    return "42" + json.dumps([event, *args])


def parse_sio_event(packet: str):
    """'42["event", data...]' -> (event, [args]) or None."""
    if not packet.startswith("42"):
        return None
    body = json.loads(packet[2:])
    return body[0], body[1:]
