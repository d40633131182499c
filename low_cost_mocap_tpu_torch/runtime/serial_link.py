"""Drone command link: the reference's serial wire protocol, abstracted.

Wire format: ``"<droneIndex digit><json>"`` at 1 Mbaud
(``computer_code/api/helpers.py:121``, ``computer_code/api/index.py:21``),
guarded by a lock (``computer_code/api/index.py:19``).

Implementations:
  - ``LoopbackLink``: feeds frames straight into the native cascade bank +
    simulator — full software-in-the-loop without radios;
  - ``CollectingLink``: records frames for tests;
  - ``PyserialLink``: real dongle via pyserial (gated import).

The port's own copy of ``low_cost_mocap_tpu/runtime/serial_link.py``;
``LoopbackLink`` runs over the port's native library (``control/``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Protocol


class SerialLink(Protocol):
    def send(self, drone_index: int, payload: dict) -> None:
        ...

    def close(self) -> None:
        ...


class CollectingLink:
    """Test double: records every frame."""

    def __init__(self):
        self.frames: list[bytes] = []
        self._lock = threading.Lock()

    def send(self, drone_index: int, payload: dict) -> None:
        with self._lock:
            self.frames.append(f"{drone_index}{json.dumps(payload)}".encode())

    def close(self) -> None:
        pass


class LoopbackLink:
    """Software-in-the-loop: commands drive the native cascade + simulator.

    Replaces the radio chain (serial -> sender ESP32 -> ESP-NOW -> receiver
    ESP32, SURVEY.md §2.2) with the host-side native runtime for closed-loop
    testing without hardware.
    """

    def __init__(self, num_drones: int):
        from low_cost_mocap_tpu_torch.control import (CascadeBank,
                                                      DroneSimulator)

        self.bank = CascadeBank(num_drones)
        self.sims = [DroneSimulator() for _ in range(num_drones)]
        for sim in self.sims:
            sim.set_state([0.0, 0.0, 0.04])
        self.num_drones = num_drones
        self._lock = threading.Lock()
        # Simulated clock, advanced by exactly dt per tick().  The cascade
        # derives its PID dt and the 2 s ping failsafe from these timestamps
        # (cascade.cc Step/OnCommand), so stamping with wall-clock time would
        # couple the *simulated* control loop to host execution speed —
        # slower-than-real-time test runs then see inflated PID dt and
        # spurious failsafe disarms (nondeterministic flight).
        self._sim_us = 0

    def send(self, drone_index: int, payload: dict) -> None:
        with self._lock:
            frame = f"{drone_index}{json.dumps(payload)}".encode()
            self.bank.feed(frame, self._sim_us)

    def tick(self, dt: float) -> None:
        """Advance cascades + simulators by dt (call at control rate)."""
        with self._lock:
            self._sim_us += int(dt * 1e6)
            for i, sim in enumerate(self.sims):
                ch = self.bank.step(i, self._sim_us)
                sim.step(ch, dt)

    def drone_state(self, i: int):
        return self.sims[i].get_state()

    def close(self) -> None:
        pass


class PyserialLink:
    """Real 1 Mbaud dongle link (``computer_code/api/index.py:21``).

    ``send`` is NON-blocking: frames go to a writer thread, so a wedged
    dongle can never throttle the vision loop (the reference writes
    inline under a lock with a 1 s write timeout — ``helpers.py:113-122``,
    ``index.py:21`` — which turns a stuck dongle into a ~1 fps pipeline).
    Queueing policy:

    - command frames (armed / pid / trim / setpoint) queue FIFO and are
      re-queued at the front on a write failure — they must not be lost;
    - pose+vel feeds occupy a LATEST-ONLY slot per drone — a recovering
      dongle resumes with the current pose, never a backlog of stale ones.

    Health: after ``stall_after_s`` without a successful write the state
    flips to "stalled" and ``on_health`` fires (the engine surfaces it as
    a ``link-health`` event and disarms its local arm mirror — the
    firmware's own 2 s ping failsafe, ``receiver_esp32.ino:213-215``, has
    by then cut the motors anyway).  A later successful write flips back
    to "ok".

    ``serial_module`` injects a fake for tests (hardware-free coverage of
    the framing, pacing, stall and recovery paths).
    """

    def __init__(self, device: str, baud: int = 1_000_000, *,
                 serial_module=None, write_timeout: float = 0.25,
                 stall_after_s: float = 0.5, on_health=None,
                 pacing_s: float = 0.001):
        if serial_module is None:  # pragma: no cover - hardware path
            try:
                import serial as serial_module  # type: ignore
            except ImportError as e:
                raise RuntimeError("pyserial is not installed") from e
        self._ser = serial_module.Serial(device, baud,
                                         write_timeout=write_timeout)
        self.on_health = on_health
        self._stall_after_s = float(stall_after_s)
        self._pacing_s = float(pacing_s)
        self._cv = threading.Condition()
        self._cmd_q: list[bytes] = []
        self._pose: dict[int, bytes] = {}
        self._state = "ok"
        self._errors = 0
        self._sent = 0
        self._inflight = False
        self._last_ok = time.monotonic()
        self._stop = False
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public

    def send(self, drone_index: int, payload: dict) -> None:
        frame = f"{drone_index}{json.dumps(payload)}".encode()
        with self._cv:
            if "pos" in payload:
                self._pose[int(drone_index)] = frame
            else:
                self._cmd_q.append(frame)
                if len(self._cmd_q) > 256:   # bounded: drop oldest
                    self._cmd_q.pop(0)
            self._cv.notify()

    def health(self) -> dict:
        with self._cv:
            return {
                "state": self._state,
                "consecutive_errors": self._errors,
                "sent": self._sent,
                "since_last_ok_s": time.monotonic() - self._last_ok,
                "queued_commands": len(self._cmd_q),
                "queued_poses": len(self._pose),
            }

    def flush(self, timeout: float = 1.0) -> bool:
        """Wait until both queues drain AND no frame is mid-write
        (tests / orderly shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                if not self._cmd_q and not self._pose and not self._inflight:
                    return True
            time.sleep(0.002)
        return False

    def close(self) -> None:
        # best-effort drain: an accepted command (e.g. a final disarm) must
        # not be silently dropped by shutdown; a stalled dongle still
        # bounds close() at the flush timeout
        self.flush(timeout=1.0)
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=2.0)
        self._ser.close()

    # ------------------------------------------------------------ writer

    def _set_state(self, state: str) -> None:
        fire = None
        with self._cv:
            if state != self._state:
                self._state = state
                fire = self.on_health
        if fire is not None:
            fire(self.health())

    def _writer(self) -> None:
        while True:
            with self._cv:
                while (not self._stop and not self._cmd_q
                       and not self._pose):
                    self._cv.wait(0.1)
                if self._stop:
                    return
                is_cmd = bool(self._cmd_q)
                if is_cmd:
                    frame = self._cmd_q.pop(0)
                else:
                    frame = self._pose.pop(next(iter(self._pose)))
                self._inflight = True
            try:
                self._ser.write(frame)
                if self._pacing_s:
                    # pacing as the reference does (helpers.py:122)
                    time.sleep(self._pacing_s)
                with self._cv:
                    self._errors = 0
                    self._sent += 1
                    self._last_ok = time.monotonic()
                    self._inflight = False
                self._set_state("ok")
            except Exception:
                with self._cv:
                    self._errors += 1
                    self._inflight = False
                    if is_cmd:        # commands must survive a hiccup
                        self._cmd_q.insert(0, frame)
                    stalled = (time.monotonic() - self._last_ok
                               > self._stall_after_s)
                if stalled:
                    self._set_state("stalled")
                # real writes block for write_timeout before failing; a
                # fast-failing (unplugged) device needs explicit backoff so
                # the retry loop doesn't spin a core
                time.sleep(0.01)
