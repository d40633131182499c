"""Differential-parity loader for the reference implementation.

Imports the ACTUAL reference backend math (``computer_code/api/helpers.py``,
``KalmanFilter.py``, ``LowPassFilter.py`` from the read-only checkout at
``REFERENCE_API_DIR``, the JAX package's setting) so tests and the
accuracy harness can feed the reference and this framework IDENTICAL
detection streams and compare the reconstructed trajectories directly —
the strongest parity evidence available without camera hardware
(BASELINE.json: "match the reference backend's reconstructed marker
trajectories within its ATE bound").

Only the math path is imported; the hardware/IO seams are stubbed:

- ``pseyepy`` (the PS3-Eye C driver) is replaced by a stub whose ``Camera``
  exposes the attributes ``Cameras.__init__`` reads
  (``computer_code/api/helpers.py:24-26``): ``RES_SMALL`` and a
  4-entry ``exposure`` list (the reference derives ``num_cameras`` from
  ``len(cameras.exposure)``).
- ``KalmanFilter.predict_location`` timestamps measurements with
  ``time.time()`` (``computer_code/api/KalmanFilter.py:53-54``); the loader
  rebinds the module's ``time`` to a controllable :class:`FakeClock` so a
  test can step the reference tracker at an exact, reproducible dt.

Nothing from the reference is copied — the modules are imported from the
reference checkout itself and executed as-is.  The loaded modules are NOT
left in ``sys.modules`` (the generic names ``helpers``/``Singleton`` would
shadow anything else); each call returns a fresh, isolated instance.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types

REFERENCE_API_DIR = "/root/reference/computer_code/api"

_MODULE_NAMES = ("Singleton", "LowPassFilter", "KalmanFilter", "helpers")


class FakeClock:
    """Drop-in for the stdlib ``time`` module with a settable clock.

    The reference's first tracking step computes
    ``dt = time.time() - 0`` (``KalmanFilter.py:13,53``) — a huge value
    that makes the first finite-difference velocity ~0 and the first
    predict a no-op; start ``now`` at a realistically large epoch to
    reproduce that startup behavior exactly.
    """

    def __init__(self, start: float = 1.7e9):
        self.now = float(start)

    def time(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:  # pragma: no cover - unused
        pass

    def advance(self, seconds: float) -> None:
        self.now += float(seconds)


def reference_available(path: str = REFERENCE_API_DIR) -> bool:
    return os.path.isdir(path)


def _fundamental_from_projections_np(P1, P2):
    """F mapping points in image 1 to epilines in image 2 (numpy, f64).

    Same determinant construction as ``ops/epipolar.fundamental_from_
    projections`` (and ``cv.sfm.fundamentalFromProjections``):
    F[i, j] = det([X_j; Y_i]) with X_j the cyclic row pair of P1 omitting
    row j, Y_i likewise for P2.
    """
    import numpy as np

    P1 = np.asarray(P1, np.float64)
    P2 = np.asarray(P2, np.float64)

    def pairs(P):
        return [np.stack([P[(k + 1) % 3], P[(k + 2) % 3]]) for k in range(3)]

    X = pairs(P1)
    Y = pairs(P2)
    F = np.empty((3, 3), np.float64)
    for i in range(3):
        for j in range(3):
            F[i, j] = np.linalg.det(np.concatenate([X[j], Y[i]], axis=0))
    return F


def _stub_pseyepy(num_cameras: int) -> types.ModuleType:
    mod = types.ModuleType("pseyepy")

    class Camera:
        RES_SMALL = 0
        RES_LARGE = 1

        def __init__(self, fps=90, resolution=0, gain=10, exposure=100):
            self.fps = fps
            self.resolution = resolution
            self.gain = [gain] * num_cameras
            self.exposure = [exposure] * num_cameras

        def read(self):  # pragma: no cover - never exercised in tests
            raise RuntimeError("stub camera has no frames")

        def end(self):  # pragma: no cover
            pass

    mod.Camera = Camera
    return mod


def load_reference(path: str = REFERENCE_API_DIR, num_cameras: int = 4):
    """Import the reference math modules with hardware seams stubbed.

    Returns a namespace with attributes:
      ``helpers``       — the reference ``helpers`` module (triangulate_*,
                          locate_objects, calculate_reprojection_errors, ...)
      ``KalmanFilter``  — the reference KalmanFilter module
      ``LowPassFilter`` — the reference LowPassFilter module
      ``clock``         — the FakeClock wired into KalmanFilter.time
      ``cameras``       — ``helpers.Cameras.instance()`` (constructed with
                          the stub pseyepy; holds the reference's
                          camera-params.json intrinsics)

    Raises FileNotFoundError if the reference checkout is absent — tests
    should gate on :func:`reference_available` and skip.
    """
    if not reference_available(path):
        raise FileNotFoundError(f"reference checkout not found at {path}")

    saved = {n: sys.modules.get(n) for n in ("pseyepy", *_MODULE_NAMES)}
    sys.modules["pseyepy"] = _stub_pseyepy(num_cameras)
    loaded = {}
    try:
        for name in _MODULE_NAMES:
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(path, name + ".py"))
            mod = importlib.util.module_from_spec(spec)
            # register under the bare name so the reference's own
            # ``from KalmanFilter import KalmanFilter`` etc. resolve to the
            # freshly loaded copies, then restore sys.modules below
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            loaded[name] = mod
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod

    clock = FakeClock()
    loaded["KalmanFilter"].time = clock
    # The reference passes a flat (6,) measurement to cv.KalmanFilter.correct
    # (``KalmanFilter.py:82``), which OpenCV 4 accepted; OpenCV 5 requires a
    # column vector.  Shim the module's ``cv`` binding with a wrapper whose
    # ``correct`` reshapes to (6, 1) — semantics unchanged.  Composition,
    # not subclassing: a Python subclass of the cv2 extension type leaves a
    # GC cycle whose teardown segfaults the interpreter at shutdown.
    import cv2 as _cv

    class _CompatKalman:
        def __init__(self, *args, **kwargs):
            object.__setattr__(self, "_kf", _cv.KalmanFilter(*args, **kwargs))

        def predict(self, *args):
            return self._kf.predict(*args)

        def correct(self, measurement):
            import numpy as _np
            m = _np.asarray(measurement, _np.float32).reshape(-1, 1)
            return self._kf.correct(m)

        def __getattr__(self, name):
            return getattr(object.__getattribute__(self, "_kf"), name)

        def __setattr__(self, name, value):
            setattr(self._kf, name, value)

    # cv.KalmanFilter is the module's ONLY cv use (KalmanFilter.py:1,22)
    loaded["KalmanFilter"].cv = types.SimpleNamespace(
        KalmanFilter=_CompatKalman)

    # helpers.py calls ``cv.sfm.fundamentalFromProjections``
    # (``helpers.py:362``), which lives in the OpenCV *contrib* sfm module —
    # not present in this environment's cv2 build.  Provide the same
    # algorithm (four 4x4 determinants per entry — the construction our
    # ``ops/epipolar.fundamental_from_projections`` uses) so the reference's
    # full correspondence chain (``helpers.py:339-421``) is runnable in the
    # differential harness.  Everything else proxies to real cv2.
    class _CvProxy:
        sfm = types.SimpleNamespace(
            fundamentalFromProjections=_fundamental_from_projections_np)

        def __getattr__(self, name):
            return getattr(_cv, name)

    loaded["helpers"].cv = _CvProxy()

    # ``drawlines`` (helpers.py:497-504) only paints epipolar lines onto
    # the debug frames; with exact synthetic detections an epiline can be
    # exactly vertical (b = 0) and its int() endpoint overflows cv.line's
    # int32 parsing.  Visualization-only — stub it; the math path is
    # untouched.
    loaded["helpers"].drawlines = lambda img, lines: img
    # helpers imports KalmanFilter (the class) but never calls time itself
    # on the tracking path; Cameras.instance() constructs eagerly here so
    # callers get deterministic state (4 cameras, reference intrinsics).
    cameras = loaded["helpers"].Cameras.instance()

    ns = types.SimpleNamespace(clock=clock, cameras=cameras, **loaded)
    return ns
