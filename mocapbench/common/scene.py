"""The benchmark's scene: a ring of cameras, drones orbiting inside it, and
the frames the cameras see.

A copy of the program's synthetic rig (``utils/synthetic.py``) and of its
``SyntheticSource`` orbit, kept here so that the yardstick does not move
when the program does.  The drones' headings are a half-turn apart, so the
locator's identity rule holds.  The seed sets where the stream starts in
the scene's loop, so every seed gives the same frame sets in another
order.  Frames are rendered blob patch by blob patch straight into uint8 frame
sets: the rest of each image stays dark.
"""

from __future__ import annotations

import numpy as np

ORBIT_HZ = 0.25          # the orbit's turns a second (SyntheticSource)
LOOP_S = 8.0             # the height term's period: the scene repeats
SIGMA_PX = 0.8           # blob radius of the rendered markers
MARKER_SHORT = 0.095     # third LED to each arm LED (m)
MARKER_LONG = 0.15       # arm LED to arm LED (m)


def look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """World->camera R, t with +z forward (OpenCV convention)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    if np.linalg.norm(right) < 1e-8:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R.astype(np.float32), (-R @ eye).astype(np.float32)


def ring_poses(num_cameras: int, radius: float, height: float, target):
    """Cameras evenly on a ring, all aimed at ``target``: (Rs, ts)."""
    Rs, ts = [], []
    for i in range(num_cameras):
        ang = 2.0 * np.pi * i / num_cameras
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        R, t = look_at(eye, target)
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)


def seed_rng(seed: int) -> np.random.Generator:
    """A generator for any whole seed, negative or past 64 bits too."""
    return np.random.default_rng(int(seed) % (1 << 64))


class Orbit:
    """Drones on one orbit around the rig's centre, as ``SyntheticSource``
    flies them (0.25 turns a second, the height swinging 0.1 m over 8 s),
    evenly spaced in phase, every other drone's heading a half-turn from
    the one before.  The seed draws the orbit's radius (``RADIUS``) and
    mean height (``HEIGHT``), the first drone's heading (``HEADING``, off
    the x axis by at most an eighth of a turn, so that the third LED sits
    clear of the arm axis in y, as the locator's side test asks) and the
    orbit's starting phase; ``SyntheticSource``'s own orbit is radius
    0.35 m, height 0.6 m, heading 0."""

    RADIUS = (0.25, 0.45)
    HEIGHT = (0.5, 0.7)
    HEADING = (-np.pi / 4, np.pi / 4)

    def __init__(self, seed: int, num_drones: int):
        rng = seed_rng(seed)
        self.num_drones = num_drones
        self.phase0 = float(rng.uniform(0.0, 4.0 * np.pi))
        self.radius = float(rng.uniform(*self.RADIUS))
        self.height = float(rng.uniform(*self.HEIGHT))
        h0 = float(rng.uniform(*self.HEADING))
        self.headings = tuple(h0 + np.pi * (d % 2) for d in range(num_drones))

    def pose(self, drone: int, t: float):
        """(position (3,), heading) of a drone at ``t`` seconds."""
        phase = (2 * np.pi * (ORBIT_HZ * t + drone / max(self.num_drones, 1))
                 + self.phase0)
        pos = np.array([self.radius * np.cos(phase),
                        self.radius * np.sin(phase),
                        self.height + 0.1 * np.sin(0.5 * phase)], np.float32)
        return pos, self.headings[drone]

    def markers(self, t: float) -> np.ndarray:
        """Every drone's three LEDs at ``t``: (3 * drones, 3)."""
        return np.concatenate([drone_markers(*self.pose(d, t))
                               for d in range(self.num_drones)])


def drone_markers(pos, heading: float) -> np.ndarray:
    """The upstream's 3-LED drone: two arm LEDs ``MARKER_LONG`` apart
    centred on ``pos``, a third ``MARKER_SHORT`` from each on the +y side."""
    half = MARKER_LONG / 2.0
    h = float(np.sqrt(max(MARKER_SHORT**2 - half**2, 1e-8)))
    local = np.array([[half, 0.0, 0.0], [-half, 0.0, 0.0], [0.0, h, 0.0]],
                     np.float32)
    c, s = np.cos(heading), np.sin(heading)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    return local @ Rz.T + np.asarray(pos, np.float32)


def project(X, Rs, ts, K):
    """Pixels (N, C, 2) of world points X (N, 3) in every camera."""
    Xc = np.einsum("cij,nj->cni", Rs, X) + ts[:, None, :]
    xy = Xc[..., :2] / Xc[..., 2:3]
    px = np.stack([xy[..., 0] * K[:, None, 0, 0] + K[:, None, 0, 2],
                   xy[..., 1] * K[:, None, 1, 1] + K[:, None, 1, 2]], -1)
    return np.transpose(px, (1, 0, 2)).astype(np.float32)


def render(orbit: Orbit, times, Rs, ts, K, hw) -> np.ndarray:
    """(T, C, H, W) uint8 frame sets of the orbit at ``times``: each
    marker a Gaussian of ``SIGMA_PX`` over a 5-sigma patch, overlapping
    patches summed, clipped to [0, 1] and scaled to 0..255."""
    H, W = hw
    C = len(Rs)
    T = len(times)
    r = max(int(np.ceil(5.0 * SIGMA_PX)), 2)
    out = np.zeros((T, C, H, W), np.uint8)
    pts = np.stack([project(orbit.markers(t), Rs, ts, K) for t in times])
    # (T, N, C, 2) -> one patch for each (frame, marker, camera) in view
    inside = ((pts[..., 0] >= 0) & (pts[..., 0] <= W - 1)
              & (pts[..., 1] >= 0) & (pts[..., 1] <= H - 1))
    f, n, c = np.nonzero(inside)
    x0, y0 = pts[f, n, c, 0], pts[f, n, c, 1]
    off = np.arange(-r, r + 1)
    gx = np.floor(x0).astype(np.int64)[:, None] + off          # (P, 2r+1)
    gy = np.floor(y0).astype(np.int64)[:, None] + off
    d2 = ((gx[:, None, :].astype(np.float32) - x0[:, None, None]) ** 2
          + (gy[:, :, None].astype(np.float32) - y0[:, None, None]) ** 2)
    val = np.exp(-d2 / np.float32(2.0 * SIGMA_PX**2)).astype(np.float32)
    ok = ((gx[:, None, :] >= 0) & (gx[:, None, :] < W)
          & (gy[:, :, None] >= 0) & (gy[:, :, None] < H))
    flat = (((f * C + c)[:, None, None] * H + gy[:, :, None]) * W
            + gx[:, None, :])
    flat, val = flat[ok], val[ok]
    order = np.argsort(flat, kind="stable")
    flat, val = flat[order], val[order]
    first = np.ones(len(flat), bool)
    first[1:] = flat[1:] != flat[:-1]
    starts = np.nonzero(first)[0]
    total = np.add.reduceat(val, starts) if len(val) else val
    px = np.clip(total, 0.0, 1.0)
    out.reshape(-1)[flat[starts]] = (px * np.float32(255)).astype(np.uint8)
    return out


def loop_times(rate_hz: float, n: int):
    """The first ``n`` frame times of a stream at ``rate_hz``."""
    return np.arange(n, dtype=np.float64) / rate_hz


def wrap(n_needed: int, rate_hz: float) -> int:
    """Frame sets to render for ``n_needed`` frames at ``rate_hz``: the
    scene repeats after ``LOOP_S``, so never more than one loop."""
    return int(min(n_needed, round(LOOP_S * rate_hz)))
