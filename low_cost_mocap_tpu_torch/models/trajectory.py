"""Trajectory planning API: jerk-limited multi-drone setpoint generation.

Reproduces the reference's ``POST /api/trajectory-planning`` semantics
(``computer_code/api/index.py:63-112``): waypoints carry one
[x, y, z] * num_objects block plus a trailing stop flag; consecutive
waypoints group into continuous-motion segments split at stop points; each
segment is planned over 3*num_objects DoF with shared velocity /
acceleration / jerk limits and sampled at ``timestep`` (the UI drips the
resulting setpoints to the drones at 20 Hz, ``src/App.tsx:187-199``).

The OTG core is the native C++ jerk-limited planner
(``control/native/otg.cc``) standing in for Ruckig
(``computer_code/api/index.py:15,87``).

The port's own copy of ``low_cost_mocap_tpu/models/trajectory.py``, over
the port's native library.
"""

from __future__ import annotations

import numpy as np

from low_cost_mocap_tpu_torch.control import plan_trajectory_segment


def plan_trajectory(start_pos, end_pos, waypoints, max_vel, max_accel,
                    max_jerk, timestep: float,
                    blend: float = 0.0) -> list[list[float]]:
    """One continuous segment through optional via waypoints.

    Mirrors ``plan_trajectory`` (``computer_code/api/index.py:86-112``).

    ``blend`` in [0, 1] controls via-point pass-through: 0 (default)
    chains the rest-to-rest S-curves — full limits, exact pass through
    each via with a momentary stop (and on sharp corners this is also
    the FASTEST option, since blending pays a half-limits tax);
    otherwise consecutive via segments are
    planned at HALF limits and superposed with a ``blend``-fraction time
    overlap.  The sum of two half-limit jerk-limited profiles respects
    the full limits for ANY overlap (|v1+v2| <= vmax etc.), so the
    blended route is dynamically feasible by construction; it passes
    NEAR each via without stopping (blend radius grows with ``blend``)
    and still reaches the start/end exactly.  Ruckig Pro's
    intermediate-waypoint mode passes exactly THROUGH vias; this is the
    corner-blend semantic industrial controllers use instead
    (divergence documented at otg.h).
    """
    pts = [np.asarray(start_pos, np.float64)]
    pts += [np.asarray(w, np.float64) for w in waypoints]
    pts.append(np.asarray(end_pos, np.float64))

    D = len(pts[0])
    vmax = np.broadcast_to(np.asarray(max_vel, np.float64), (D,))
    amax = np.broadcast_to(np.asarray(max_accel, np.float64), (D,))
    jmax = np.broadcast_to(np.asarray(max_jerk, np.float64), (D,))

    if len(pts) == 2 or blend <= 0.0:
        out: list[list[float]] = []
        for a, b in zip(pts[:-1], pts[1:]):
            seg = plan_trajectory_segment(a, b, vmax, amax, jmax, timestep)
            if out:
                seg = seg[1:]  # avoid duplicating the join sample
            out += [list(map(float, s)) for s in seg]
        return out

    # blended: half-limit displacement profiles, superposed with overlap
    blend = min(float(blend), 1.0)
    disp = []                        # per-segment displacement profiles
    for a, b in zip(pts[:-1], pts[1:]):
        seg = np.asarray(plan_trajectory_segment(
            a, b, vmax / 2, amax / 2, jmax / 2, timestep), np.float64)
        disp.append(seg - a)         # (L_i, D), 0 -> (b - a)
    # segment start indices on the shared timeline; cap each overlap so
    # at most TWO profiles are ever simultaneously in motion
    starts = [0]
    prev_overlap = 0
    for i in range(1, len(disp)):
        li, lj = len(disp[i - 1]), len(disp[i])
        n = int(blend * min(li - 1 - prev_overlap, lj - 1))
        n = max(n, 0)
        starts.append(starts[-1] + li - 1 - n)
        prev_overlap = n
    total = starts[-1] + len(disp[-1])
    out_arr = np.broadcast_to(pts[0], (total, D)).copy()
    for s, dprof in zip(starts, disp):
        L = len(dprof)
        out_arr[s:s + L] += dprof
        out_arr[s + L:] += dprof[-1]   # profile complete: hold its end
    return [list(map(float, row)) for row in out_arr]


def plan_waypoint_route(waypoints, max_vel, max_accel, max_jerk,
                        timestep: float, num_objects: int,
                        blend: float = 0.0) -> list[list[float]]:
    """Full route with stop flags — the `/api/trajectory-planning` body.

    waypoints: iterable of [x, y, z]*num_objects + [stop_flag]; limits are
    per-axis [vx, vy, vz] tiled over objects (``index.py:101-103``).
    ``blend`` > 0 rounds NON-stop via points instead of momentarily
    stopping at them (see ``plan_trajectory``); stop-flagged waypoints
    always remain true stops.
    """
    groups: list[list[list[float]]] = []
    for w in waypoints:
        stop = bool(w[-1])
        coords = list(w[: 3 * num_objects])
        if stop or not groups:
            groups.append([coords])
        else:
            groups[-1].append(coords)

    vmax = list(max_vel) * num_objects
    amax = list(max_accel) * num_objects
    jmax = list(max_jerk) * num_objects

    setpoints: list[list[float]] = []
    for i in range(len(groups) - 1):
        start = groups[i][0]
        end = groups[i + 1][0]
        vias = groups[i][1:]
        setpoints += plan_trajectory(start, end, vias, vmax, amax, jmax,
                                     timestep, blend=blend)
    return setpoints
