"""The numbers that decide ``correct``: what the timed path produced held
against the plain reference, frame by frame.

Each function returns {name: value}; the traffic mix gives each name its
limit.  ``missing`` counts answers that never came, ``discrete`` the
frames whose discrete fields (which blob slots are lit, which points are
valid, which drones are located and tracked) differ; the float numbers are
the widest gaps over the frames whose discrete fields agree.
"""

from __future__ import annotations

import numpy as np


def _gap(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size != b.size:
        return float("inf")
    a = a.reshape(b.shape)
    return float(np.abs(a - b).max()) if a.size else 0.0


def _angle_gap(a, b) -> float:
    """Widest gap of angles, a full turn counted as none."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d = np.abs((d + np.pi) % (2 * np.pi) - np.pi)
    return float(d.max()) if d.size else 0.0


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def as_served(ref: dict, tracked, num_objects: int) -> list:
    """Reference outputs in the shape a live run keeps the program's:
    (outputs with blob_px, blob_valid and point_valid; the object-points
    payload) for each frame, so that the control is compared as the
    program is."""
    from types import SimpleNamespace

    r = {k: _np(v) for k, v in ref.items()}
    tr = {k: _np(getattr(tracked, k)) for k in ("pos", "vel", "heading",
                                                "valid")}
    served = []
    for k in range(len(r["valid"])):
        pv, lv = r["point_valid"][k], r["valid"][k]
        out = SimpleNamespace(blob_px=r["blob_px"][k],
                              blob_valid=r["blob_valid"][k], point_valid=pv)
        payload = {
            "object_points": r["points"][k][pv].tolist(),
            "objects": [{"pos": r["pos"][k][i].tolist(),
                         "heading": float(r["heading"][k][i]),
                         "droneIndex": int(r["index"][k][i])}
                        for i in np.nonzero(lv)[0]],
            "filtered_objects": [{"pos": tr["pos"][k][d].tolist(),
                                  "vel": tr["vel"][k][d].tolist(),
                                  "heading": float(tr["heading"][k][d]),
                                  "droneIndex": int(d)}
                                 for d in range(num_objects)
                                 if tr["valid"][k][d]]}
        served.append((out, payload))
    return served


def live_numbers(served: list, ref: dict, tracked) -> dict:
    """``served``: for each frame due, (the FrameOutputs the Engine
    returned, its object-points payload), None where none came.  ``ref``:
    ``track.locate``'s dict for the frames served, in order; ``tracked``:
    ``track.track``'s TrackedObjects over them."""
    r = {k: _np(v) for k, v in ref.items()}
    tr = {k: _np(getattr(tracked, k)) for k in ("pos", "vel", "heading",
                                                "valid")}
    n = {"missing": 0, "discrete": 0, "blob_px": 0.0, "pos_m": 0.0,
         "vel_mps": 0.0, "heading_rad": 0.0}
    for k, got in enumerate(served):
        if got is None:
            n["missing"] += 1
            continue
        out, payload = got
        bv = r["blob_valid"][k]
        pv = r["point_valid"][k]
        lv = r["valid"][k]
        tv = tr["valid"][k]
        objs = payload["objects"]
        filt = payload["filtered_objects"]
        if (not np.array_equal(np.asarray(out.blob_valid, bool), bv)
                or len(payload["object_points"]) != int(pv.sum())
                or not np.array_equal(np.asarray(out.point_valid, bool), pv)
                or [o["droneIndex"] for o in objs]
                != [int(i) for i in r["index"][k][lv]]
                or [o["droneIndex"] for o in filt]
                != [int(i) for i in np.nonzero(tv)[0]]):
            n["discrete"] += 1
            continue
        n["blob_px"] = max(n["blob_px"],
                           _gap(np.asarray(out.blob_px)[bv],
                                r["blob_px"][k][bv]))
        gaps = [_gap(payload["object_points"], r["points"][k][pv]),
                _gap([o["pos"] for o in objs], r["pos"][k][lv]),
                _gap([o["pos"] for o in filt], tr["pos"][k][tv])]
        n["pos_m"] = max(n["pos_m"], *gaps)
        n["vel_mps"] = max(n["vel_mps"],
                           _gap([o["vel"] for o in filt], tr["vel"][k][tv]))
        n["heading_rad"] = max(
            n["heading_rad"],
            _angle_gap([o["heading"] for o in objs], r["heading"][k][lv]),
            _angle_gap([o["heading"] for o in filt], tr["heading"][k][tv]))
    return n


def offline_numbers(calls: list, ref: dict, tracked, smoothed) -> dict:
    """``calls``: each completed call's host copies (a dict of numpy
    arrays: points, point_valid, pos, valid, and tracked_* / smoothed_*
    pos, vel, heading, valid), None for a call that never returned.
    ``ref``: ``track.locate`` over the recording; ``tracked`` and
    ``smoothed``: the reference's causal and smoothed tracks."""
    r = {k: _np(v) for k, v in ref.items()}
    want = {"points": r["points"], "point_valid": r["point_valid"],
            "pos": r["pos"], "valid": r["valid"]}
    for pre, t in (("tracked_", tracked), ("smoothed_", smoothed)):
        for f in ("pos", "vel", "heading", "valid"):
            want[pre + f] = _np(getattr(t, f))
    n = {"missing": 0, "discrete": 0, "pos_m": 0.0, "vel_mps": 0.0,
         "heading_rad": 0.0}
    masks = (("point_valid", ("points",)), ("valid", ("pos",)),
             ("tracked_valid", ("tracked_pos",)),
             ("smoothed_valid", ("smoothed_pos",)))
    for got in calls:
        if got is None:
            n["missing"] += 1
            continue
        same = np.ones(len(want["valid"]), bool)
        for m, _ in masks:
            same &= (np.asarray(got[m], bool) == want[m]).reshape(
                len(same), -1).all(1)
        n["discrete"] += int((~same).sum())
        for m, fields in masks:
            sel = want[m] & same.reshape((-1,) + (1,) * (want[m].ndim - 1))
            for f in fields:
                n["pos_m"] = max(n["pos_m"], _gap(got[f][sel], want[f][sel]))
        for pre in ("tracked_", "smoothed_"):
            sel = want[pre + "valid"] & same[:, None]
            n["vel_mps"] = max(n["vel_mps"], _gap(got[pre + "vel"][sel],
                                                  want[pre + "vel"][sel]))
            n["heading_rad"] = max(n["heading_rad"], _angle_gap(
                got[pre + "heading"][sel], want[pre + "heading"][sel]))
    return n
