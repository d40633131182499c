"""Differential trajectory harness: the port vs the ACTUAL reference.

Counterpart of ``low_cost_mocap_tpu/utils/differential.py``; the
framework side is the port's ``models.pipeline.track_from_blobs``, run on
the device asked for (CUDA by default, ``device="cpu"`` when asked).

Feeds the reference backend (imported from its checkout via
``utils.reference_impl`` — its own correspondence, DLT, rigid-body fit and
cv.KalmanFilter tracker) and this framework's pipeline IDENTICAL per-camera
detection streams (same noisy pixels, same shuffled per-camera order), runs
both end-to-end, and reports trajectory agreement:

- ``ate_ref_vs_repo``  — RMS position difference between the two systems'
  tracked drone trajectories (the BASELINE.json "match the reference's
  reconstructed trajectories" clause, measured directly);
- ``ate_ref_vs_truth`` — the reference's own error against ground truth
  (its "ATE bound": we match the reference if ref-vs-repo <= this);
- ``ate_repo_vs_truth`` — this framework's error against the same truth.

Scene: two drones on smooth 3D display-frame trajectories.  The marker
triples are tilted slightly out of plane (third LED δ=±10 mm along the
display up axis) so the reference's hardcoded heading/side axes (0, 1)
(``computer_code/api/helpers.py:463,469``) and this framework's engine
convention (horizontal pair (0, 2) — see ``ops/rigid.py``) assign the SAME
drone identities; positions (midpoint of the arm pair) are convention-free.

Known, documented divergences bounded by the harness:
- Kalman initial covariance: cv.KalmanFilter starts errorCovPost = 0, this
  framework starts P = I — a startup transient that decays within ~60
  frames (steady-state zero-noise agreement is ~0.3 mm).
- Velocity finite-difference seeding at init (``ops/kalman.py``).
"""

from __future__ import annotations

import numpy as np

from low_cost_mocap_tpu_torch.config import (CameraIntrinsics, EngineConfig,
                                             RigConfig)
from low_cost_mocap_tpu_torch.utils import reference_impl, synthetic as syn

REF_K = ((320.0, 0.0, 160.0), (0.0, 320.0, 160.0), (0.0, 0.0, 1.0))
_FLIP = np.array([[-1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]])


def reference_rig(num_cameras: int = 4):
    """``syn.ring_rig`` with the reference's camera-params.json intrinsics
    (320 px focal, 160 px centre — ``api/camera-params.json``)."""
    import dataclasses

    Rs, ts, rig = syn.ring_rig(num_cameras=num_cameras, image_size=320)
    cams = tuple(
        CameraIntrinsics(intrinsic_matrix=REF_K, distortion_coef=(0.0,) * 5)
        for _ in range(num_cameras))
    return Rs, ts, dataclasses.replace(rig, cameras=cams)


def drone_markers_display(pos, phi, s, delta, rig: RigConfig):
    """3-LED triple in the DISPLAY (post-swap world) frame.

    Arm pair ``marker_dist_long`` apart along (cos phi, 0, sin phi); third
    LED offset ``s``·h·(-sin phi, 0, cos phi) + ``delta`` along the up axis
    (component 1).  ``s``/``delta`` signs pick the drone identity in BOTH
    side conventions (see module docstring).
    """
    u = np.array([np.cos(phi), 0.0, np.sin(phi)])
    w = np.array([-np.sin(phi), 0.0, np.cos(phi)])
    half = rig.marker_dist_long / 2.0
    h = np.sqrt(rig.marker_dist_short ** 2 - half ** 2)
    return np.stack([
        pos + half * u,
        pos - half * u,
        pos + s * h * w + np.array([0.0, delta, 0.0]),
    ])


def display_to_cam(X_disp: np.ndarray) -> np.ndarray:
    """Invert ``ops/world.to_world`` with M = I (swap then flip — both
    involutive) so display-frame geometry can be projected through the
    camera rig."""
    return X_disp[:, [0, 2, 1]] @ _FLIP.T


def _pos_a(t):
    return np.array([0.25 * np.cos(0.8 * t), 0.5 + 0.15 * np.sin(0.5 * t),
                     0.25 * np.sin(0.8 * t)])


def _pos_b(t):
    return np.array([-0.3 + 0.2 * np.sin(0.6 * t),
                     0.7 + 0.1 * np.cos(0.7 * t), 0.3 * np.cos(0.6 * t)])


def tracking_step(Rs, ts, rig: RigConfig, eng: EngineConfig,
                  max_blobs: int, device):
    """This framework's side of the harness: ``track_from_blobs`` on two
    drones as one ``runtime.compiled.CompiledStep`` (JAX's ``jax.jit`` of
    it): its Kalman state is its buffers, donated as the Engine's steps
    are, and its calibration (Ps, K, dist, the world matrix, the pairwise
    fundamentals) buffers of its own.  Called with (state, (4, max_blobs,
    2) blobs, (4, max_blobs) valid, dt, *step.args[3:]) -> (the state
    buffers, the frame's outputs, overwritten by the next call): a CUDA
    graph on the card, op by op on the CPU."""
    import functools

    import torch

    from low_cost_mocap_tpu_torch.models.pipeline import track_from_blobs
    from low_cost_mocap_tpu_torch.ops import (camera as cam_ops, correspond,
                                              kalman)
    from low_cost_mocap_tpu_torch.runtime import compiled

    dev = torch.device(device)
    C = len(Rs)
    K = torch.as_tensor(rig.K_stack(), device=dev)
    dist = torch.as_tensor(rig.dist_stack(), device=dev)
    Ps = cam_ops.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                   torch.as_tensor(ts, device=dev))
    Fs = correspond._pairwise_fundamentals(Ps)
    M = torch.eye(4, device=dev)
    fn = functools.partial(
        track_from_blobs, gate_px=eng.epipolar_gate_px,
        max_candidates=eng.max_candidates_per_cam,
        marker_dist1=rig.marker_dist_short,
        marker_dist2=rig.marker_dist_long,
        marker_tol=rig.marker_dist_tol,
        marker_side_min=rig.marker_side_min)
    return compiled.CompiledStep(
        fn, kalman.init_state(2, device=dev),
        torch.zeros((C, max_blobs, 2), device=dev),
        torch.zeros((C, max_blobs), dtype=torch.bool, device=dev),
        torch.zeros((), device=dev), Ps, K, dist, M, Fs,
        name="differential step")


def run_differential(T: int = 240, noise_px: float = 0.3, seed: int = 7,
                     ref_own_correspondence: bool = True,
                     occlusions=(), n_distractors: int = 0,
                     n_extra_markers: int = 0, max_blobs: int | None = None,
                     return_tracks: bool = False, device=None) -> dict:
    """Run both systems on identical detection streams; return metrics.

    Keep ``T`` < 300: beyond its 300-sample buffer the reference's
    LowPassFilter re-filters a TRUNCATED history (``LowPassFilter.py:20-21``)
    while this framework's O(1) IIR is exact, which would add a
    velocity-output divergence unrelated to the tracking math (positions
    are unaffected either way).

    ``ref_own_correspondence``: run the reference's own hypothesis-growth
    correspondence (``helpers.py:339-421``, cv.sfm shimmed); otherwise feed
    it ground-truth grouping (isolates triangulation+tracking).

    Hard-regime scene controls (all default off -> the clean scene):

    ``occlusions``: tuples ``(f0, f1, cam, m_lo, m_hi)`` — marker indices
    ``[m_lo, m_hi)`` (drone A = 0:3, drone B = 3:6, extras after) are
    hidden from camera ``cam`` (``cam = -1``: from ALL cameras) during
    frames ``[f0, f1)``.  This exercises the regimes the clean harness
    skips: points missing from some views (the reference's hypothesis
    growth handles a missing camera by keeping the group without it,
    ``helpers.py:402-406``) and full dropout windows, where the reference
    emits nothing and does NOT advance its Kalman (``KalmanFilter.py:61-63``
    ``continue``s before ``predict``) while this framework's bank predicts
    through the gap — a documented reacquisition divergence this harness
    measures (``postgap`` metrics below).

    ``n_distractors``: per-camera persistent false blobs (static image
    positions + the same per-frame pixel noise), fed identically to both
    systems — they are epipolar-inconsistent across views, so they stress
    the matchers' ghost handling (unmatched points become new roots in the
    reference, ``helpers.py:402-406``).

    ``n_extra_markers``: free-flying REAL 3D markers (slow orbits inside
    the capture volume, visible to all cameras).  These triangulate
    consistently, so gate-passing candidate counts routinely exceed
    ``max_candidates_per_cam`` — the fixed-budget regime where this
    framework's matcher truncates candidates the reference's unbounded
    cartesian growth keeps (``helpers.py:394-400``).

    ``return_tracks``: attach per-frame track dicts (``ref_tracks``,
    ``repo_tracks``, ``truth``) for scene-specific slicing by callers.

    ``device``: where the port's pipeline runs (CUDA by default).
    """
    from low_cost_mocap_tpu_torch.device import resolve_device

    dev = resolve_device(device)

    rng = np.random.default_rng(seed)
    Rs, ts, rig = reference_rig()
    eng = EngineConfig()
    dt = 1.0 / 60.0
    KB = max_blobs if max_blobs is not None else eng.max_blobs
    E = n_extra_markers
    # free-marker orbit parameters (display frame, inside the volume)
    ex_phase = rng.uniform(0, 2 * np.pi, E)
    ex_rad = rng.uniform(0.15, 0.35, E)
    ex_h = rng.uniform(0.35, 0.85, E)
    ex_om = rng.uniform(0.3, 0.9, E)
    # persistent per-camera false blobs (static pixel positions)
    distract = rng.uniform(40.0, 280.0, size=(4, n_distractors, 2))

    ref = reference_impl.load_reference()
    poses = [{"R": Rs[i].tolist(), "t": ts[i].tolist()} for i in range(4)]
    kf_ref = ref.KalmanFilter.KalmanFilter(2)

    step = tracking_step(Rs, ts, rig, eng, KB, dev)
    st = step.state

    ref_tracks = {0: {}, 1: {}}
    repo_tracks = {0: {}, 1: {}}
    truth = {0: {}, 1: {}}
    first = True
    for f in range(T):
        t = f * dt
        phi_a = 0.6 * np.sin(0.4 * t)
        phi_b = -0.5 * np.cos(0.3 * t)
        m_a = drone_markers_display(_pos_a(t), phi_a, +1, +0.01, rig)
        m_b = drone_markers_display(_pos_b(t), phi_b, -1, -0.01, rig)
        parts = [m_a, m_b]
        if E:
            ang = ex_phase + ex_om * t
            parts.append(np.stack([ex_rad * np.cos(ang), ex_h,
                                   ex_rad * np.sin(ang)], -1))
        X_disp = np.concatenate(parts)
        X_cam = display_to_cam(X_disp).astype(np.float32)
        pts, mask = syn.observe(X_cam, Rs, ts, rig, noise_px=noise_px,
                                rng=rng)
        mask = np.asarray(mask).copy()
        for (f0, f1, cam, lo, hi) in occlusions:
            if f0 <= f < f1:
                if cam < 0:
                    mask[lo:hi, :] = False
                else:
                    mask[lo:hi, cam] = False
        if not (occlusions or E or n_distractors):
            assert mask.all(), f"marker left the view at frame {f}"
        truth[0][f] = _pos_a(t)
        truth[1][f] = _pos_b(t)

        # identical per-camera streams: same pixels (visible real markers
        # + distractor blobs), same shuffled order
        blobs = np.zeros((4, KB, 2), np.float32)
        valid = np.zeros((4, KB), bool)
        cam_lists = []
        for c in range(4):
            vis = np.flatnonzero(mask[:, c])
            cam_pts = pts[vis, c]
            if n_distractors:
                dpix = distract[c]
                if noise_px:
                    dpix = dpix + rng.normal(scale=noise_px,
                                             size=dpix.shape)
                cam_pts = np.concatenate(
                    [cam_pts, dpix.astype(np.float32)])
            n_c = len(cam_pts)
            assert n_c <= KB, (f, c, n_c, KB)
            order = rng.permutation(n_c)
            blobs[c, :n_c] = cam_pts[order]
            valid[c, :n_c] = True
            cam_lists.append(
                [p.tolist() for p in cam_pts[order].astype(np.float64)])

        # ---- reference chain ----
        if ref_own_correspondence:
            dummy = [np.zeros((8, 8, 3), np.uint8) for _ in range(4)]
            errs_ref, obj_pts, _ = (
                ref.helpers.find_point_correspondance_and_object_points(
                    cam_lists, poses, dummy))
        else:
            obj_pts = ref.helpers.triangulate_points(
                pts.astype(np.float64), poses)
            errs_ref = np.zeros(len(obj_pts))
        # world conversion exactly as the reference hot loop
        # (computer_code/api/helpers.py:97-103, M = I)
        wpts = []
        for p in obj_pts:
            q = _FLIP @ np.asarray(p, np.float64)
            q[1], q[2] = q[2], q[1]
            wpts.append(q)
        wpts = np.asarray(wpts)
        objs = ref.helpers.locate_objects(wpts, errs_ref)
        if not first:
            ref.clock.advance(dt)
        first = False
        for r in kf_ref.predict_location(objs):
            # the reference returns VIEWS into cv state buffers; copy
            ref_tracks[r["droneIndex"]][f] = np.array(
                r["pos"], np.float64).copy()

        # ---- this framework ----
        st, out = step(st, blobs, valid, dt, *step.args[3:])
        tv = out.tracked.valid.cpu().numpy()
        tp = out.tracked.pos.cpu().numpy()
        for o in range(2):
            if tv[o]:
                repo_tracks[o][f] = tp[o].astype(np.float64).copy()

    def rms(seq):
        seq = np.asarray(seq)
        return float(np.sqrt((seq ** 2).mean())) if len(seq) else float("nan")

    metrics = {"T": T, "noise_px": noise_px}
    # frames inside a full-dropout occlusion window (cam == -1 covering a
    # whole drone), plus a reacquisition transient after it: the reference
    # does not advance its Kalman through a gap (KalmanFilter.py:61-63)
    # while this framework predicts through it, so the two reconverge over
    # ~the filter's settling time.  ``steady`` excludes those frames;
    # ``postgap`` measures the transient itself.
    gap_frames = {0: set(), 1: set()}
    postgap_frames = {0: set(), 1: set()}
    for (f0, f1, cam, lo, hi) in occlusions:
        if cam < 0:
            for idx, (dlo, dhi) in ((0, (0, 3)), (1, (3, 6))):
                if lo <= dlo and hi >= dhi:
                    gap_frames[idx].update(range(f0, f1))
                    postgap_frames[idx].update(range(f1, f1 + 60))
    for idx in (0, 1):
        common = sorted(set(ref_tracks[idx]) & set(repo_tracks[idx]))
        steady = [f for f in common if f >= 120
                  and f not in gap_frames[idx]
                  and f not in postgap_frames[idx]]
        postgap = [f for f in common if f in postgap_frames[idx]]
        d_rr = [np.linalg.norm(ref_tracks[idx][f] - repo_tracks[idx][f])
                for f in common]
        d_rt = [np.linalg.norm(ref_tracks[idx][f] - truth[idx][f])
                for f in common]
        d_pt = [np.linalg.norm(repo_tracks[idx][f] - truth[idx][f])
                for f in common]
        metrics[idx] = {
            "frames_ref": len(ref_tracks[idx]),
            "frames_repo": len(repo_tracks[idx]),
            "frames_common": len(common),
            "ate_ref_vs_repo_mm": rms(d_rr) * 1e3,
            "ate_ref_vs_repo_steady_mm": rms(
                [np.linalg.norm(ref_tracks[idx][f] - repo_tracks[idx][f])
                 for f in steady]) * 1e3,
            "ate_ref_vs_truth_mm": rms(d_rt) * 1e3,
            "ate_repo_vs_truth_mm": rms(d_pt) * 1e3,
            "ate_ref_vs_truth_steady_mm": rms(
                [np.linalg.norm(ref_tracks[idx][f] - truth[idx][f])
                 for f in steady]) * 1e3,
            "ate_repo_vs_truth_steady_mm": rms(
                [np.linalg.norm(repo_tracks[idx][f] - truth[idx][f])
                 for f in steady]) * 1e3,
            "postgap_ref_vs_repo_mm": rms(
                [np.linalg.norm(ref_tracks[idx][f] - repo_tracks[idx][f])
                 for f in postgap]) * 1e3,
            "postgap_ref_vs_truth_mm": rms(
                [np.linalg.norm(ref_tracks[idx][f] - truth[idx][f])
                 for f in postgap]) * 1e3,
            "postgap_repo_vs_truth_mm": rms(
                [np.linalg.norm(repo_tracks[idx][f] - truth[idx][f])
                 for f in postgap]) * 1e3,
        }
    if return_tracks:
        metrics["ref_tracks"] = ref_tracks
        metrics["repo_tracks"] = repo_tracks
        metrics["truth"] = truth
    return metrics
