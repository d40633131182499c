"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions, on the card, at shapes beyond the main path's: frames that are
not a whole number of propagation tiles, ``cc_iters`` from 0 to more than
one pass of the kernel holds, an all-lit frame where no tile is skipped,
one to sixteen blob slots, banks of one object up to more objects than a
block holds, candidate counts that do not fill a warp or spill past one,
ties across lanes, and NaN and infinite candidate distances; the bank's
forward-filter instantiation (the RTS smoother's, one launch a recording)
through misses before the first detection, short gaps and gaps past
``gap_reset_s``, alone and inside ``process_recording``.  Beside the
kernels, the two stages of the body rig that run on the card around them:
the body stage (6-DoF fits and the body tracker) and the blur + sharpen
convolution, each held to the port on the CPU.

Both kernels perform the float32 operations of their plain versions in the
same order (no fused multiply-adds, integer moments), so every output must
be bitwise equal.

These tests need a CUDA card and ``nvcc``: they carry the ``cuda`` marker
and skip without a card.  On a machine with one, from the repository root:

    python -m pytest tests/test_torch_cuda_kernels.py -q -o addopts="" \
        --noconftest

(``--noconftest``: the suite's conftest configures JAX, which the port
does not need.)
"""

import time

import numpy as np
import pytest
import torch

from low_cost_mocap_tpu_torch.ops import detect, detect_cuda, kalman
from low_cost_mocap_tpu_torch.ops import kalman_cuda
from low_cost_mocap_tpu_torch.utils import tree
from test_torch_kalman_forward import forward_case   # tests/ is on the path

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _frames(seed, C, H, W, cc_iters):
    """Random rectangles, lines longer than cc_iters, single pixels at the
    0.2 threshold edge (50-52 / 255) and a lit border row."""
    rng = np.random.default_rng(seed)
    f = np.zeros((C, H, W), np.float32)
    u8 = np.float32(1.0 / 255.0)
    for c in range(C):
        for _ in range(6):
            y, x = rng.integers(0, H), rng.integers(0, W)
            h, w = rng.integers(1, 6, 2)
            f[c, y:y + h, x:x + w] = rng.uniform(0.3, 1.0)
        y = rng.integers(0, H)
        f[c, y, :min(W, 3 * cc_iters + 5)] = 1.0
        for _ in range(8):
            f[c, rng.integers(0, H), rng.integers(0, W)] = \
                np.float32(rng.integers(50, 53)) * u8
    f[0, H - 1, :] = 1.0
    return f


@pytest.mark.parametrize("C,H,W,cc_iters,K", [
    (4, 320, 320, 24, 8),      # the main path's shapes
    (3, 100, 75, 24, 8),       # ragged tiles in both directions
    (2, 64, 64, 0, 4),         # no propagation: every pixel its own blob
    (1, 129, 257, 5, 16),
    (2, 97, 131, 69, 8),       # the most sweeps one pass holds
])
def test_detect_kernel_matches_plain(dev, C, H, W, cc_iters, K):
    frames = torch.from_numpy(_frames(C * H + W, C, H, W, cc_iters)).to(dev)
    _check_detect(frames, K, cc_iters)


def _check_detect(frames, K, cc_iters):
    got = detect_cuda.find_blobs(frames, 0.2, K, cc_iters)
    want = detect.find_blobs_multi(frames, 0.2, K, cc_iters)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].any())
    return got


@pytest.mark.parametrize("cc_iters", [70, 150])
def test_detect_kernel_refuses_too_many_sweeps(dev, cc_iters):
    """No longer refuses: sweeps beyond one pass's halo (69) run in further
    passes through a global label buffer, bitwise equal to the plain
    version, on a frame with lines longer than cc_iters."""
    frames = torch.from_numpy(_frames(cc_iters, 2, 97, 331, cc_iters)).to(dev)
    _check_detect(frames, 8, cc_iters)


@pytest.mark.parametrize("cc_iters", [0, 24, 70])
def test_detect_kernel_all_lit_frame(dev, cc_iters):
    """Every pixel lit: no tile is skipped, no sweep reaches a fixed point
    early, and every label is a root candidate."""
    frames = torch.ones((4, 320, 320), device=dev)
    cent, valid, size = _check_detect(frames, 8, cc_iters)
    assert bool(valid.all())


def test_detect_kernel_all_dark_frame(dev):
    frames = torch.zeros((4, 320, 320), device=dev)
    got = detect_cuda.find_blobs(frames, 0.2, 8, 24)
    want = detect.find_blobs_multi(frames, 0.2, 8, 24)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(got[1].any())


def _bank_case(seed, B, M, O):
    rng = np.random.default_rng(seed)
    cp = rng.normal(0, 0.4, (B, M, 3)).astype(np.float32)
    cp[:, M // 2:] = cp[:, :M - M // 2]                  # association ties
    ch = rng.normal(0, 1, (B, M)).astype(np.float32)
    ci = rng.integers(-1, O, (B, M)).astype(np.int32)    # -1: no drone
    cv = rng.random((B, M)) < 0.5
    dts = np.full((B,), 1 / 60, np.float32)
    dts[B // 2] = 0.7                                    # gap re-seed
    return cp, ch, ci, cv, dts


def _special_case(kind, B=24, M=33, O=3):
    """A bank case with NaN candidate positions ("nan"), positions whose
    squared distances overflow to inf ("inf"), or every candidate of a step
    at one position, so all distances tie across the lanes ("ties")."""
    cp, ch, ci, cv, dts = _bank_case(7, B, M, O)
    if kind == "nan":
        cp[5, 3:M:4] = np.nan            # some of every object's candidates
        cp[9, :, 1] = np.nan             # one coordinate of all of them
        cp[14][ci[14] == 1] = np.nan     # all of object 1's
    elif kind == "inf":
        cp[4:7] = np.float32(3e19)
        cp[4:7, ::3] = np.float32(-3e19)
    else:
        cp[:] = cp[:, :1]
    return cp, ch, ci, cv, dts


def _assert_same(got, want):
    """Bitwise equal, NaN where the other has NaN."""
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("B,M,O", [(1, 1, 1), (7, 32, 2), (300, 32, 2),
                                   (20, 64, 33), (9, 7, 2), (40, 33, 3)])
@pytest.mark.parametrize("report", ["pre", "post"])
def test_bank_kernel_matches_plain_chain(dev, B, M, O, report):
    case = [torch.from_numpy(a).to(dev) for a in _bank_case(B + O, B, M, O)]
    _check_bank(dev, case, O, report)


def _check_bank(dev, case, O, report="pre"):
    st0 = kalman.init_state(O, device=dev)
    st1, tr1 = kalman_cuda.kalman_scan(st0, *case, report=report)
    st2, tr2 = kalman.update_scan(st0, *case, report=report)
    torch.cuda.synchronize()
    _assert_same((*st1, *tr1), (*st2, *tr2))
    # the kernel's state carries on: a second batch from the first's end
    st3, tr3 = kalman_cuda.kalman_scan(st1, *case, report=report)
    st4, tr4 = kalman.update_scan(st2, *case, report=report)
    _assert_same((*st3, *tr3), (*st4, *tr4))


@pytest.mark.parametrize("kind", ["nan", "inf", "ties"])
@pytest.mark.parametrize("M", [7, 33])
def test_bank_kernel_associates_as_argmin(dev, kind, M):
    """Association follows torch.argmin: the first NaN distance wins, else
    the first minimum, and slot 0 when every distance is inf."""
    case = [torch.from_numpy(a).to(dev)
            for a in _special_case(kind, M=M)]
    _check_bank(dev, case, 3)


def test_bank_kernel_refuses_mismatched_shapes(dev):
    case = [torch.from_numpy(a).to(dev) for a in _bank_case(0, 4, 8, 2)]
    case[1] = case[1][:, :4]
    with pytest.raises(ValueError, match="shape"):
        kalman_cuda.kalman_scan(kalman.init_state(2, device=dev), *case)


@pytest.mark.parametrize("B", [1, 128])
def test_bank_kernel_at_the_body_rigs_width(dev, B):
    """16 blob slots on 4 cameras: M = 64 candidates, two drones."""
    case = [torch.from_numpy(a).to(dev) for a in _bank_case(5, B, 64, 2)]
    _check_bank(dev, case, 2)


def test_body_stage_on_the_card_matches_the_cpu(dev):
    """Two templates' fits and tracks over a few frames: validity equal,
    floats within 1e-4 (the card's reductions sum in another order)."""
    import dataclasses

    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import camera, correspond
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    tmpl_a = ((0.0, 0.0, 0.0), (0.12, 0.0, 0.0), (0.0, 0.09, 0.0),
              (0.05, 0.04, 0.07))
    tmpl_b = ((0.0, 0.0, 0.0), (0.2, 0.0, 0.0), (0.1, 0.16, 0.0),
              (0.02, 0.05, 0.11))
    Rs, ts, rig0 = syn.ring_rig(num_cameras=4)
    rig = dataclasses.replace(rig0, body_markers=tmpl_a, max_bodies=2,
                              body_sets=((tmpl_b, 1),))
    sets = rig.body_sets_resolved()
    kw = dict(gate_px=5.0, max_candidates=2, with_obs=True, body_sets=sets,
              marker_dist1=rig.marker_dist_short,
              marker_dist2=rig.marker_dist_long,
              marker_tol=rig.marker_dist_tol,
              marker_side_min=rig.marker_side_min)
    rows = []
    for d in (torch.device("cpu"), dev):
        K = torch.as_tensor(rig.K_stack(), device=d)
        Ps = camera.projection_matrix(K, torch.as_tensor(Rs, device=d),
                                      torch.as_tensor(ts, device=d))
        cal = (Ps, K, torch.as_tensor(rig.dist_stack(), device=d),
               torch.eye(4, device=d), correspond._pairwise_fundamentals(Ps))
        st, out = pipeline.make_init_state(rig, device=d), []
        for i in range(4):
            c, s = np.cos(0.1 * i), np.sin(0.1 * i)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            Xw = np.concatenate([
                np.asarray(tmpl_a, np.float32) @ R.T + [-0.25, 0.1, 0.05],
                np.asarray(tmpl_b, np.float32) @ R + [0.3, 0.15, -0.1]])
            X = (Xw[:, [0, 2, 1]] * [-1.0, -1.0, 1.0]).astype(np.float32)
            pts, mask = syn.observe(X, Rs, ts, rig)
            blobs = np.zeros((4, 16, 2), np.float32)
            ok = np.zeros((4, 16), bool)
            for cam in range(4):
                vis = np.where(mask[:, cam])[0]
                blobs[cam, :len(vis)] = pts[vis, cam]
                ok[cam, :len(vis)] = True
            st, o = pipeline.track_from_blobs(
                st, torch.from_numpy(blobs).to(d), torch.from_numpy(ok).to(d),
                np.float32(1 / 60), *cal, **kw)
            out.append(pipeline.pack_outputs(o).cpu().numpy())
        rows.append(np.stack(out))
    layout = (4, 16, 2, True, 3)
    for g, w in zip(pipeline.unpack_outputs_batch(rows[1], *layout),
                    pipeline.unpack_outputs_batch(rows[0], *layout)):
        np.testing.assert_array_equal(g.bodies.valid, w.bodies.valid)
        np.testing.assert_array_equal(g.tracked_bodies.valid,
                                      w.tracked_bodies.valid)
        for a, b in zip((*g.bodies, *g.tracked_bodies),
                        (*w.bodies, *w.tracked_bodies)):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert g.bodies.valid[0] and g.bodies.valid[2]


def test_preprocess_conv_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.random((4, 320, 320)).astype(np.float32))
    got = detect.preprocess(frames.to(dev)).cpu()
    torch.testing.assert_close(got, detect.preprocess(frames), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("B", [1, 128])
def test_bank_kernel_at_the_large_rigs_width(dev, B):
    """16 cameras of 8 blob slots: M = 128 candidates (under the 1,024 at
    which the kernel stages candidates another way), two drones."""
    case = [torch.from_numpy(a).to(dev) for a in _bank_case(6, B, 128, 2)]
    _check_bank(dev, case, 2)


def test_bank_kernel_over_a_long_recording(dev):
    """The offline causal pass: 1,500 steps in one launch, then another
    1,500 from the carried state, against the plain chain."""
    case = [torch.from_numpy(a).to(dev) for a in _bank_case(8, 1500, 32, 2)]
    _check_bank(dev, case, 2)


@pytest.mark.parametrize("O", [1, 2, 9])
@pytest.mark.parametrize("M", [32, 128])
@pytest.mark.parametrize("B", [1, 128, 1500])
def test_forward_kernel_matches_plain_chain(dev, B, M, O):
    """The smoother's forward filter in one launch (O = 9: two blocks)
    against the plain chain (``kalman.forward_filter``): the tracks, the
    per-step x, P and initialised flags and the final state bitwise, then
    a second batch from the first's end."""
    case = [torch.from_numpy(a).to(dev)
            for a in forward_case(B + M + O, B, M, O)]
    st = kalman.init_state(O, device=dev)
    for _ in range(2):
        n0, f0 = kalman_cuda.launches, kalman_cuda.forward_launches
        got = kalman_cuda.forward_scan(st, *case)
        assert (kalman_cuda.launches - n0, kalman_cuda.forward_launches - f0) \
            == (1, 1)
        want = kalman.forward_filter(st, *case)
        torch.cuda.synchronize()
        _assert_same(tree.leaves(got), tree.leaves(want))
        st = got[0]


def _two_drones(T, K):
    """Host blobs (T, 4, K, 2), valid (T, 4, K) of two drones circling on
    the 4-camera ring: drone 1 out of sight for 100 frame sets (past
    ``gap_reset_s`` at 150 frames/s), drone 0 for 5."""
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    blobs = np.zeros((T, 4, K, 2), np.float32)
    valid = np.zeros((T, 4, K), bool)
    for t in range(T):
        a = t / 150
        drones = [syn.drone_markers(np.array(
            [0.3 * np.cos(a), 0.3 * np.sin(a), 0.6], np.float32), 0.0, rig),
            syn.drone_markers(np.array(
                [-0.3 * np.cos(a), 0.2, 0.5 + 0.1 * np.sin(a)], np.float32),
                np.pi, rig)]
        if 400 <= t < 500:
            drones = drones[:1]
        elif 900 <= t < 905:
            drones = drones[1:]
        pts, mask = syn.observe(np.concatenate(drones), Rs, ts, rig)
        for c in range(4):
            vis = np.flatnonzero(mask[:, c])[:K]
            blobs[t, c, :len(vis)] = pts[vis, c]
            valid[t, c, :len(vis)] = True
    return (blobs, valid), Rs, ts, rig


@pytest.mark.parametrize("chunk", [8, 32, 100])
def test_process_recording_smooths_with_one_forward_launch(dev, chunk,
                                                           monkeypatch):
    """``process_recording(smooth=True)`` over 1,500 frame sets: one launch
    of the forward filter whatever the chunk, no ``_forward_step`` step
    replayed, and smoothed tracks bitwise those of the same call with the
    plain forward chain (a ``ChunkedScan`` of graphs) on the card."""
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.models import offline
    from low_cost_mocap_tpu_torch.ops import camera
    from low_cost_mocap_tpu_torch.runtime import compiled

    cfg = EngineConfig()
    T = 1500
    rec, Rs, ts, rig = _two_drones(T, cfg.max_blobs)
    K = torch.as_tensor(rig.K_stack(), device=dev)
    cal = (camera.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                    torch.as_tensor(ts, device=dev)),
           K, torch.as_tensor(rig.dist_stack(), device=dev),
           torch.eye(4, device=dev))
    dts = np.full((T,), 1 / 150, np.float32)
    calls = []
    run = compiled.CompiledStep.__call__

    def counting(self, *a):
        calls.append(self.name)
        return run(self, *a)

    monkeypatch.setattr(compiled.CompiledStep, "__call__", counting)

    def call():
        return offline.process_recording(rec, *cal, rig, cfg, dts=dts,
                                         chunk=chunk, smooth=True)

    f0 = kalman_cuda.forward_launches
    got = call()
    assert kalman_cuda.forward_launches - f0 == 1
    assert "_forward_step" not in calls and "_rts_step" in calls
    monkeypatch.setattr(kalman_cuda, "forward_scan", kalman.forward_filter)
    want = call()
    torch.cuda.synchronize()
    assert kalman_cuda.forward_launches - f0 == 1
    assert calls.count("_forward_step") == -(-T // chunk)
    _assert_same(tree.leaves(got.smoothed), tree.leaves(want.smoothed))
    # the long gap is bridged by the smoother
    assert not bool(got.tracked.valid[450].all())
    assert bool(got.smoothed.valid[450].all())


def test_detection_inside_process_recording_matches_plain(dev):
    """Offline processing from frames launches the detection kernel once
    per chunk over the chunk's frame sets side by side; its results equal
    those of the plain detector's blobs, frame set by frame set."""
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.models import offline
    from low_cost_mocap_tpu_torch.ops import camera
    from low_cost_mocap_tpu_torch.runtime import compiled
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    cfg = EngineConfig()
    frames = []
    for t in range(20):
        pos = np.array([0.3 * np.cos(t / 40), 0.3 * np.sin(t / 40), 0.6],
                       np.float32)
        pts, mask = syn.observe(syn.drone_markers(pos, 0.0, rig), Rs, ts,
                                rig)
        frames.append(syn.render_frames(pts, mask, rig.image_size, sigma=0.8))
    frames = (np.stack(frames) * 255).astype(np.uint8)
    K = torch.as_tensor(rig.K_stack(), device=dev)
    cal = (camera.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                    torch.as_tensor(ts, device=dev)),
           K, torch.as_tensor(rig.dist_stack(), device=dev),
           torch.eye(4, device=dev))
    f = torch.from_numpy(frames).to(dev).to(torch.float32) * (1.0 / 255.0)
    plain = [detect.find_blobs_multi(x, cfg.detect_threshold, cfg.max_blobs,
                                     cfg.cc_iters) for x in f]
    blobs = torch.stack([p[0] for p in plain])
    valid = torch.stack([p[1] for p in plain])
    def launched():
        # a graph's warm-up calls at its capture are counted apart
        return (detect_cuda.launches
                - compiled.warmup_launches[detect_cuda.NAME])

    n0 = launched()
    got = offline.process_recording(frames, *cal, rig, cfg, chunk=8)
    assert launched() - n0 == 3         # chunks of 8, 8 and 4 padded to 8
    want = offline.process_recording((blobs, valid), *cal, rig, cfg)
    for a, b in zip(got[:5], want[:5]):
        _assert_same((a,), (b,))
    _assert_same(got.tracked, want.tracked)


def _moving_frames(T, seed, rig, Rs, ts):
    """(T, 4, H, W) uint8 frame sets of two drones circling fast enough
    that every frame set differs from the last (a seed-drawn phase)."""
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    phase = np.random.default_rng(seed).uniform(0, 2 * np.pi)
    frames = []
    for t in range(T):
        a = phase + 0.07 * t
        X = np.concatenate([
            syn.drone_markers(np.array([0.3 * np.cos(a), 0.3 * np.sin(a),
                                        0.6], np.float32), 0.0, rig),
            syn.drone_markers(np.array([-0.3 * np.cos(a), 0.2,
                                        0.5 + 0.1 * np.sin(a)], np.float32),
                              np.pi, rig)])
        pts, mask = syn.observe(X, Rs, ts, rig)
        frames.append(syn.render_frames(pts, mask, rig.image_size, sigma=0.8))
    return (np.stack(frames) * 255).astype(np.uint8)


def _bitwise(got, want):
    """Every leaf of two results equal bit for bit."""
    got, want = tree.leaves(got), tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g.contiguous().view(torch.uint8),
                           w.contiguous().view(torch.uint8))


@pytest.mark.parametrize("T,chunk,calls", [(77, 32, 1), (61, 4, 2)])
def test_staged_upload_matches_the_direct_path(dev, T, chunk, calls):
    """``process_recording(smooth=True)`` on uint8 frames in host memory
    goes up through the staging ring (``offline.staged_chunks`` rises by
    ceil(T / chunk) a call), on the same frames already on the card takes
    the direct copy (0), and every output is bitwise the same.  With
    ``chunk`` 4 many chunks are in flight and the host runs ahead; two
    calls back to back on two recordings, neither read before the other
    starts, show a slot rewritten under its upload or read stale."""
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.models import offline
    from low_cost_mocap_tpu_torch.ops import camera
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    cfg = EngineConfig()
    K = torch.as_tensor(rig.K_stack(), device=dev)
    cal = (camera.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                    torch.as_tensor(ts, device=dev)),
           K, torch.as_tensor(rig.dist_stack(), device=dev),
           torch.eye(4, device=dev))
    recs = [_moving_frames(T, 11 + i, rig, Rs, ts) for i in range(calls)]

    def call(frames):
        return offline.process_recording(frames, *cal, rig, cfg,
                                         chunk=chunk, smooth=True)

    staged = []
    for frames in recs:
        n0 = offline.staged_chunks
        staged.append(call(frames))
        assert offline.staged_chunks - n0 == -(-T // chunk)
    for frames, got in zip(recs, staged):
        n0 = offline.staged_chunks
        want = call(torch.from_numpy(frames).to(dev))
        assert offline.staged_chunks == n0
        torch.cuda.synchronize()
        _bitwise(got, want)
    if calls > 1:
        # the recordings differ, so equal results are not a stale slot's
        assert not torch.equal(staged[0].object_points,
                               staged[1].object_points)


def test_two_traces_in_a_row_both_list_the_kernels(dev, tmp_path):
    """Two ``device_trace`` sessions one after the other (after a session of
    the main thread), while another thread launches the bank kernel under
    the lock the traces take as ``quiesce``: both traces list kalman_bank
    kernels."""
    import json
    import threading

    from low_cost_mocap_tpu_torch.utils import profiling

    case = [torch.from_numpy(a).to(dev) for a in _bank_case(3, 4, 32, 2)]
    st = kalman.init_state(2, device=dev)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]):
        kalman_cuda.kalman_scan(st, *case)
        torch.cuda.synchronize()
    stop, lock = threading.Event(), threading.Lock()

    def loop():
        while not stop.is_set():
            with lock:
                kalman_cuda.kalman_scan(st, *case)
            torch.cuda.synchronize()
            stop.wait(0.002)

    th = threading.Thread(target=loop)
    th.start()
    paths = []
    try:
        for i in range(2):
            with profiling.device_trace(str(tmp_path / f"t{i}"), dev,
                                        lock) as path:
                time.sleep(0.3)
            paths.append(path)
    finally:
        stop.set()
        th.join()
    for path in paths:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("cat") == "kernel"
                   and "kalman_bank" in str(e.get("name")) for e in events)


@pytest.mark.parametrize("C,d", [(4, 2), (4, 4), (6, 2), (3, 3), (16, 4)])
def test_sharded_detection_matches_the_full_launch(dev, C, d):
    """The camera-sharded step detects each shard's C/d cameras in a launch
    of its own (odd C/d included); gathered in camera order, the blobs
    equal one launch over all C cameras and the plain detector, bit for
    bit.  The shards share the one card, as chip_smoke.py lays them out."""
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
    from low_cost_mocap_tpu_torch.parallel.dist_pipeline import gather_blobs

    cfg = EngineConfig()
    frames = torch.from_numpy(
        (_frames(C, C, 320, 320, cfg.cc_iters) * 255).astype(np.uint8))
    mesh = mesh_lib.make_mesh({"cam": d}, devices=[dev] * d)
    n0 = detect_cuda.launches
    got = gather_blobs(mesh, frames, cfg)
    assert detect_cuda.launches - n0 == d
    f = frames.to(dev).to(torch.float32) * (1.0 / 255.0)
    full = detect_cuda.find_blobs(f, cfg.detect_threshold, cfg.max_blobs,
                                  cfg.cc_iters)
    plain = detect.find_blobs_multi(f, cfg.detect_threshold, cfg.max_blobs,
                                    cfg.cc_iters)
    for want in (full, plain):
        assert torch.equal(got[..., :2], want[0])
        assert torch.equal(got[..., 2] > 0.5, want[1])


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_step_on_the_card_matches_the_single_device_step(dev, d):
    """dist_frame_step and dist_scan_frame_step with every shard on the
    card against frame_step and the batched tail on the same frames."""
    _check_sharded_step(dev, [dev] * d)


def _check_sharded_step(dev, shard_devices):
    """The sharded steps over a ``cam`` mesh of ``shard_devices`` (the tail
    on the first) against frame_step and the batched tail on ``dev``."""
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.models import pipeline
    from low_cost_mocap_tpu_torch.ops import camera
    from low_cost_mocap_tpu_torch.ops.correspond import \
        _pairwise_fundamentals
    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
    from low_cost_mocap_tpu_torch.parallel.dist_pipeline import (
        dist_frame_step, dist_scan_frame_step)
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    cfg = EngineConfig()
    frames = []
    for t in range(6):
        pos = np.array([0.3 * np.cos(t / 9), 0.3 * np.sin(t / 9), 0.6],
                       np.float32)
        pts, mask = syn.observe(syn.drone_markers(pos, 0.0, rig), Rs, ts,
                                rig)
        frames.append(syn.render_frames(pts, mask, rig.image_size, sigma=0.8))
    frames = torch.from_numpy((np.stack(frames) * 255).astype(np.uint8))
    K = torch.as_tensor(rig.K_stack(), device=dev)
    Ps = camera.projection_matrix(K, torch.as_tensor(Rs, device=dev),
                                  torch.as_tensor(ts, device=dev))
    cal = (Ps, K, torch.as_tensor(rig.dist_stack(), device=dev),
           torch.eye(4, device=dev), _pairwise_fundamentals(Ps))
    mesh = mesh_lib.make_mesh({"cam": len(shard_devices)},
                              devices=shard_devices)
    kw = dict(threshold=cfg.detect_threshold, max_blobs=cfg.max_blobs,
              cc_iters=cfg.cc_iters, gate_px=cfg.epipolar_gate_px,
              max_candidates=cfg.max_candidates_per_cam,
              marker_dist1=rig.marker_dist_short,
              marker_dist2=rig.marker_dist_long,
              marker_tol=rig.marker_dist_tol,
              marker_side_min=rig.marker_side_min, do_preprocess=False,
              with_obs=True)
    st_a = pipeline.make_init_state(rig, device=dev)
    st_b = pipeline.make_init_state(rig, device=dev)
    rows = []
    for f in frames:
        st_a, out = pipeline.frame_step(st_a, f.to(dev), np.float32(1 / 60),
                                        *cal, **kw)
        rows.append(pipeline.pack_outputs(out))
        st_b, row = dist_frame_step(mesh, st_b, f, np.float32(1 / 60), *cal,
                                    rig, cfg, with_obs=True, pack=True)
        assert torch.equal(row, rows[-1])
    _, batched = dist_scan_frame_step(
        mesh, pipeline.make_init_state(rig, device=dev), frames,
        np.full(6, 1 / 60, np.float32), *cal, rig, cfg, with_obs=True)
    assert torch.equal(batched, torch.stack(rows))


# Several cards: a shard whose card is not the current device.  These skip
# below two cards.

@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    return [torch.device("cuda", i) for i in range(n)]


def test_kernels_launch_on_a_card_that_is_not_current(cards):
    """Both wrappers on tensors of a card other than the current device:
    each kernel runs on its tensors' card, bitwise equal to its plain
    version there, and the current device stays as it was."""
    other = cards[-1]
    frames = torch.from_numpy(_frames(11, 4, 320, 320, 24)).to(other)
    got = _check_detect(frames, 8, 24)
    assert all(g.device == other for g in got)
    case = [torch.from_numpy(a).to(other) for a in _bank_case(5, 40, 33, 3)]
    _check_bank(other, case, 3)
    assert torch.cuda.current_device() == 0


def test_sharded_step_across_cards_matches_one_card(cards):
    """The sharded steps with each shard on its own card (the tail on the
    first), as ``make_mesh``'s default and ``serve --cam-shards`` lay them
    out, against the single-card steps."""
    d = 4 if len(cards) >= 4 else 2
    _check_sharded_step(cards[0], cards[:d])


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("batch", [1, 4])
def test_cam_shards_engine_across_cards_matches_one_card(cards, tmp_path,
                                                         batch, first):
    """``serve --cam-shards d`` lays the mesh on the first d cards; an
    Engine on that mesh, or on d cards from ``cuda:first`` on (its tail
    then on a card that is not current), serves, per frame and batched,
    payloads bitwise equal to a single-card device-detect engine's."""
    from low_cost_mocap_tpu_torch import serve
    from low_cost_mocap_tpu_torch.config import EngineConfig
    from low_cost_mocap_tpu_torch.parallel import mesh as mesh_lib
    from low_cost_mocap_tpu_torch.runtime.engine import Engine
    from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
    from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
    from low_cost_mocap_tpu_torch.utils import synthetic as syn

    d = 4 if len(cards) >= 4 else 2
    built, *_ = serve.build(serve.parse_args(
        ["--cam-shards", str(d), "--artifacts-dir", str(tmp_path)]))
    assert list(built._mesh.devices.flat) == cards[:d]
    assert built.device == cards[0]
    mesh = (built._mesh if first == 0 else mesh_lib.make_mesh(
        {"cam": d}, devices=(cards[first:] + cards[:first])[:d]))

    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    frames = [src.read_at(i / 60) for i in range(12)]

    def engine(cfg, **kw):
        e = Engine(rig, cfg, src, CollectingLink(), **kw)
        e.set_camera_poses(Rs, ts)
        e.is_capturing_points = True
        e.is_triangulating_points = True
        e.is_locating_objects = True
        got = []
        e.on("object-points", got.append)
        for f in frames:
            e.process_frame(f, 1 / 60)
        e.flush_batches()
        return got

    want = engine(EngineConfig(), device=cards[0], host_detect=False)
    got = engine(EngineConfig(dispatch_batch=batch), mesh=mesh)
    assert torch.cuda.current_device() == 0
    assert len(got) == len(want) == len(frames)
    for a, b in zip(got, want):
        assert a["object_points"] == b["object_points"]
        assert a["filtered_objects"] == b["filtered_objects"]
    assert want[-1]["filtered_objects"]


def test_two_nccl_ranks_on_two_cards():
    """Two NCCL ranks, each on its own card (rank r on ``cuda:r``), for the
    camera-sharded live step and the Schur solver: both ranks report the
    same result, equal to one process holding the same two shards."""
    from low_cost_mocap_tpu_torch.parallel.multiprocess import run_cluster

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    kw = dict(device="cuda", backend="nccl", timeout_s=300)
    for solver, keys in (("live-pipeline", ("rows_sha", "tracked_pos")),
                         ("schur", ("cost", "ts"))):
        one = run_cluster(1, 2, solver=solver, **kw)[0]
        two = run_cluster(2, 1, solver=solver, **kw)
        for key in keys:
            assert two[0][key] == two[1][key] == one[key], (solver, key)
