"""PyTorch port: offline processing as compiled steps (``models/offline.py``
over ``runtime/compiled.py``'s ``GraphCache`` and ``ChunkedScan``).

On the CPU every compiled step runs op by op over its buffers.  There the
chunked run, with its zero-padded last chunk, is bitwise equal to the
recording run as one batch with ``utils.tree.scan``'s loops (the eager
functions); streamed blocks, the partial last one included, are bitwise
equal to the one-shot run; both agree with the JAX package at chunk and
block sizes 6-8 (discrete fields equal, floats within 1e-5, the jitted
JAX Kalman chain included; quaternions within 1e-4 as in
``tests/test_torch_offline.py``).  A fresh recording length captures
no new graph and no graph of T frames; the cache keeps at most 16 steps.
The graphs themselves are held to ``compiled.disable_graphs()`` on the card
by ``tests/test_torch_compiled.py``'s ``cuda`` cases (this file imports
JAX) and by ``chip_smoke.py`` [16c].
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
from low_cost_mocap_tpu.models import offline as joff
from low_cost_mocap_tpu.ops.rigid_general import make_template as jmake
from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.models import offline, pipeline
from low_cost_mocap_tpu_torch.ops import (body_tracker, camera, correspond,
                                          kalman)
from low_cost_mocap_tpu_torch.ops.rigid_general import make_template
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.utils import synthetic as syn
from low_cost_mocap_tpu_torch.utils import tree

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
T = 23
CHUNK = 6
BODY = np.array([[0.0, 0.0, 0.0], [0.12, 0.0, 0.0], [0.0, 0.09, 0.0],
                 [0.05, 0.03, 0.06]], np.float32)


def _orbit(t):
    return np.array([0.3 * np.cos(t / 9), 0.3 * np.sin(t / 9), 0.6],
                    np.float32)


@pytest.fixture(scope="module")
def rec():
    """T frame sets of a drone and the asymmetric body on the 4-camera
    ring, host-detected, with both packages' calibrations; a dropout run
    in frames 9-11 gives the smoothers a gap."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    frames = []
    for t in range(T):
        c, s = np.cos(0.08 * t), np.sin(0.08 * t)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        X = np.concatenate([syn.drone_markers(_orbit(t), 0.0, rig),
                            BODY @ Rz.T + _orbit(t + 20) * [1, 1, 0.5]])
        if 9 <= t <= 11:
            X = X[3:]
        pts, mask = syn.observe(X, Rs, ts, rig)
        frames.append(syn.render_frames(pts, mask, rig.image_size,
                                        sigma=0.8))
    frames = (np.stack(frames) * 255).astype(np.uint8)
    b, v = offline.detect_recording_host(frames, 0.2, 8)
    K = torch.tensor(rig.K_stack())
    dist = torch.tensor(rig.dist_stack())
    Ps = camera.projection_matrix(K, torch.tensor(Rs), torch.tensor(ts))
    jcal = (jnp.asarray(Ps.numpy()), jnp.asarray(rig.K_stack()),
            jnp.asarray(rig.dist_stack()), jnp.eye(4))
    A = np.array([[-1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    dts = np.full((T,), 1 / 60, np.float32)
    dts[12] = 0.05
    return dict(frames=frames, blobs=(b, v), rig=rig, cfg=EngineConfig(),
                jcfg=JEngineConfig(), cal=(Ps, K, dist, torch.eye(4)),
                jcal=jcal, dts=dts, sets=((make_template(BODY @ A.T), 2),),
                jsets=((jmake(BODY @ A.T), 2),))


def _equal(a, b, what=""):
    """Every tensor leaf of two results bitwise equal (NaN included)."""
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        x, y = a.contiguous(), b.contiguous()
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), what
    else:
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}.{getattr(a, '_fields', range(99))[i]}")


def _close(got, want, what):
    if got is None:
        assert want is None, what
        return
    if isinstance(got, torch.Tensor):
        g, w = got.numpy(), np.asarray(want)
        if g.dtype == bool or g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            tol = dict(atol=1e-4) if what.endswith("quat") else TOL
            np.testing.assert_allclose(g, w, err_msg=what, **tol)
        return
    for name, g, w in zip(got._fields, got, want):
        _close(g, w, f"{what}.{name}")


def _reference(rec, smooth):
    """The recording op by op as one batch: the vision over all T frame
    sets at once, the bank, and the loops of ``utils.tree.scan``."""
    b, v = (torch.as_tensor(a) for a in rec["blobs"])
    rig, cfg, sets = rec["rig"], rec["cfg"], rec["sets"]
    Ps, K, dist, M = rec["cal"]
    dts = torch.as_tensor(rec["dts"])
    pts_w, pvalid, perr, loc = offline._blob_tail(
        b, v, Ps, K, dist, M, correspond._pairwise_fundamentals(Ps), rig, cfg)
    _, tracked = pipeline._bank(kalman.init_state(rig.num_objects, "cpu"),
                                loc, dts, cfg.kalman_report, "auto")
    bodies = offline._fit_bodies(pts_w, pvalid, sets)
    _, tracks = offline._track_bodies(
        (body_tracker.init_state(2, "cpu"),), bodies, dts, sets)
    smoothed = smoothed_bodies = None
    if smooth:
        smoothed, _ = kalman.smooth_sequence(
            kalman.init_state(rig.num_objects, "cpu"), loc.pos, loc.heading,
            loc.index, loc.valid, dts,
            process_noise=cfg.kalman_process_noise,
            meas_noise=cfg.kalman_measurement_noise)
        smoothed_bodies = body_tracker.smooth_body_sequence(
            bodies.t, bodies.R, bodies.rms, bodies.valid, dts, max_bodies=2)
    return offline.SequenceResult(pts_w, pvalid, perr, loc.pos, loc.valid,
                                  tracked, bodies, tracks, smoothed,
                                  smoothed_bodies)


@pytest.mark.parametrize("chunk", [CHUNK, T])
def test_chunked_run_equals_the_recording_as_one_batch(rec, chunk):
    """Chunks of 6 (the last one of 5 padded with a dead frame) and one
    chunk of T, smoothing and body sets included: bitwise equal to the
    reference run op by op."""
    got = offline.process_recording(
        rec["blobs"], *rec["cal"], rec["rig"], rec["cfg"], dts=rec["dts"],
        chunk=chunk, body_sets=rec["sets"], smooth=True)
    assert bool(got.bodies.valid.any()) and bool(got.smoothed.valid.any())
    _equal(got, _reference(rec, smooth=True))


def test_chunked_run_matches_jax_with_smoothing_and_bodies(rec):
    b, v = rec["blobs"]
    want = joff.process_recording(
        (jnp.asarray(b), jnp.asarray(v)), *rec["jcal"], rec["rig"],
        rec["jcfg"], dts=jnp.asarray(rec["dts"]), chunk=CHUNK,
        body_sets=rec["jsets"], smooth=True)
    got = offline.process_recording(
        rec["blobs"], *rec["cal"], rec["rig"], rec["cfg"], dts=rec["dts"],
        chunk=CHUNK, body_sets=rec["sets"], smooth=True)
    for name in ("object_points", "point_valid", "objects_pos",
                 "objects_valid", "tracked", "bodies", "body_tracks",
                 "smoothed", "smoothed_bodies"):
        _close(getattr(got, name), getattr(want, name), name)


def test_streamed_blocks_match_jax_and_the_one_shot_run(rec):
    """Blocks of 8 (15 = 8 + 7 frames, then the state carried into the
    other 8): against JAX's streamed run, and bitwise equal to the one-shot
    run at ``chunk`` = the block and to one streamed call."""
    frames, dts, rig, cfg = rec["frames"], rec["dts"], rec["rig"], rec["cfg"]
    kw = dict(block=8, body_sets=rec["sets"])
    first, st = offline.stream_recording(frames[:15], *rec["cal"], rig, cfg,
                                         dts=dts[:15], **kw)
    rest, _ = offline.stream_recording(frames[15:], *rec["cal"], rig, cfg,
                                       dts=dts[15:], state=st, **kw)
    jfirst, jst = joff.stream_recording(
        frames[:15], *rec["jcal"], rig, rec["jcfg"], dts=dts[:15], block=8,
        body_sets=rec["jsets"])
    for name in ("object_points", "objects_valid", "tracked", "bodies",
                 "body_tracks"):
        _close(getattr(first, name), getattr(jfirst, name), name)
    one, _ = offline.stream_recording(frames, *rec["cal"], rig, cfg, dts=dts,
                                      **kw)
    _equal(tree.cat([first, rest]), one)
    want = offline.process_recording(rec["blobs"], *rec["cal"], rig, cfg,
                                     dts=dts, chunk=8, body_sets=rec["sets"])
    _equal(one, want._replace(smoothed=None, smoothed_bodies=None))
    # the returned state is the caller's own, not the cached step's
    cached = [s.state for s in offline._BLOCKS.values()]
    assert cached and all(
        x.data_ptr() != y.data_ptr() for c in cached
        for x, y in zip(tree.leaves(st), tree.leaves(c)))


def _scan_lengths():
    """(chunk lengths of the cached loops, leading sizes of the cached
    vision steps' payload buffers)."""
    return ([s.length for s in offline._SCANS.values()],
            [tree.leaves(s.args[0])[0].shape[0]
             for s in offline._VISION.values()])


def test_a_fresh_length_captures_no_new_graph(rec, monkeypatch):
    """Two recording lengths (23 and 17 frame sets) through the same
    options: the second adds no step to the cache, every cached loop is a
    chunk of 6 frames and every vision buffer 6 frame sets long, and the
    replays a call makes are ceil(T / 6) a loop."""
    offline.clear_cache()
    calls = []
    run = compiled.CompiledStep.__call__

    def counting(self, *a):
        calls.append(self.name)
        return run(self, *a)

    monkeypatch.setattr(compiled.CompiledStep, "__call__", counting)
    kw = dict(chunk=CHUNK, body_sets=rec["sets"], smooth=True)
    b, v = rec["blobs"]
    offline.process_recording((b, v), *rec["cal"], rec["rig"], rec["cfg"],
                              dts=rec["dts"], **kw)
    n_steps = len(offline.cached_steps())
    assert calls.count("offline blobs") == 4          # ceil(23 / 6)
    calls.clear()
    offline.process_recording((b[:17], v[:17]), *rec["cal"], rec["rig"],
                              rec["cfg"], dts=rec["dts"][:17], **kw)
    assert len(offline.cached_steps()) == n_steps
    scans, steps = _scan_lengths()
    # the vision; the forward chain, the RTS pass; the body tracker; the
    # body smoother's association, filter, RTS pass and sign alignment
    assert sorted(scans) == [CHUNK] * 7 and steps == [CHUNK]
    assert calls.count("offline blobs") == 3          # ceil(17 / 6)
    # forward loops ceil(17 / 6) = 3 chunks, the RTS passes ceil(16 / 6)
    assert calls.count("_forward_step") == 3
    assert calls.count("_rts_step") == 3


def test_host_frames_on_the_cpu_take_no_staging_ring(rec):
    """On the CPU uint8 frames in host memory load straight into the
    vision step's buffer: no chunk goes through a staging ring (the card's
    page-locked uploads, ``offline._Staging``)."""
    n0 = offline.staged_chunks
    got = offline.process_recording(rec["frames"], *rec["cal"], rec["rig"],
                                    rec["cfg"], chunk=CHUNK)
    assert offline.staged_chunks == n0
    assert got.object_points.shape[0] == T
    assert len(offline._STAGING) == 0


def test_the_cache_keeps_the_most_recent_steps():
    cache = compiled.GraphCache(size=3)
    built = []
    for key in (1, 2, 3, 1, 4, 5):
        cache.get(key, lambda key=key: built.append(key) or key)
    assert built == [1, 2, 3, 4, 5] and len(cache) == 3
    assert cache.values() == [1, 4, 5]       # 2 and 3 were dropped
    assert all(c.size == compiled.CACHE_SIZE == 16 for c in (
        offline._VISION, offline._BLOCKS, offline._SCANS))


def test_chunked_scan_pads_past_the_ends():
    """A running sum forward and backward over 7 frames in chunks of 3: the
    padded frames come after every real one in loop order."""
    def step(c, x):
        c = c + x
        return c, c

    xs = torch.arange(1.0, 8.0)
    for reverse in (False, True):
        sc = compiled.ChunkedScan(step, torch.zeros(()), (xs,), 3,
                                  reverse=reverse)
        want = tree.scan(step, torch.zeros(()), xs, reverse=reverse)[1]
        assert torch.equal(sc.run(torch.zeros(()), xs), want)

