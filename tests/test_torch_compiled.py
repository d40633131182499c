"""PyTorch port: the compiled steps (``runtime/compiled.py``), the
counterpart of the JAX package's jitted, state-donating steps
(``low_cost_mocap_tpu/runtime/engine.py:_build_steps``).

On the CPU a compiled step runs its function eagerly over its static
buffers, with the same donation as on the card, so these tests hold every
kind of the Engine's step (host blobs, sparse, packed, dense, the batched
program with and without the body stage) and ``MocapPipeline.step`` to the
plain calls bitwise; the Engine's state object is its buffers; new
calibration is copied into the buffers in place; learn-body-template's
rebuild serves the new layout; a device ``dt`` gives the bits of a number;
the step's constants are built once per device.

The ``cuda``-marked cases need a card and skip here: each kind's CUDA graph
against the step called op by op, a step that syncs refused at capture,
the rows read back in order at readback depth 2 and with the emit worker,
the camera-sharded steps on one card and on two, and offline processing
(``models/offline.py``'s chunk graphs) against ``compiled.disable_graphs``.
On a machine with a card, from the repository root:

    python -m pytest tests/test_torch_compiled.py -q -o addopts="" \
        --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.control import bindings
from low_cost_mocap_tpu_torch.models import pipeline
from low_cost_mocap_tpu_torch.ops import (assignment, body_tracker,
                                          correspond, detect, kalman,
                                          rigid_general)
from low_cost_mocap_tpu_torch.runtime import compiled
from low_cost_mocap_tpu_torch.runtime.engine import (
    Engine, camera_poses_to_serializable)
from low_cost_mocap_tpu_torch.runtime.serial_link import CollectingLink
from low_cost_mocap_tpu_torch.runtime.sources import SyntheticSource
from low_cost_mocap_tpu_torch.utils import synthetic as syn
from low_cost_mocap_tpu_torch.parallel.mesh import make_mesh
from low_cost_mocap_tpu_torch.utils.tree import leaves

torch.set_num_threads(1)

N_FRAMES = 20
IMAGE = 160
TMPL_A = ((0.0, 0.0, 0.0), (0.12, 0.0, 0.0), (0.0, 0.09, 0.0),
          (0.05, 0.04, 0.07))
TMPL_B = ((0.0, 0.0, 0.0), (0.2, 0.0, 0.0), (0.1, 0.16, 0.0),
          (0.02, 0.05, 0.11))
# the Engine's options for each kind of per-frame step
KINDS = {"blobs": dict(host_detect=True),
         "sparse": dict(fast_path=True, host_detect=False),
         "packed": dict(fast_path=True, host_detect=False),
         "dense": dict(fast_path=False)}


def _scene(num_cameras=4):
    Rs, ts, rig = syn.ring_rig(num_cameras=num_cameras, image_size=IMAGE)
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    return Rs, ts, rig, src


def _engine(rig, cfg, Rs, ts, device="cpu", **kw):
    """A tracking engine; host detection unless ``kw`` says otherwise (a
    CUDA engine's default)."""
    if "fast_path" not in kw:
        kw.setdefault("host_detect", True)
    eng = Engine(rig, cfg, None, CollectingLink(), device=device, **kw)
    eng.set_camera_poses(Rs, ts)
    return eng


def _bits(x):
    """A float32 tensor's bits, so that equality is bitwise (inf, NaN)."""
    return x.contiguous().view(torch.int32)


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a.cpu()), _bits(b.cpu()))


def _payload(kind, frames, cfg, rig):
    """The Engine's ingest of one uint8 frame set for ``kind``, on the
    host: the payload and the plain call's keyword options."""
    if kind == "blobs":
        return torch.from_numpy(bindings.ingest_detect_packed(
            frames, detect.threshold_cutoff(cfg.detect_threshold),
            cfg.max_blobs)), {}
    if kind == "sparse":
        idx, ok, _ = detect.sparse_ingest(frames, cfg.detect_threshold,
                                          cfg.sparse_budget)
        assert ok
        return torch.from_numpy(idx), dict(
            sparse_input=True, image_shape=(rig.num_cameras,
                                            *rig.image_hw()))
    if kind == "packed":
        return torch.from_numpy(detect.pack_frames(
            frames, cfg.detect_threshold)), dict(packed_input=True)
    return torch.from_numpy(np.ascontiguousarray(frames)), {}


def _plain_step(eng, kind, state, payload, dt, ingest, cal=None):
    """The step's plain call: ``track_from_blobs`` or ``frame_step``."""
    cal = eng._calibration() if cal is None else cal
    payload = payload.to(eng.device)
    if kind == "blobs":
        state, out = pipeline.track_from_blobs(
            state, payload[..., :2], payload[..., 2] > 0.5, dt, *cal,
            **eng._tail_kw)
    else:
        state, out = pipeline.frame_step(state, payload, dt, *cal,
                                         **eng._step_kw, **ingest)
    return state, pipeline.pack_outputs(out)


@pytest.mark.parametrize("kind", list(KINDS))
def test_each_kind_of_step_gives_the_plain_rows_and_state(kind):
    """20 frames through the compiled step (its CPU mode) and through the
    plain call, from the same initial state: rows bitwise equal, and the
    Engine's state, which is the step's buffers, equal to the plain
    chain's."""
    Rs, ts, rig, src = _scene()
    cfg = EngineConfig()
    eng = _engine(rig, cfg, Rs, ts, **KINDS[kind])
    assert kind in eng._steps
    state0 = eng._kalman_state
    bufs = leaves(state0)
    st = pipeline.make_init_state(rig, device="cpu")
    for i in range(N_FRAMES):
        frames = src.read_at(i / 60)
        dt = np.float32(1 / 60 + 1e-3 * i)
        payload, ingest = _payload(kind, frames, cfg, rig)
        state, row = eng._step(kind, payload, dt)
        st, want = _plain_step(eng, kind, st, payload, dt, ingest)
        assert state is state0 and all(
            a is b for a, b in zip(leaves(state), bufs))
        assert _same_bits(row, want), f"frame {i}"
    assert all(torch.equal(a, b) for a, b in zip(bufs, leaves(st)))
    assert leaves(st)[0].abs().sum() > 0      # the drones were tracked


def _body_rig(rig):
    return dataclasses.replace(rig, body_markers=TMPL_A, max_bodies=1,
                               body_sets=((TMPL_B, 1),))


def _rot_up(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _blob_sets(n, rig, Rs, ts, K, bodies):
    """(n, C, K, 3) [x, y, valid] blob sets of two drones and, with
    ``bodies``, props A and B, each moving a little every frame."""
    src = SyntheticSource(rig, Rs, ts, num_drones=2, headings=(0.0, np.pi))
    out = np.zeros((n, rig.num_cameras, K, 3), np.float32)
    for i in range(n):
        parts = [syn.drone_markers(*src.drone_pose(d, i / 60), rig)
                 for d in range(2)]
        if bodies:
            for tmpl, centre, yaw in ((TMPL_A, (-0.3, 0.25, 0.1), 0.4),
                                      (TMPL_B, (0.3, 0.25, -0.1), 2.1)):
                Xw = (np.asarray(tmpl, np.float32) @ _rot_up(
                    yaw + 0.02 * i).T + np.asarray(centre, np.float32)
                    + np.float32(0.002 * i))
                # display world [x, up, z] -> the triangulation frame
                parts.append(Xw[:, [0, 2, 1]]
                             * np.array([-1, -1, 1], np.float32))
        pts, mask = syn.observe(np.concatenate(parts), Rs, ts, rig)
        for c in range(rig.num_cameras):
            vis = np.where(mask[:, c])[0][:K]
            out[i, c, :len(vis), :2] = pts[vis, c]
            out[i, c, :len(vis), 2] = 1.0
    return out


@pytest.mark.parametrize("bodies", [False, True], ids=["drones", "bodies"])
def test_batched_program_gives_scan_track_from_blobs_rows(bodies):
    """The compiled batched program (geometry and bank, then with body
    templates the body stage replayed frame by frame over its slots)
    against ``scan_track_from_blobs``: two batches of 3, rows and state
    bitwise equal."""
    B = 3
    Rs, ts, rig, _ = _scene()
    rig = _body_rig(rig) if bodies else rig
    cfg = EngineConfig(dispatch_batch=B, max_blobs=16 if bodies else 8)
    eng = _engine(rig, cfg, Rs, ts, host_detect=True)
    step = eng._steps["batched"]
    assert (step.body is not None) == bodies
    blobs = _blob_sets(2 * B, rig, Rs, ts, cfg.max_blobs, bodies)
    st = pipeline.make_init_state(rig, device="cpu")
    for r in range(2):
        payload = blobs[r * B:(r + 1) * B]
        dts = np.float32(1 / 60) + np.arange(B, dtype=np.float32) * 1e-3
        state, rows = step(eng._kalman_state, payload, dts,
                           *eng._calibration())
        assert state is eng._kalman_state
        p = torch.from_numpy(payload)
        st, want = pipeline.scan_track_from_blobs(
            st, p[..., :2], p[..., 2] > 0.5, dts, *eng._calibration(),
            **eng._tail_kw)
        assert _same_bits(rows, want)
    assert all(torch.equal(a, b) for a, b in zip(leaves(eng._kalman_state),
                                                 leaves(st)))
    if bodies:   # the body stage fit and tracked both props
        assert bool(st[1][0].active.all() and st[1][1].active.all())


def _track(eng, Rs, ts):
    got = []
    eng.on("object-points", got.append)
    eng.handle("triangulate-points", {
        "startOrStop": "start",
        "cameraPoses": camera_poses_to_serializable(Rs, ts)})
    eng.handle("locate-objects", {"startOrStop": "start"})
    return got


def test_the_engine_state_is_the_steps_buffers_across_frames_and_resets():
    """process_frame leaves the new state in the same tensors frame after
    frame (donation), equal to the plain chain's; triangulate-points'
    reset writes the initial state into them."""
    Rs, ts, rig, src = _scene()
    cfg = EngineConfig()
    eng = _engine(rig, cfg, Rs, ts)
    assert eng._host_detect
    _track(eng, Rs, ts)
    state0, bufs = eng._kalman_state, leaves(eng._kalman_state)
    st = pipeline.make_init_state(rig, device="cpu")
    for i in range(10):
        frames = src.read_at(i / 60)
        eng.process_frame(frames, 1 / 60)
        payload, _ = _payload("blobs", frames, cfg, rig)
        st, _ = _plain_step(eng, "blobs", st, payload, np.float32(1 / 60),
                            {})
        assert eng._kalman_state is state0
    assert all(a is b for a, b in zip(leaves(eng._kalman_state), bufs))
    assert all(torch.equal(a, b) for a, b in zip(bufs, leaves(st)))
    _track(eng, Rs, ts)
    assert eng._kalman_state is state0
    assert all(torch.equal(a, b) for a, b in zip(
        bufs, leaves(pipeline.make_init_state(rig, device="cpu"))))


def test_set_calibration_between_frames_gives_the_plain_rows_of_the_new():
    """New poses and a new world matrix between frames: copied into the
    same calibration buffers, and the rows are the plain call's with the
    new calibration."""
    from low_cost_mocap_tpu_torch.ops import camera

    Rs, ts, rig, src = _scene()
    cfg = EngineConfig()
    eng = _engine(rig, cfg, Rs, ts)
    bufs = eng._calibration()
    rng = np.random.default_rng(3)
    c, s = np.cos(0.01), np.sin(0.01)
    dR = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    Rs2 = np.einsum("ij,cjk->cik", dR, Rs).astype(np.float32)
    ts2 = (ts + rng.normal(scale=0.01, size=ts.shape)).astype(np.float32)
    M2 = np.eye(4, dtype=np.float32)
    M2[:3, 3] = (0.1, -0.2, 0.05)

    def plain_cal(R, t, M):
        K = torch.as_tensor(rig.K_stack())
        Ps = camera.projection_matrix(K, torch.as_tensor(R),
                                      torch.as_tensor(t))
        return (Ps, K, torch.as_tensor(rig.dist_stack()), torch.as_tensor(M),
                correspond._pairwise_fundamentals(Ps))

    segments = [(Rs, ts, np.eye(4, dtype=np.float32)),
                (Rs2, ts2, np.eye(4, dtype=np.float32)), (Rs2, ts2, M2)]
    st = pipeline.make_init_state(rig, device="cpu")
    i = 0
    for k, (R, t, M) in enumerate(segments):
        if k == 1:
            eng.set_camera_poses(R, t)
        elif k == 2:
            eng.set_to_world_matrix(M)
        for _ in range(4):
            frames = src.read_at(i / 60)
            payload, _ = _payload("blobs", frames, cfg, rig)
            _, row = eng._step("blobs", payload, np.float32(1 / 60))
            st, want = _plain_step(eng, "blobs", st, payload,
                                   np.float32(1 / 60), {},
                                   cal=plain_cal(R, t, M))
            assert _same_bits(row, want), f"segment {k}"
            i += 1
    assert all(a is b for a, b in zip(eng._calibration(), bufs))
    assert torch.equal(eng._M, torch.as_tensor(M2))


def test_learn_body_template_rebuilds_the_steps_and_serves_the_new_rows():
    """``_apply_rig`` (learn-body-template's apply): new state buffers
    (the body states join), new steps, and rows of the new layout equal
    to the plain call's with the body set."""
    Rs, ts, rig, _ = _scene()
    cfg = EngineConfig(max_blobs=16)
    eng = _engine(rig, cfg, Rs, ts)
    old = eng._steps["blobs"]
    blobs = _blob_sets(6, _body_rig(rig), Rs, ts, 16, True)
    for b in blobs[:2]:
        eng._step("blobs", torch.from_numpy(b), np.float32(1 / 60))
    eng._apply_rig(dataclasses.replace(rig, body_markers=TMPL_A,
                                       max_bodies=1))
    step = eng._steps["blobs"]
    assert step is not old and step.state is eng._kalman_state
    assert isinstance(eng._kalman_state, tuple) and eng._layout[4] == 1
    L = pipeline.row_length(*eng._layout)
    st = pipeline.make_init_state(eng.rig, device="cpu")
    for b in blobs[2:]:
        payload = torch.from_numpy(b)
        _, row = eng._step("blobs", payload, np.float32(1 / 60))
        st, want = _plain_step(eng, "blobs", st, payload, np.float32(1 / 60),
                               {})
        assert row.shape == (L,) and _same_bits(row, want)
    assert bool(st[1][0].active.any())


def test_a_device_dt_gives_the_bits_of_a_number():
    """``track_from_blobs`` with a 0-d float32 tensor ``dt`` and
    ``scan_track_from_blobs`` with a (B,) tensor ``dts``, as the compiled
    steps pass them, give the rows of a Python / numpy dt."""
    Rs, ts, rig, _ = _scene()
    eng = _engine(rig, EngineConfig(max_blobs=16), Rs, ts)
    blobs = torch.from_numpy(_blob_sets(3, _body_rig(rig), Rs, ts, 16,
                                        True))
    kw = dict(eng._tail_kw, body_sets=_body_rig(rig).body_sets_resolved())
    cal = eng._calibration()
    for dt in (1 / 60, np.float32(1 / 60)):
        a = b = pipeline.make_init_state(_body_rig(rig), device="cpu")
        for x in blobs:
            a, ra = pipeline.track_from_blobs(a, x[..., :2], x[..., 2] > 0.5,
                                              dt, *cal, **kw)
            b, rb = pipeline.track_from_blobs(
                b, x[..., :2], x[..., 2] > 0.5,
                torch.tensor(np.float32(dt)), *cal, **kw)
            assert _same_bits(pipeline.pack_outputs(ra),
                              pipeline.pack_outputs(rb))
    dts = np.asarray([1 / 60, 1 / 50, 1 / 70], np.float32)
    init = pipeline.make_init_state(_body_rig(rig), device="cpu")
    rows = [pipeline.scan_track_from_blobs(
        init, blobs[..., :2], blobs[..., 2] > 0.5, d, *cal, **kw)[1]
        for d in (dts, torch.from_numpy(dts))]
    assert _same_bits(rows[0], rows[1])


def test_the_step_constants_are_built_once_per_device():
    """The matcher's hypothesis tables, the permutation table, a body
    template's tensors, the preprocessing weight and the filters'
    constants: two calls return the same tensors (an upload per frame is a
    copy a graph cannot hold), the filters' with the values a frame built
    before."""
    dev = torch.device("cpu")
    a = correspond._hypothesis_tables_on(4, 3, dev)
    b = correspond._hypothesis_tables_on(4, 3, dev)
    assert len(a) == 5 and all(x is y for x, y in zip(a, b))
    onehot, _, self_np, rc_oh, rc_of_h = correspond._hypothesis_tables(4, 3)
    assert torch.equal(a[0], torch.from_numpy(onehot))
    assert torch.equal(a[4], torch.from_numpy(
        (3 - rc_of_h).astype(np.float32)))
    assert all(x is y for x, y in zip(assignment._perm_table_on(3, dev),
                                      assignment._perm_table_on(3, dev)))
    tmpl = rigid_general.make_template(TMPL_A)
    assert all(x is y for x, y in zip(rigid_general._template_on(tmpl, dev),
                                      rigid_general._template_on(tmpl, dev)))
    assert (detect._preprocess_weight(9, 0.0, dev)
            is detect._preprocess_weight(9, 0.0, dev))
    f32 = torch.float32
    Q, I9 = kalman._process(dev, f32, 1e-2)
    assert kalman._process(dev, f32, 1e-2)[0] is Q
    assert torch.equal(Q, torch.eye(9) * 1e-2) and torch.equal(I9,
                                                               torch.eye(9))
    I6, H, R = body_tracker._cv_constants(dev, f32, 1e-4)
    assert body_tracker._cv_constants(dev, f32, 1e-4)[1] is H
    assert torch.equal(I6, torch.eye(6))
    assert torch.equal(H, torch.cat([torch.eye(3), torch.zeros(3, 3)], 1))
    assert torch.equal(R, torch.eye(3) * 1e-4)
    assert torch.equal(body_tracker._cv_process(dev, f32, 2.0),
                       torch.eye(6) * 2.0)


# every cache of device tensors that a captured step reads
_KEPT = {"kalman._constants": kalman._constants,
         "kalman._process": kalman._process,
         "body_tracker._cv_constants": body_tracker._cv_constants,
         "body_tracker._cv_process": body_tracker._cv_process,
         "correspond._hypothesis_tables_on":
             correspond._hypothesis_tables_on,
         "assignment._perm_table_on": assignment._perm_table_on,
         "rigid_general._template_on": rigid_general._template_on,
         "detect._preprocess_weight": detect._preprocess_weight}


@pytest.mark.parametrize("name", sorted(_KEPT))
def test_device_constants_are_kept_for_the_life_of_the_process(name):
    """A graph reads a cached constant by address, so no such cache
    evicts an entry (an evicted tensor's memory would be reused)."""
    assert _KEPT[name].cache_info().maxsize is None


def test_compiled_step_donates_its_state_and_refuses_other_buffers():
    def fn(state, x, k):
        return state + x * k, state * 2.0

    st, x, k = torch.zeros(3), torch.zeros(3), torch.zeros(())
    step = compiled.CompiledStep(fn, st, x, k)
    state, out = step(st, torch.ones(3), 2.0)
    assert state is st and torch.equal(st, torch.full((3,), 2.0))
    assert torch.equal(out, torch.zeros(3))
    # another state object is copied into the buffers; arrays and numpy
    # numbers are taken as well
    state, out = step(torch.full((3,), 5.0), np.ones(3, np.float32),
                      np.float32(1.0))
    assert state is st and torch.equal(st, torch.full((3,), 6.0))
    assert torch.equal(out, torch.full((3,), 10.0))
    with pytest.raises(ValueError):
        step(st, torch.ones(4), 1.0)
    with pytest.raises(ValueError):
        step(st, torch.ones(3, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        step(st, 1.0, 1.0)
    with pytest.raises(TypeError):
        step(st, torch.ones(3))
    assert step.graph is None          # the CPU runs the step eagerly


def test_mocap_pipeline_step_donates_its_state_and_returns_fresh_outputs():
    """``MocapPipeline.step`` against ``frame_step``: outputs bitwise
    equal and the caller's own; the state returned is the pipeline's
    buffers, one step per frame shape."""
    Rs, ts, rig, src = _scene()
    pipe = pipeline.MocapPipeline(rig, EngineConfig(), Rs, ts,
                                  preprocess_frames=False, device="cpu")
    st = pipe.init_state()
    st_p = pipeline.make_init_state(rig, device="cpu")
    cal = (pipe.Ps, pipe.K, pipe.dist, pipe.to_world_matrix, pipe.Fs)
    rows = []
    for i in range(6):
        frames = src.read_at(i / 60)
        st, out = pipe.step(st, frames, np.float32(1 / 60))
        st_p, want = pipeline.frame_step(st_p, torch.from_numpy(frames),
                                         np.float32(1 / 60), *cal,
                                         **pipe._kw)
        rows.append(pipeline.pack_outputs(out))
        assert _same_bits(rows[-1], pipeline.pack_outputs(want))
        assert st is pipe._state
    assert len(pipe._steps) == 1
    assert not _same_bits(rows[0], rows[-1])   # outputs are not reused
    assert all(torch.equal(a, b) for a, b in zip(leaves(st), leaves(st_p)))


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS) + ["batched"])
def test_graph_rows_equal_the_eager_step_on_the_card(card, kind):
    """Each kind's CUDA graph against the same step called op by op
    (``CompiledStep.eager``) from the same state: rows bitwise equal over
    20 frames, the graph captured once."""
    Rs, ts, rig, src = _scene()
    B = 4
    cfg = EngineConfig(dispatch_batch=B if kind == "batched" else 1)
    opts = KINDS.get(kind, dict(host_detect=True))
    eng = _engine(rig, cfg, Rs, ts, device=card, **opts)
    ref = _engine(rig, cfg, Rs, ts, device=card, **opts)
    name = "batched" if kind == "batched" else kind
    for i in range(N_FRAMES // (B if kind == "batched" else 1)):
        if kind == "batched":
            payload = np.stack([_payload("blobs", src.read_at(
                (i * B + j) / 60), cfg, rig)[0].numpy() for j in range(B)])
            dt = np.full(B, 1 / 60, np.float32)
        else:
            payload = _payload(kind, src.read_at(i / 60), cfg, rig)[0]
            dt = np.float32(1 / 60)
        _, row = eng._steps[name](eng._kalman_state, payload, dt,
                                  *eng._calibration())
        row = row.cpu()
        step = ref._steps[name]
        if kind == "batched":
            _, (want, _, _) = step.head.eager(
                ref._kalman_state, payload, dt, *ref._calibration())
        else:
            _, want = step.eager(ref._kalman_state, payload, dt,
                                 *ref._calibration())
        assert _same_bits(row, want), f"frame {i}"
    step = eng._steps[name]
    graphs = [step.head] if kind == "batched" else [step]
    assert all(g.graph is not None and g.capture_ms > 0 for g in graphs)


@pytest.mark.cuda
def test_a_step_that_syncs_is_refused_at_capture(card):
    def syncing(state, x):
        return state * float(x.sum()), x

    step = compiled.CompiledStep(syncing, torch.ones(3, device=card),
                                 torch.ones(3, device=card))
    with pytest.raises(RuntimeError):
        step(step.state, torch.ones(3))
    assert step.graph is None
    assert float(torch.ones(4, device=card).sum()) == 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(readback_pipeline_depth=2),
    dict(dispatch_batch=4, batch_emit_thread=True)],
    ids=["depth2", "emit_worker"])
def test_graph_rows_are_read_back_before_the_next_replay(card, extra):
    """The graph's rows are overwritten by the next replay: at readback
    depth 2 and with the emit worker the payloads equal per-frame serving
    at depth 0."""
    Rs, ts, rig, src = _scene()
    frames = [src.read_at(i / 60) for i in range(N_FRAMES)]
    events = []
    for cfg in (EngineConfig(), EngineConfig(**extra)):
        eng = _engine(rig, cfg, Rs, ts, device=card)
        got = _track(eng, Rs, ts)
        for f in frames:
            eng.process_frame(f, 1 / 60)
        eng.flush_batches()
        eng.stop()
        events.append(got)
    assert len(events[0]) == N_FRAMES and events[0] == events[1]


def _rows(eng, frames):
    """Every packed row ``eng`` decodes serving ``frames``, as (n, L)."""
    rows, decode = [], eng._decode

    def capture(rb):
        outs = decode(rb)               # waits for the row's copy
        buf = rb.ring.bufs[rb.slot]
        rows.append(buf.numpy().reshape(-1, buf.shape[-1]).copy())
        return outs

    eng._decode = capture
    for f in frames:
        eng.process_frame(f, 1 / 60)
    eng.flush_batches()
    return torch.from_numpy(np.concatenate(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("cards", [1, 2])
def test_mesh_graphs_equal_the_steps_op_by_op_on_the_card(card, batch,
                                                          cards):
    """Camera-sharded serving at cam = 4 on one card (one graph) and on
    two (a graph a card and the tail's): rows bitwise equal to the same
    engine's steps op by op (``compiled.disable_graphs``) and to the
    single-device device-detect engine's."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards")
    Rs, ts, rig, src = _scene()
    frames = [src.read_at(i / 60) for i in range(2 * N_FRAMES)]
    cfg = EngineConfig(dispatch_batch=batch)
    devs = [torch.device("cuda", k % cards) for k in range(4)]
    rows = []
    for eager in (False, True):
        eng = _engine(rig, cfg, Rs, ts, device=devs[0], fast_path=True,
                      mesh=make_mesh({"cam": 4}, devices=devs))
        _track(eng, Rs, ts)
        if eager:
            with compiled.disable_graphs():
                rows.append(_rows(eng, frames))
            continue
        rows.append(_rows(eng, frames))
        step = eng._steps["batched" if batch > 1 else "mesh"]
        assert all(s.graph is not None
                   for s in getattr(step, "steps", (step,)))
    ref = _engine(rig, EngineConfig(), Rs, ts, device=devs[0],
                  fast_path=True, host_detect=False)
    _track(ref, Rs, ts)
    assert _same_bits(rows[0], rows[1])
    assert _same_bits(rows[0], _rows(ref, frames))


@pytest.mark.cuda
def test_offline_graphs_equal_the_steps_op_by_op_on_the_card(card):
    """``process_recording`` from host blobs with ``smooth`` and from
    packed and sparse frames (chunks of 6 over 2 * N_FRAMES + 3 frame sets,
    the last chunk padded) and ``stream_recording`` (blocks of 8, the last
    partial) against the same calls under ``compiled.disable_graphs``:
    every output bitwise equal, at the first calls (a streamed block is
    lazy: op by op at its first call) and at the second (every step a
    graph); a call at another length captures nothing."""
    from low_cost_mocap_tpu_torch.models import offline
    from low_cost_mocap_tpu_torch.ops import camera

    Rs, ts, rig, src = _scene()
    cfg = EngineConfig()
    T = 2 * N_FRAMES + 3
    frames = np.stack([src.read_at(i / 60) for i in range(T)])
    blobs = offline.detect_recording_host(frames, cfg.detect_threshold,
                                          cfg.max_blobs)
    K = torch.tensor(rig.K_stack(), device=card)
    cal = (camera.projection_matrix(K, torch.tensor(Rs, device=card),
                                    torch.tensor(ts, device=card)),
           K, torch.tensor(rig.dist_stack(), device=card),
           torch.eye(4, device=card))
    dts = np.full((T,), 1 / 60, np.float32)

    packed = np.stack([detect.pack_frames(f, cfg.detect_threshold)
                       for f in frames])
    sparse = np.stack([detect.sparse_ingest(f, cfg.detect_threshold,
                                            cfg.sparse_budget)[0]
                       for f in frames])

    def calls():
        kw = dict(dts=dts, chunk=6)
        return (offline.process_recording(blobs, *cal, rig, cfg,
                                          smooth=True, **kw),
                offline.process_recording(packed, *cal, rig, cfg,
                                          packed=True, **kw),
                offline.process_recording(sparse, *cal, rig, cfg,
                                          sparse=True, **kw),
                offline.stream_recording(frames, *cal, rig, cfg, dts=dts,
                                         block=8)[0])

    first = calls()
    got = calls()
    with compiled.disable_graphs():
        want = calls()
    for out in (first, got):
        for a, b in zip(leaves(out), leaves(want)):
            assert (_same_bits(a, b) if a.dtype == torch.float32
                    else torch.equal(a, b))
    steps = offline.cached_steps()
    assert steps and all(s.graph is not None for s in steps)
    offline.process_recording(tuple(a[:T - 7] for a in blobs), *cal, rig,
                              cfg, dts=dts[:T - 7], chunk=6, smooth=True)
    assert len(offline.cached_steps()) == len(steps)


def _ba_scene(n, device, seed=3):
    """A perturbed 4-camera ring in camera 0's gauge: (points, mask, K,
    Rs, ts) on ``device``."""
    from low_cost_mocap_tpu_torch.ops import rotations

    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    rng = np.random.default_rng(seed)
    pts, mask = syn.observe(syn.random_points(rng, n), Rs, ts, rig,
                            noise_px=0.3, rng=rng)
    Rs = np.einsum("cij,jk->cik", Rs, Rs[0].T).astype(np.float32)
    ts = (ts - np.einsum("cij,j->ci", Rs, ts[0])).astype(np.float32)
    dR = rotations.rotvec_to_matrix(torch.as_tensor(rng.normal(
        scale=0.02, size=(4, 3)).astype(np.float32))).numpy()
    Rs = np.einsum("cij,cjk->cik", dR, Rs).astype(np.float32)
    ts = (ts + rng.normal(scale=0.03, size=ts.shape)).astype(np.float32)
    Rs[0], ts[0] = np.eye(3, dtype=np.float32), 0
    return tuple(torch.as_tensor(a, device=device)
                 for a in (pts, mask, rig.K_stack(), Rs, ts))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["ba", "ba frozen", "dist", "schur",
                                    "dist split", "schur split",
                                    "intrinsics"])
def test_solver_graphs_equal_the_chunks_op_by_op_on_the_card(card, solver):
    """Each LM solver's chunk graph (the first call at a bucket runs its
    first chunk op by op and captures at the second) against the same
    call under ``compiled.disable_graphs``: every output bitwise equal, the
    same iterations, chunks and reads; a call of another size in the same
    bucket captures nothing.  "split": the sharded solvers on a mesh of
    "cuda" and "cuda:0", two devices that are one card, laid out as on
    several cards (a graph per device and phase)."""
    from low_cost_mocap_tpu_torch.ops import ba, intrinsics
    from low_cost_mocap_tpu_torch.parallel.dist_ba import dist_bundle_adjust
    from low_cost_mocap_tpu_torch.parallel.schur_ba import \
        schur_bundle_adjust

    pts, mask, K, Rs, ts = _ba_scene(300, card)
    mesh = make_mesh({"point": 4}, devices=(
        ["cuda", "cuda:0"] * 2 if solver.endswith("split") else [card] * 4))
    if solver.startswith("ba"):
        def call(n, stats):
            return ba.bundle_adjust(
                pts[:n], mask[:n], K, Rs, ts, num_cameras=4, max_iters=20,
                ftol=0.0, freeze_focals=solver == "ba frozen", stats=stats)
    elif solver == "intrinsics":
        board = intrinsics.make_grid(5, 7, 0.04)
        b3 = torch.as_tensor(np.concatenate(
            [board, np.zeros((35, 1), np.float32)], -1), device=card)
        img = torch.stack([camera_project(b3, v, card) for v in range(7)])

        def call(n, stats):          # n views, padded to 8
            return intrinsics.calibrate_intrinsics(
                board, img[:n].cpu().numpy(), device=card)
    else:
        solve = (dist_bundle_adjust if solver.startswith("dist")
                 else schur_bundle_adjust)

        def call(n, stats):
            return solve(mesh, pts[:n], mask[:n], K, Rs, ts, max_iters=20,
                         ftol=0.0, stats=stats)

    n0, n1 = (7, 6) if solver == "intrinsics" else (300, 280)
    got, stats = [], [{}, {}]
    for s in stats:
        got.append(call(n0, s))
    with compiled.disable_graphs():
        want_stats = {}
        want = call(n0, want_stats)
    for g in got:
        for a, b in zip(leaves(tuple(g)), leaves(tuple(want))):
            assert (_same_bits(a, b) if a.dtype == torch.float32
                    else torch.equal(a, b))
    if solver != "intrinsics":
        assert stats[0] == stats[1] == want_stats
        assert want_stats["chunks"] == 3 and want_stats["iterations"] == 20
    before = compiled.captures
    call(n1, {})
    assert compiled.captures == before


def camera_project(board3, view, device):
    """The board seen in one of 7 views through a distorted camera."""
    from low_cost_mocap_tpu_torch.ops import camera, rotations

    rng = np.random.default_rng(view)
    R = rotations.rotvec_to_matrix(torch.as_tensor(np.deg2rad(
        rng.uniform(-30, 30, 3)).astype(np.float32), device=device))
    t = torch.tensor([-0.12, -0.08, rng.uniform(0.55, 0.8)],
                     dtype=torch.float32, device=device)
    K = torch.tensor([[300.0, 0, 162], [0, 295, 158], [0, 0, 1]],
                     device=device)
    d = torch.tensor([0.08, -0.12, 0.001, -0.0005, 0.05], device=device)
    return camera.project_points(board3, R[None], t[None], K[None],
                                 d[None])[0]


@pytest.mark.cuda
def test_time_sharding_and_helper_graphs_equal_op_by_op_on_the_card(card):
    """``process_sequence`` (the detection kernel a shard),
    ``smooth_sharded``, the rts-assoc worker's compiled reference and the
    differential harness's tracking step against the same calls under
    ``compiled.disable_graphs``: bitwise equal."""
    from low_cost_mocap_tpu_torch.config import EngineConfig as Cfg
    from low_cost_mocap_tpu_torch.ops import detect_cuda
    from low_cost_mocap_tpu_torch.parallel import multiprocess, temporal
    from low_cost_mocap_tpu_torch.utils import differential

    Rs, ts, rig, src = _scene()
    cfg = EngineConfig()
    frames = torch.as_tensor(np.stack([src.read_at(i / 60)
                                       for i in range(16)]))
    mesh = make_mesh({"time": 4}, devices=[card] * 4)

    def per_frame(block):
        f = block.to(torch.float32) * (1.0 / 255.0)
        c, v, _ = detect_cuda.find_blobs(f.reshape(-1, *f.shape[2:]),
                                         cfg.detect_threshold, cfg.max_blobs,
                                         cfg.cc_iters)
        return c, v

    rng = np.random.default_rng(1)
    x = torch.as_tensor(np.cumsum(rng.normal(size=(256, 3)).astype(
        np.float32), 0) * 0.01, device=card)
    xs = torch.as_tensor(rng.normal(size=(24, 1, 9)).astype(np.float32),
                         device=card)
    A = rng.normal(size=(24, 1, 9, 9)).astype(np.float32) * 0.1
    Ps = torch.as_tensor(A @ A.transpose(0, 1, 3, 2)
                         + np.eye(9, dtype=np.float32), device=card)
    dts = torch.full((24,), 1 / 60, device=card)
    Rr, tr, rr = differential.reference_rig()
    step = differential.tracking_step(Rr, tr, rr, Cfg(), 8, card)
    blobs = np.random.default_rng(2).uniform(40, 280, (10, 4, 8, 2))

    def calls():
        out = [temporal.process_sequence(mesh, frames, per_frame)
               for _ in range(2)]
        out += [temporal.smooth_sharded(mesh, x, halo=32) for _ in range(2)]
        rts = multiprocess.rts_smooth_assoc_step(xs, Ps, dts)
        out.append(rts((), xs, Ps, dts)[1].clone())
        st = step.state
        compiled.assign(st, kalman.init_state(2, device=card))
        for b in blobs:
            st, o = step(st, b.astype(np.float32), np.ones((4, 8), bool),
                         1 / 60, *step.args[3:])
            out.append(o.tracked.pos.clone())
        return out

    got = calls()
    with compiled.disable_graphs():
        want = calls()
    for a, b in zip(leaves(got), leaves(want)):
        assert (_same_bits(a, b) if a.dtype == torch.float32
                else torch.equal(a, b))
    assert step.graph is not None
