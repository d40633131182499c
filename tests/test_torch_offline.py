"""PyTorch port: offline recording processing (``models/offline.py``)
against the JAX package on the short recordings of
``tests/test_offline_stream.py``: the drone orbit on the 4-camera ring and
the asymmetric 4-marker body.

Discrete outputs (point and object validity, tracked validity, body
validity) are exactly equal; positions within 1e-5 (the one-shot JAX run
is jitted, so its Kalman chain fuses multiply-adds: ROADMAP.md §3);
quaternions within 1e-4, as the JAX test holds its own two paths.
Inside the port, the streamed results are bitwise equal to the one-shot
results on the same host-detected blobs, and packed and sparse frames
give the dense frames' results bitwise.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from low_cost_mocap_tpu.config import EngineConfig as JEngineConfig
from low_cost_mocap_tpu.models import offline as joff
from low_cost_mocap_tpu.ops import camera as jcam
from low_cost_mocap_tpu.ops.rigid_general import make_template as jmake
from low_cost_mocap_tpu_torch.config import EngineConfig
from low_cost_mocap_tpu_torch.models import offline
from low_cost_mocap_tpu_torch.ops import camera, detect
from low_cost_mocap_tpu_torch.ops.rigid_general import make_template
from low_cost_mocap_tpu_torch.utils import metrics
from low_cost_mocap_tpu_torch.utils import synthetic as syn
from low_cost_mocap_tpu_torch.utils import tree

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
T = 40
BODY = np.array([[0.0, 0.0, 0.0], [0.12, 0.0, 0.0], [0.0, 0.09, 0.0],
                 [0.05, 0.03, 0.06]], np.float32)


def _orbit(t):
    return np.array([0.3 * np.cos(t / 40), 0.3 * np.sin(t / 40), 0.6],
                    np.float32)


@pytest.fixture(scope="module")
def rec():
    """The drone orbit (T frame sets) and the body scene, rendered, with
    both packages' calibrations."""
    Rs, ts, rig = syn.ring_rig(num_cameras=4)
    drone, body = [], []
    for t in range(T):
        pts, mask = syn.observe(syn.drone_markers(_orbit(t), 0.0, rig), Rs,
                                ts, rig)
        drone.append(syn.render_frames(pts, mask, rig.image_size, sigma=0.8))
        c, s = np.cos(0.08 * t), np.sin(0.08 * t)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        pts, mask = syn.observe(BODY @ Rz.T + _orbit(t), Rs, ts, rig)
        body.append(syn.render_frames(pts, mask, rig.image_size, sigma=0.8))
    to_u8 = lambda f: (np.stack(f) * 255).astype(np.uint8)
    K = torch.tensor(rig.K_stack())
    dist = torch.tensor(rig.dist_stack())
    Ps = camera.projection_matrix(K, torch.tensor(Rs), torch.tensor(ts))
    jcal = (jnp.asarray(Ps.numpy()), jnp.asarray(rig.K_stack()),
            jnp.asarray(rig.dist_stack()), jnp.eye(4))
    A = np.array([[-1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    return dict(drone=to_u8(drone), body=to_u8(body), rig=rig,
                cfg=EngineConfig(), jcfg=JEngineConfig(),
                cal=(Ps, K, dist, torch.eye(4)), jcal=jcal,
                dts=np.full((T,), 1 / 60, np.float32),
                tmpl=make_template(BODY @ A.T), jtmpl=jmake(BODY @ A.T))


@pytest.fixture(scope="module")
def blobs(rec):
    b, v = offline.detect_recording_host(rec["drone"], 0.2, 8)
    jb, jv = joff.detect_recording_host(rec["drone"], 0.2, 8)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(v, jv)
    return b, v


def _close(got, want, what):
    for name, g, w in zip(want._fields, got, want):
        if g is None:
            assert w is None, (what, name)
            continue
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")
        else:
            tol = dict(atol=1e-4) if name == "quat" else TOL
            np.testing.assert_allclose(g, w, err_msg=f"{what}.{name}", **tol)


def _check(got, want, fields=("object_points", "point_valid",
                              "objects_pos", "objects_valid")):
    for f in fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, err_msg=f, **TOL)
    _close(got.tracked, want.tracked, "tracked")


def _equal(a, b):
    """Every tensor leaf of two results bitwise equal."""
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        for x, y in zip(a, b):
            _equal(x, y)


def test_process_recording_from_blobs_matches_jax_and_smooths(rec, blobs):
    """Host-detected blobs, with ``smooth=True``: the causal tracks and the
    RTS-smoothed ones against JAX; the smoothed ATE (``utils/metrics``)
    below the causal one."""
    b, v = blobs
    want = joff.process_recording(
        (jnp.asarray(b), jnp.asarray(v)), *rec["jcal"], rec["rig"],
        rec["jcfg"], dts=jnp.asarray(rec["dts"]), smooth=True)
    got = offline.process_recording(
        (b, v), *rec["cal"], rec["rig"], rec["cfg"], dts=rec["dts"],
        chunk=16, smooth=True)
    _check(got, want)
    np.testing.assert_array_equal(got.smoothed.valid.numpy(),
                                  np.asarray(want.smoothed.valid))
    np.testing.assert_allclose(got.smoothed.pos.numpy(),
                               np.asarray(want.smoothed.pos), atol=1e-4)
    tv = got.smoothed.valid.numpy()
    d = int(np.argmax(tv.sum(0)))
    from low_cost_mocap_tpu_torch.ops import world
    rig = rec["rig"]
    centres = np.stack([world.to_world(torch.tensor(
        syn.drone_markers(_orbit(t), 0.0, rig)[:2].mean(0)), torch.eye(4))
        .numpy() for t in range(T)])
    keep = tv[10:, d] & got.tracked.valid.numpy()[10:, d]
    e_sm = metrics.ate(got.smoothed.pos.numpy()[10:, d], centres[10:], keep)
    e_ft = metrics.ate(got.tracked.pos.numpy()[10:, d], centres[10:], keep)
    assert e_sm["mean"] < e_ft["mean"], (e_sm, e_ft)


def test_process_recording_from_frames_matches_jax(rec, blobs):
    """Dense frames through the detector (its plain version on the CPU)
    against JAX; packed and sparse frames give the same results bitwise,
    and so do the host-detected blobs (host and device detection agree)."""
    frames = rec["drone"][:24]
    want = joff.process_recording(jnp.asarray(frames), *rec["jcal"],
                                  rec["rig"], rec["jcfg"],
                                  dts=jnp.asarray(rec["dts"][:24]), chunk=8)
    kw = dict(dts=rec["dts"][:24], chunk=8)
    got = offline.process_recording(frames, *rec["cal"], rec["rig"],
                                    rec["cfg"], **kw)
    _check(got, want)
    packed = np.stack([detect.pack_frames(f, 0.2) for f in frames])
    sparse = np.stack([detect.sparse_ingest(f, 0.2, 4096)[0]
                       for f in frames])
    b, v = blobs
    for other in (offline.process_recording(packed, *rec["cal"], rec["rig"],
                                            rec["cfg"], packed=True, **kw),
                  offline.process_recording(sparse, *rec["cal"], rec["rig"],
                                            rec["cfg"], sparse=True, **kw),
                  offline.process_recording((b[:24], v[:24]), *rec["cal"],
                                            rec["rig"], rec["cfg"], **kw)):
        _equal(other, got)


def test_stream_recording_matches_jax_and_oneshot(rec, blobs):
    """A partial final block (30 = 16 + 14), then the state carried into a
    second call: against JAX's streamed run, and bitwise equal to the
    port's one-shot run on the same host-detected blobs; the dead padded
    frames leave the state as a contiguous run leaves it."""
    frames, dts, rig, cfg = rec["drone"], rec["dts"], rec["rig"], rec["cfg"]
    got, st = offline.stream_recording(frames[:30], *rec["cal"], rig, cfg,
                                       dts=dts[:30], block=16)
    want, _ = joff.stream_recording(frames[:30], *rec["jcal"], rig,
                                    rec["jcfg"], dts=dts[:30], block=16)
    _check(got, want)
    b, v = blobs
    _equal(got, offline.process_recording((b[:30], v[:30]), *rec["cal"],
                                          rig, cfg, dts=dts[:30], chunk=32))
    rest, _ = offline.stream_recording(frames[30:], *rec["cal"], rig, cfg,
                                       dts=dts[30:], block=16, state=st)
    one, _ = offline.stream_recording(frames, *rec["cal"], rig, cfg,
                                      dts=dts, block=16)
    _equal(tree.cat([got, rest]), one)


def test_body_sets_match_jax_streamed_and_smoothed(rec):
    """The body recording with one template set: one-shot with ``smooth``
    against JAX (fits, tracks, smoothed tracks), and the streamed run with
    the body-tracker state carried across blocks bitwise equal to it."""
    frames, dts, rig, cfg = rec["body"], rec["dts"], rec["rig"], rec["cfg"]
    b, v = offline.detect_recording_host(frames, 0.2, 8)
    want = joff.process_recording(
        (jnp.asarray(b), jnp.asarray(v)), *rec["jcal"], rig, rec["jcfg"],
        dts=jnp.asarray(dts), body_sets=((rec["jtmpl"], 2),), smooth=True)
    got = offline.process_recording((b, v), *rec["cal"], rig, cfg, dts=dts,
                                    body_sets=((rec["tmpl"], 2),),
                                    smooth=True)
    assert bool(got.bodies.valid.any()), "no body found"
    _check(got, want)
    _close(got.bodies, want.bodies, "bodies")
    _close(got.body_tracks, want.body_tracks, "body_tracks")
    _close(got.smoothed_bodies, want.smoothed_bodies, "smoothed_bodies")
    streamed, state = offline.stream_recording(
        frames, *rec["cal"], rig, cfg, dts=dts, block=16,
        body_sets=((rec["tmpl"], 2),))
    assert isinstance(state, tuple) and len(state[1]) == 1
    _equal(streamed, got._replace(smoothed=None, smoothed_bodies=None))
