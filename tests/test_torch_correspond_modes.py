"""PyTorch port: the matcher's large-rig modes (``mode="assoc"``,
``mode="beam"``, ``"auto"`` above five cameras) and the ``beam_width`` /
``miss_penalty_px`` keywords against the JAX package
(``ops/correspond.py``), on the scenes of ``tests/test_correspond.py`` and
``tests/test_correspond_beam.py``: the 4-camera ring and the 16-camera
ring.

Validity and the observation masks are exactly equal; points and
observations within 1e-5.  Errors (mean squared pixels) agree within 1e-4
relative: after assoc's two re-triangulations the points differ by ~1e-7 m
(float32, another summation order), which moves a 1 px residual's square
by ~3e-5 px^2.  Both packages get the JAX package's fundamental matrices.
The JAX beam runs op by op and compiles every op anew for each shape, so
the beam cases keep the default width; the 16-camera beam is in
``tests/test_torch_correspond_beam16.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from low_cost_mocap_tpu.ops import camera as jcam
from low_cost_mocap_tpu.ops import correspond as jc
from low_cost_mocap_tpu.utils import synthetic as jsyn
from low_cost_mocap_tpu_torch.ops import correspond as tc

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _scene(n_cams, n_pts, seed, noise, K=8, drop=()):
    """Detector-style slots of a random scene (``_to_slots`` of
    tests/test_correspond.py); ``drop``: (point, camera) pairs hidden."""
    Rs, ts, rig = jsyn.ring_rig(num_cameras=n_cams)
    rng = np.random.default_rng(seed)
    X = jsyn.random_points(rng, n_pts)
    pts, mask = jsyn.observe(X, Rs, ts, rig, noise_px=noise,
                             rng=rng if noise else None)
    mask = mask.copy()
    for p, c in drop:
        mask[p, c] = False
    Ps = np.asarray(jcam.projection_matrix(
        jnp.asarray(rig.K_stack()), jnp.asarray(Rs), jnp.asarray(ts)))
    slots = np.zeros((n_cams, K, 2), np.float32)
    ok = np.zeros((n_cams, K), bool)
    for c in range(n_cams):
        vis = np.where(mask[:, c])[0]
        slots[c, :len(vis)] = pts[vis, c]
        ok[c, :len(vis)] = True
    Fs = np.asarray(jc._pairwise_fundamentals(jnp.asarray(Ps)))
    return X, slots, ok, Ps, Fs


def _both(scene, **kw):
    _, slots, ok, Ps, Fs = scene
    j = jc.match_points(jnp.asarray(slots), jnp.asarray(ok), jnp.asarray(Ps),
                        Fs=jnp.asarray(Fs), **kw)
    t = tc.match_points(torch.tensor(slots), torch.tensor(ok),
                        torch.tensor(Ps), Fs=torch.tensor(Fs), **kw)
    return {k: np.asarray(v) for k, v in j.items()}, \
        {k: v.numpy() for k, v in t.items()}


def _assert_same(j, t, keys=None):
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_allclose(t["object_points"], j["object_points"], **TOL)
    fin = np.isfinite(j["errors"])
    np.testing.assert_array_equal(np.isfinite(t["errors"]), fin)
    np.testing.assert_allclose(t["errors"][fin], j["errors"][fin],
                               atol=1e-5, rtol=1e-4)
    if "obs" in j and (keys is None or "obs" in keys):
        np.testing.assert_array_equal(t["obs_mask"], j["obs_mask"])
        np.testing.assert_allclose(t["obs"], j["obs"], **TOL)


SMALL = {"noisy": dict(n_cams=4, n_pts=4, seed=11, noise=0.5),
         "root0_missing": dict(n_cams=4, n_pts=3, seed=0, noise=0.3,
                               drop=((0, 0),)),
         "crowded": dict(n_cams=4, n_pts=6, seed=3, noise=1.0)}


@pytest.fixture(scope="module", params=sorted(SMALL))
def small(request):
    return _scene(**SMALL[request.param])


@pytest.mark.parametrize("with_obs", [False, True])
def test_assoc_matches_jax_on_four_cameras(small, with_obs):
    j, t = _both(small, mode="assoc", with_obs=with_obs)
    _assert_same(j, t)
    assert t["valid"].sum() >= 3


@pytest.mark.parametrize("kw", [dict(with_obs=False), dict(with_obs=True),
                                dict(with_obs=True, miss_penalty_px=0.0)])
def test_beam_matches_jax_on_four_cameras(kw):
    scene = _scene(**SMALL["noisy"])
    j, t = _both(scene, mode="beam", **kw)
    _assert_same(j, t)
    assert t["valid"].sum() == 4


def test_exact_mode_keywords_match_jax(small):
    """``miss_penalty_px=0`` (the reference's selection rule), another
    penalty, and a ``beam_width`` (which exact mode ignores) against JAX."""
    for kw in (dict(miss_penalty_px=0.0), dict(miss_penalty_px=2.5),
               dict(beam_width=4)):
        j, t = _both(small, mode="exact", with_obs=True, **kw)
        _assert_same(j, t)


def test_full_width_beam_selects_as_exact(small):
    """A beam as wide as every hypothesis (3^3 at four cameras) prunes
    nothing, so it picks exact mode's winners (without exact mode's
    camera-0 re-selection and dedupe); a narrower beam still finds the
    scene's points."""
    _, slots, ok, Ps, Fs = small
    args = (torch.tensor(slots), torch.tensor(ok), torch.tensor(Ps))
    kw = dict(Fs=torch.tensor(Fs), with_obs=True, dedupe_eps=0.0)
    ex = tc.match_points(*args, mode="exact", **kw)
    bm = tc.match_points(*args, mode="beam", beam_width=27, **kw)
    for k in ex:
        assert torch.equal(ex[k], bm[k]), k
    narrow = tc.match_points(*args, mode="beam", beam_width=2, Fs=kw["Fs"])
    got = narrow["object_points"][narrow["valid"]].numpy()
    for x in small[0]:
        assert np.linalg.norm(got - x, axis=1).min() < 0.05


def test_assoc_needs_a_second_view_to_seed():
    """tests/test_correspond.py:110: blobs in one camera only give no
    point (no same-camera seed)."""
    X, slots, ok, Ps, Fs = _scene(4, 3, 0, 0.0)
    only0 = np.zeros_like(ok)
    only0[0] = ok[0]
    j, t = _both((X, slots, only0, Ps, Fs), mode="assoc", with_obs=True)
    _assert_same(j, t)
    assert not t["valid"].any()


def test_beam_with_many_infinite_ties_matches_jax():
    """Most cameras see nothing and one blob is duplicated, so nearly every
    partial assembly is dead (+inf) or tied: the survivors' order (a
    stable ascending sort, as top_k's) decides which copy each winner
    carries."""
    X, slots, ok, Ps, Fs = _scene(4, 3, 5, 0.3)
    ok = ok.copy()
    ok[2] = False
    slots[3, 3], ok[3, 3] = slots[3, 0], True          # a duplicate blob
    for kw in (dict(), dict(miss_penalty_px=0.0)):
        j, t = _both((X, slots, ok, Ps, Fs), mode="beam", with_obs=True,
                     **kw)
        _assert_same(j, t)


@pytest.fixture(scope="module")
def sixteen():
    return _scene(16, 5, 12, 0.5)


@pytest.mark.parametrize("with_obs", [False, True])
@pytest.mark.parametrize("mode", ["assoc", "auto"])
def test_assoc_on_sixteen_cameras_matches_jax(sixteen, mode, with_obs):
    """Auto mode above five cameras is assoc, in both packages."""
    j, t = _both(sixteen, mode=mode, with_obs=with_obs)
    _assert_same(j, t)
    got = t["object_points"][t["valid"]]
    for x in sixteen[0]:
        assert np.linalg.norm(got - x, axis=1).min() < 0.02


def test_assoc_batched_equals_per_frame(sixteen):
    """The port's batch axis: two frame sets in one call give each one's
    single-frame result bitwise."""
    _, slots, ok, Ps, Fs = sixteen
    other = _scene(16, 8, 2, 0.3)
    pts = torch.tensor(np.stack([slots, other[1]]))
    val = torch.tensor(np.stack([ok, other[2]]))
    kw = dict(Fs=torch.tensor(Fs), mode="assoc", with_obs=True)
    both = tc.match_points(pts, val, torch.tensor(Ps), **kw)
    for i in range(2):
        one = tc.match_points(pts[i], val[i], torch.tensor(Ps), **kw)
        for k in one:
            assert torch.equal(both[k][i], one[k]), k


def test_unknown_mode_raises():
    _, slots, ok, Ps, _ = _scene(4, 2, 1, 0.0)
    with pytest.raises(ValueError, match="mode"):
        tc.match_points(torch.tensor(slots), torch.tensor(ok),
                        torch.tensor(Ps), mode="greedy")
