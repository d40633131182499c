"""The benchmark's scene: the same seed gives the same frames, any whole
seed works, and the patch renderer draws what the program's synthetic
renderer draws."""

import numpy as np
import pytest

from mocapbench.common import scene
from low_cost_mocap_tpu_torch.utils import synthetic as syn


@pytest.fixture
def rig():
    Rs, ts, rig = syn.ring_rig(4)
    return Rs, ts, rig


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -5, 2**70])
def test_seed_repeats(rig, seed):
    Rs, ts, r = rig
    a = scene.render(scene.Orbit(seed, 2), scene.loop_times(150, 6), Rs, ts,
                     r.K_stack(), (320, 320))
    b = scene.render(scene.Orbit(seed, 2), scene.loop_times(150, 6), Rs, ts,
                     r.K_stack(), (320, 320))
    assert np.array_equal(a, b) and a.any()


def test_seed_draws_the_orbit():
    """The seed draws the radius, height, headings and phase inside their
    ranges; two seeds give other orbits; the headings stay a half-turn
    apart."""
    a, b = scene.Orbit(1, 2), scene.Orbit(2, 2)
    for o in (a, b):
        assert scene.Orbit.RADIUS[0] <= o.radius <= scene.Orbit.RADIUS[1]
        assert scene.Orbit.HEIGHT[0] <= o.height <= scene.Orbit.HEIGHT[1]
        assert scene.Orbit.HEADING[0] <= o.headings[0] <= scene.Orbit.HEADING[1]
        assert np.isclose(o.headings[1] - o.headings[0], np.pi)
    assert (a.radius, a.height, a.headings[0], a.phase0) != (
        b.radius, b.height, b.headings[0], b.phase0)
    assert not np.allclose(a.markers(0.0), b.markers(0.0))
    # the orbit repeats after the scene's loop
    assert np.allclose(a.markers(0.3), a.markers(0.3 + scene.LOOP_S),
                       atol=1e-5)


def test_matches_the_programs_renderer(rig):
    Rs, ts, r = rig
    o = scene.Orbit(99, 2)
    times = scene.loop_times(150, 5)
    got = scene.render(o, times, Rs, ts, r.K_stack(), (320, 320))
    for k, t in enumerate(times):
        pts, mask = syn.observe(o.markers(t), Rs, ts, r)
        want = (np.clip(syn.render_frames(pts, mask, 320, sigma=0.8), 0, 1)
                * 255).astype(np.uint8)
        assert np.array_equal(got[k], want)


def test_ring_poses_match(rig):
    Rs, ts, _ = rig
    R2, t2 = scene.ring_poses(4, 2.5, 1.8, (0.0, 0.0, 0.5))
    assert np.array_equal(Rs, R2) and np.array_equal(ts, t2)


def test_loop_wraps():
    assert scene.wrap(10_000, 300) == 2400
    assert scene.wrap(50, 300) == 50
