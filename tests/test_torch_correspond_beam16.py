"""PyTorch port: the matcher's beam mode on the 16-camera ring of
``tests/test_correspond_beam.py`` against the JAX package, with the
observations, and the port's run without them held to the same outputs.

A file of its own: the JAX beam runs op by op, 120 (root camera, later
camera) steps at 16 cameras, about 35-45 s.  Tolerances as in
``tests/test_torch_correspond_modes.py``.
"""

import numpy as np
import torch

from low_cost_mocap_tpu_torch.ops import correspond as tc
from tests.test_torch_correspond_modes import _assert_same, _both, _scene

torch.set_num_threads(1)


def test_beam_on_sixteen_cameras_matches_jax():
    sixteen = _scene(16, 5, 12, 0.5)
    j, t = _both(sixteen, mode="beam", with_obs=True)
    _assert_same(j, t)
    _, slots, ok, Ps, Fs = sixteen
    t2 = tc.match_points(torch.tensor(slots), torch.tensor(ok),
                         torch.tensor(Ps), Fs=torch.tensor(Fs), mode="beam")
    _assert_same(j, {k: v.numpy() for k, v in t2.items()}, keys=())
    got = t2["object_points"][t2["valid"]].numpy()
    for x in sixteen[0]:
        assert np.linalg.norm(got - x, axis=1).min() < 0.02
