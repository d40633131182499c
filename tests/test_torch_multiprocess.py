"""PyTorch port: the distributed solvers across real process boundaries.

``parallel.multiprocess.run_cluster`` spawns gloo ranks on the CPU, each
owning 2 shards of one global mesh axis (4 in all), as the JAX package's
``tests/test_multiprocess.py`` runs 2 processes x 2 devices.  Every rank
must report the same result bit for bit; the result must match a
one-process run by the JAX test's criteria, and equal bit for bit one
process holding the same 4 shards, since partial results are reduced in
global shard order.  Each cluster takes a few seconds.
"""

import numpy as np
import pytest

from low_cost_mocap_tpu_torch.parallel.multiprocess import run_cluster

CPU = dict(device="cpu", backend="gloo", timeout_s=120)
SCENE = dict(n_points=256, n_cams=4, max_iters=6)


@pytest.mark.parametrize("solver", ["schur", "reference"])
def test_two_process_ba_matches_one_process(solver):
    ref = run_cluster(1, 1, solver=solver, **SCENE, **CPU)[0]
    four = run_cluster(1, 4, solver=solver, **SCENE, **CPU)[0]
    dist = run_cluster(2, 2, solver=solver, **SCENE, **CPU)

    # every process reports the same solution, which is the one-process
    # solution over the same four shards
    assert dist[0]["global_devices"] == four["global_devices"] == 4
    assert dist[0]["local_devices"] == 2
    for key in ("cost", "ts"):
        assert dist[0][key] == dist[1][key] == four[key], key

    # and it agrees with the one-shard solve (camera 0 fixed leaves the
    # scale free: compare after scale alignment)
    t_ref = np.asarray(ref["ts"])
    t_d = np.asarray(dist[0]["ts"])
    s = float((t_d * t_ref).sum() / max((t_d * t_d).sum(), 1e-12))
    assert np.abs(s * t_d - t_ref).max() < 1e-3
    assert abs(dist[0]["cost"] - ref["cost"]) / ref["cost"] < 1e-4


def test_a_failing_worker_reports_its_error():
    with pytest.raises(RuntimeError, match="worker 0 exited"):
        # 3 cameras do not split over 4 shards
        run_cluster(2, 2, solver="live-pipeline", n_cams=3, **CPU)
    with pytest.raises(ValueError, match="solver"):
        run_cluster(1, solver="bogus", **CPU)
