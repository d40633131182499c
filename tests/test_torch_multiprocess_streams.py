"""PyTorch port: the sharded live step, batched serving step and time
smoothers across real process boundaries.

``parallel.multiprocess.run_cluster`` spawns gloo ranks on the CPU, each
owning 2 shards of one global mesh axis (4 in all), as the JAX package's
``tests/test_multiprocess.py`` runs 2 processes x 2 devices.  Every rank
must report the same result bit for bit, and match a one-process run by
the JAX test's criteria.  Each cluster takes a few seconds.
"""

import numpy as np
import pytest

from low_cost_mocap_tpu_torch.parallel.multiprocess import run_cluster

CPU = dict(device="cpu", backend="gloo", timeout_s=120)


def test_two_process_camera_sharded_live_step():
    """Each rank detects its cameras, the blobs cross in one all_gather,
    and every rank reports the same tracked pose as one process."""
    ref = run_cluster(1, 1, solver="live-pipeline", **CPU)[0]
    dist = run_cluster(2, 2, solver="live-pipeline", **CPU)

    assert dist[0]["global_devices"] == 4
    assert dist[0]["rows_sha"] == dist[1]["rows_sha"] == ref["rows_sha"]
    assert dist[0]["tracked_pos"] == dist[1]["tracked_pos"]
    assert np.asarray(ref["tracked_valid"]).any()
    assert dist[0]["tracked_valid"] == ref["tracked_valid"]
    assert dist[0]["n_points"] == ref["n_points"]


def test_two_process_batched_sharded_serving_step():
    """dist_scan_frame_step over 8 frames: the packed rows are equal on
    every rank and to one process's."""
    ref = run_cluster(1, 1, solver="batched-sharded", **CPU)[0]
    dist = run_cluster(2, 2, solver="batched-sharded", **CPU)

    assert dist[0]["global_devices"] == 4
    assert dist[0]["rows_sha"] == dist[1]["rows_sha"] == ref["rows_sha"]
    assert dist[0]["frames_tracked"] >= 7
    assert dist[0]["tracked_valid"] == ref["tracked_valid"]


def test_two_process_time_sharded_rts_smoother():
    """The RTS smoother's associative scan with the sequence sharded over
    a 2-process time mesh: every rank reproduces the one-process track
    and the unsharded ``rts_smooth_assoc``."""
    ref = run_cluster(1, 1, solver="rts-assoc", **CPU)[0]
    dist = run_cluster(2, 2, solver="rts-assoc", **CPU)

    assert dist[0]["global_devices"] == 4
    a = np.asarray(dist[0]["smoothed"])
    b = np.asarray(dist[1]["smoothed"])
    np.testing.assert_array_equal(a, b)          # equal across ranks
    assert np.abs(a - np.asarray(ref["smoothed"])).max() < 1e-4
    assert dist[0]["vs_unsharded"] < 1e-4 and ref["vs_unsharded"] < 1e-4
    assert dist[0]["rmse_vs_truth_mm"] < 5.0     # and it smooths


def test_two_process_halo_exchange_smoother():
    """smooth_sharded with the halos sent between processes matches the
    sequential smoother away from the edges, equal on both ranks."""
    dist = run_cluster(2, 2, solver="smooth", **CPU)
    a = np.asarray(dist[0]["smoothed"])
    np.testing.assert_array_equal(a, np.asarray(dist[1]["smoothed"]))
    assert np.abs(a - np.asarray(dist[0]["reference"]))[40:-40].max() < 1e-4
