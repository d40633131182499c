"""The copied roofline arithmetic: the counts behind each bound repeat
exactly, and the bound is the larger of operations and bytes over the
H100's peaks."""

import torch

from mocapbench.common import bounds


def test_detect_bound_counts_lit_pixels_and_sweeps():
    frames = torch.zeros(2, 64, 64)
    frames[0, 10, 10:15] = 1.0      # a 5-pixel line: labels settle in 4
    frames[1, 30:32, 30:32] = 1.0   # a 2x2 square: one sweep
    ms, which = bounds.detect_bound(frames, 0.5, 24, 8)
    # bytes: two float32 frames once, 8 slots of outputs a camera
    nbytes = 2 * 64 * 64 * 4 + 2 * 8 * (2 * 4 + 1 + 4)
    ops = (5 * 4 + 4 * 1) * 9
    want = max(ops / bounds.PEAK_OPS_S, nbytes / bounds.PEAK_BYTES_S) * 1e3
    assert which == "bytes"
    assert ms == want
    assert bounds.detect_bound(frames, 0.5, 24, 8) == (ms, which)


def test_bank_bound_counts_updates():
    valid = torch.tensor([[True, True, False, False]])
    index = torch.tensor([[0, 1, -1, -1]], dtype=torch.int32)
    ms, which = bounds.bank_bound(valid, index, 1, 4, 2)
    ops = 2 * 1900 + 1 * 2 * 4 * 8
    nbytes = (1 * 4 * (3 * 4 + 4 + 4 + 1) + 1 * 4 + 2 * 6 * 4
              + 2 * 2 * (9 + 81 + 1 + 3 + 5 + 15 + 1) * 4
              + 1 * 2 * (3 + 3 + 1) * 4 + 1 * 2)
    assert which == "bytes"
    assert ms == max(ops / bounds.PEAK_OPS_S,
                     nbytes / bounds.PEAK_BYTES_S) * 1e3
    none = bounds.bank_bound(valid & False, index, 1, 4, 2)[0]
    assert none <= ms
