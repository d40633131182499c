"""The least time the two hand-written kernels could take on one H100.

Copied from the program's chip smoke test (``detect_bound``,
``bank_bound``) with its arithmetic unchanged, so that a roofline share
does not move when the program does.  ``_min_label_step`` is a frozen copy
of the detector's 3x3 min-label sweep.

Peaks (NVIDIA's H100 SXM data sheet, at the full 700 W): device memory
3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, used for both
kernels' scalar work (float32 in the bank, int32 min/select in detection).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def _min_label_step(labels, big: int):
    """min over the 8-neighbourhood + self, out-of-frame pixels = big."""
    p = F.pad(labels, (1, 1, 1, 1), value=big)
    vert = torch.minimum(torch.minimum(p[..., 2:, 1:-1], p[..., :-2, 1:-1]),
                         p[..., 1:-1, 1:-1])
    vp = F.pad(vert, (1, 1), value=big)
    return torch.minimum(torch.minimum(vp[..., 2:], vp[..., :-2]), vert)


def detect_bound(frames, threshold: float, cc_iters: int, max_blobs: int):
    """Least time (ms) of one ``detect_blobs`` launch over (C, H, W)
    frames: each lit pixel takes a 9-way min and a select for every sweep
    that still changes some label of its camera (the kernel skips dark
    tiles and stops at the fixed point), against reading the float32
    frames the program hands the kernel once and writing the outputs.
    Returns (ms, "operations" or "bytes")."""
    C, H, W = frames.shape
    mask = frames > threshold
    big = H * W
    idx = torch.arange(big, dtype=torch.int32, device=frames.device)
    big_t = torch.tensor(big, dtype=torch.int32, device=frames.device)
    labels = torch.where(mask, idx.reshape(H, W), big_t)
    sweeps = torch.zeros(C, dtype=torch.int64, device=frames.device)
    for _ in range(cc_iters):
        nxt = torch.where(mask, _min_label_step(labels, big), big_t)
        sweeps += (nxt != labels).flatten(1).any(1)
        labels = nxt
    lit = mask.flatten(1).sum(1)
    ops = int((lit * sweeps).sum()) * 9
    nbytes = C * H * W * 4 + C * max_blobs * (2 * 4 + 1 + 4)
    t_ops, t_bytes = ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bank_bound(case_valid, case_index, B: int, M: int, O: int):
    """Least time (ms) of B bank steps over M candidates and O objects:
    each object-step with a detection does ~1,900 float32 operations
    (predict 0.4k, six scalar updates 1.1k, filters, velocity), plus 8 per
    (object, candidate) for the association; bytes are the candidates,
    dts, state in/out and outputs once.  ``case_valid``/``case_index``:
    (B, M) tensors or arrays.  Returns (ms, "operations" or "bytes")."""
    case_valid = torch.as_tensor(case_valid)
    case_index = torch.as_tensor(case_index)
    ids = torch.arange(O, device=case_index.device)
    mine = case_valid[:, None, :] & (case_index[:, None, :] == ids[:, None])
    n_upd = int(mine.any(-1).sum())
    ops = n_upd * 1900 + B * O * M * 8
    nbytes = (B * M * (3 * 4 + 4 + 4 + 1) + B * 4 + 2 * 6 * 4
              + 2 * O * (9 + 81 + 1 + 3 + 5 + 15 + 1) * 4
              + B * O * (3 + 3 + 1) * 4 + B * O)
    t_ops, t_bytes = ops / PEAK_OPS_S, nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
