"""The Kalman bank over a batch of frames through the ``kalman_bank`` kernel.

Replaces ``low_cost_mocap_tpu/ops/kalman_pallas.py:kalman_scan``.  One
kernel launch runs B sequential bank updates (``csrc/kalman_bank.cu``: one
warp per object, the B loop inside, the step's candidates staged in shared
memory one step ahead) with the serving options; it agrees bitwise with B
chained ``kalman.update`` steps, which are its plain version.  Per-frame
tracking calls it with B = 1, so per-frame and batched serving share one
bank.

``forward_scan`` runs the RTS smoother's forward filter (``update`` with
``advance_on_miss``, ``return_cov`` and ``report="post"``) over a whole
recording in one launch of the kernel's other instantiation; its plain
version is ``kalman.forward_filter``.  ``backward_scan`` runs the
smoother's backward pass in two launches of the file's other kernels: the
gains of every step at once, then one sweep a recording (a warp an
object); its plain version is ``kalman.rts_smooth``.

Each takes the plain version for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  They convert nothing: inputs of another
dtype or layout are refused.  ``launches`` counts the launches of all the
file's kernels, ``forward_launches`` those of the forward filter and
``backward_launches`` those of the backward pass.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from low_cost_mocap_tpu_torch.ops import kalman, lowpass, native
from low_cost_mocap_tpu_torch.ops.kalman import KalmanState, TrackedObjects
from low_cost_mocap_tpu_torch.utils import tree

NAME = "kalman_bank"
launches = 0
forward_launches = 0
backward_launches = 0

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# dtypes of cand_pos, heading, index, valid, dts, then the KalmanState leaves
_DTYPES = (_F32, _F32, _I32, _BOOL, _F32,
           _F32, _F32, _BOOL, _F32, _F32, _F32, _F32)
# float32 state leaves after the per-step outputs: x, P, prev, lh, lv, age
_STATE_FLOATS = (9, 81, 3, 5, 15, 1)


def _lib():
    lib = native.load(NAME)
    if not getattr(lib, "_lcm_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lcm_kalman_bank.argtypes = [P] * 14 + [I, I, I, Fl, Fl, Fl, I, P]
        lib.lcm_kalman_bank.restype = I
        lib.lcm_kalman_forward.argtypes = [P] * 14 + [I, I, I, Fl, Fl, Fl, P]
        lib.lcm_kalman_forward.restype = I
        lib.lcm_kalman_rts.argtypes = [P] * 5 + [I, I, Fl, P]
        lib.lcm_kalman_rts.restype = I
        lib._lcm_typed = True
    return lib


@functools.lru_cache(maxsize=1)
def _butter_host():
    """The (2, 6) float32 Butterworth b; a in host memory, built once; the
    launch passes them by value."""
    b, a = lowpass.butter_coeffs()
    return (ctypes.c_float * 12)(*b.tolist(), *a.tolist())


def _check(what: str, ins) -> None:
    """Refuse inputs the kernel does not take: ``ins`` are the five
    candidate sequences and the state's leaves, all on one device, in the
    shapes that cand_pos_seq (B, M, 3) and the state's x (O, 9) give, each
    a contiguous tensor of its dtype."""
    dev = ins[0].device
    B, M, _ = ins[0].shape
    O = ins[5].shape[0]
    shapes = ((B, M, 3), (B, M), (B, M), (B, M), (B,), (O, 9), (O, 9, 9),
              (O,), (O, 3), (O, 5), (O, 3, 5), (O,))
    for t, shape, dtype in zip(ins, shapes, _DTYPES):
        if t.device != dev:
            raise ValueError(f"{what}: all tensors must be on one device")
        if t.shape != shape:
            raise ValueError(f"{what}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous {dtype} "
                             f"tensor, got {t.dtype}")


def _launch(ins, *, forward: bool, process_noise: float, meas_noise: float,
            gap_reset_s: float, report_post: bool = True):
    """One launch over checked inputs.  Returns (new state, TrackedObjects
    with (B, O, ...) leaves, the forward filter's per-step (x (B, O, 9),
    P (B, O, 9, 9), initialized (B, O)) or None), all views of one
    allocation."""
    global launches, forward_launches
    lib = _lib()
    dev = ins[0].device
    B, M, _ = ins[0].shape
    O = ins[5].shape[0]
    BO = B * O
    steps = (3, 3, 1) + ((9, 81) if forward else ())   # floats a row
    nf = sum(steps) * BO + O * sum(_STATE_FLOATS)
    nb = (2 if forward else 1) * BO + O
    out = torch.empty(4 * nf + nb, dtype=torch.uint8, device=dev)
    args = (*(t.data_ptr() for t in ins[:5]), ctypes.addressof(_butter_host()),
            *(t.data_ptr() for t in ins[5:]), out.data_ptr(), B, M, O,
            process_noise, meas_noise, gap_reset_s)
    with torch.cuda.device(dev):   # the C launcher uses the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        native.check(lib.lcm_kalman_forward(*args, stream) if forward else
                     lib.lcm_kalman_bank(*args, report_post, stream), NAME)
    launches += 1
    forward_launches += forward
    fbytes, bbytes = out.split([4 * nf, nb])
    per_step = fbytes.view(_F32).split(
        [n * BO for n in steps] + [O * n for n in _STATE_FLOATS])
    pos, vel, heading = per_step[:3]
    x, P, prev, lh, lv, age = per_step[len(steps):]
    flags = bbytes.view(_BOOL).split([BO] * (2 if forward else 1) + [O])
    new = KalmanState(x.view(O, 9), P.view(O, 9, 9), flags[-1],
                      prev.view(O, 3), lh.view(O, 5), lv.view(O, 3, 5), age)
    tracked = TrackedObjects(pos=pos.view(B, O, 3), vel=vel.view(B, O, 3),
                             heading=heading.view(B, O),
                             valid=flags[0].view(B, O))
    if not forward:
        return new, tracked, None
    xs, Ps = per_step[3:5]
    return new, tracked, (xs.view(B, O, 9), Ps.view(B, O, 9, 9),
                          flags[1].view(B, O))


def kalman_scan(state: KalmanState, cand_pos_seq, cand_heading_seq,
                cand_index_seq, cand_valid_seq, dts, *,
                process_noise: float = 1e-2, meas_noise: float = 1.0,
                gap_reset_s: float = 0.5, report: str = "pre"):
    """B sequential bank updates.

    cand_pos_seq (B, M, 3) f32, cand_heading_seq (B, M) f32,
    cand_index_seq (B, M) int32, cand_valid_seq (B, M) bool, dts (B,) f32;
    on the card all contiguous, as are the state's leaves.
    Returns (new_state, TrackedObjects with (B, O, ...) leaves); on the
    card all of them are views of one allocation.
    """
    kw = dict(process_noise=process_noise, meas_noise=meas_noise,
              gap_reset_s=gap_reset_s)
    if report not in ("pre", "post"):
        raise ValueError(f"report must be 'pre' or 'post', got {report!r}")
    if not native.on_card(cand_pos_seq):
        return kalman.update_scan(state, cand_pos_seq, cand_heading_seq,
                                  cand_index_seq, cand_valid_seq, dts,
                                  report=report, **kw)
    ins = (cand_pos_seq, cand_heading_seq, cand_index_seq, cand_valid_seq,
           dts, *state)
    _check("kalman_scan", ins)
    return _launch(ins, forward=False, report_post=report == "post",
                   **kw)[:2]


def forward_scan(state: KalmanState, cand_pos_seq, cand_heading_seq,
                 cand_index_seq, cand_valid_seq, dts, *,
                 process_noise: float = 1e-2, meas_noise: float = 1.0,
                 gap_reset_s: float = 0.5, scan=tree.scan):
    """The RTS smoother's forward filter over T frames: a forward runner
    for ``kalman.smooth_sequence``, ``kalman.forward_filter``'s signature.

    Inputs as ``kalman_scan``'s (B = T), checked on either device.
    Returns (final state, ((TrackedObjects, xs (T, O, 9), Ps (T, O, 9, 9)),
    initialized (T, O))): the committed state after every frame.  On the
    card one launch, all of them views of one allocation; on the CPU
    ``kalman.forward_filter`` through ``scan`` (whose final state is None
    from a runner that returns no carry).
    """
    ins = (cand_pos_seq, cand_heading_seq, cand_index_seq, cand_valid_seq,
           dts, *state)
    _check("forward_scan", ins)
    kw = dict(process_noise=process_noise, meas_noise=meas_noise,
              gap_reset_s=gap_reset_s)
    if not native.on_card(cand_pos_seq):
        return kalman.forward_filter(state, cand_pos_seq, cand_heading_seq,
                                     cand_index_seq, cand_valid_seq, dts,
                                     scan=scan, **kw)
    new, tracked, (xs, Ps, inited) = _launch(ins, forward=True, **kw)
    return new, ((tracked, xs, Ps), inited)


def backward_scan(xs, Ps, dts, *, process_noise: float = 1e-2,
                  scan=tree.scan):
    """The RTS smoother's backward pass over T frames: a backward runner
    for ``kalman.smooth_sequence``, ``kalman.rts_smooth``'s signature.

    xs (T, O, 9), Ps (T, O, 9, 9) and dts (T,), contiguous float32 on one
    device, checked on either.  Returns (xs_smooth, Ps_smooth), the last
    frame the filtered one.  On the card two launches whatever T (none
    for T < 2 or O = 0, where it returns its inputs as ``rts_smooth``
    does), the results views of one allocation; on the CPU
    ``kalman.rts_smooth``, whose sweep runs through ``scan``.
    """
    global launches, backward_launches
    T = xs.shape[0]
    O = xs.shape[1] if xs.dim() > 1 else 0
    for t, shape in ((xs, (T, O, 9)), (Ps, (T, O, 9, 9)), (dts, (T,))):
        if t.device != xs.device:
            raise ValueError("backward_scan: all tensors must be on one "
                             "device")
        if t.shape != shape:
            raise ValueError(f"backward_scan: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != _F32 or not t.is_contiguous():
            raise ValueError(f"backward_scan: expected a contiguous {_F32} "
                             f"tensor, got {t.dtype}")
    if not native.on_card(xs):
        return kalman.rts_smooth(xs, Ps, dts, process_noise=process_noise,
                                 scan=scan)
    if T < 2 or O == 0:
        return xs, Ps
    lib = _lib()
    dev = xs.device
    out = torch.empty(T * O * 90, dtype=_F32, device=dev)
    scratch = torch.empty((T - 1) * O * 171, dtype=_F32, device=dev)
    with torch.cuda.device(dev):   # the C launcher uses the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        native.check(lib.lcm_kalman_rts(
            xs.data_ptr(), Ps.data_ptr(), dts.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), T, O, process_noise, stream), NAME)
    launches += 2
    backward_launches += 2
    xs_s, Ps_s = out.split([T * O * 9, T * O * 81])
    return xs_s.view(T, O, 9), Ps_s.view(T, O, 9, 9)
