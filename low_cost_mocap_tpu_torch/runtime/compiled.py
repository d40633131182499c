"""Compiled steps: a served step captured once as a CUDA graph and replayed.

The port's counterpart of the JAX package's compiled, state-donating
steps: ``low_cost_mocap_tpu/runtime/engine.py:_build_steps`` (the Engine's
``_step``, ``_step_sparse``, ``_step_blobs`` and ``_step_scan``, each a
``jax.jit(..., donate_argnums=(0,))``) and the jitted ``frame_step`` of
``low_cost_mocap_tpu/models/pipeline.py:258`` (``MocapPipeline``).

A ``CompiledStep`` runs ``fn(state, *args) -> (new_state, out)`` over
static buffers: the state's tensors and one tensor for each argument,
given at construction.  A call copies every argument that is not its
buffer into the buffer (a tensor or an array with ``copy_``, a number with
``fill_``), runs the step, and copies the new state into the state
buffers at its end: the caller's state object is the buffers, as JAX's
``donate_argnums=(0,)`` reuses the state's arrays.  Several steps built on
the same state and calibration tensors share them, so a state the
per-frame step leaves is the one the packed step takes up, and new
calibration is copied into the calibration buffers in place
(``assign``), never rebound: a graph would go on reading the old tensors
without any error.

On the card the step is a CUDA graph.  At the first call the step warms up
on a side stream (``WARMUP_CALLS`` calls on a scratch copy of the state,
which also run each kernel launcher's one-time set-up), is captured in the
thread-local mode (other threads' launches and event waits go on), and is
then replayed at every call.  A capture that fails raises: nothing falls
back to launching the step op by op.  Its outputs are tensors of the
graph's memory pool that the next replay overwrites, so a caller reads
them, or enqueues their copy on the same stream, before the next call.
On the CPU the same buffers serve an eager call of ``fn``, with the same
donation.

The kernel wrappers count the launches made from Python: a capture's
count is taken back (it launched nothing) and added again at each replay.
``replays`` counts the graph replays, ``warmup_launches`` the kernel
launches of the warm-up calls.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman_cuda
from low_cost_mocap_tpu_torch.utils.tree import leaves, tree_map

WARMUP_CALLS = 3
_WRAPPERS = (detect_cuda, kalman_cuda)

replays = 0
warmup_launches = {w.NAME: 0 for w in _WRAPPERS}


def assign(dst, src) -> None:
    """Copy the leaves of ``src`` into the like-shaped leaves of ``dst`` in
    place (a tensor, an array or a number each)."""
    d = leaves(dst)
    s = leaves(src) if isinstance(src, (tuple, list)) else [src]
    if len(d) != len(s):
        raise ValueError(f"{len(s)} values for {len(d)} buffers")
    for buf, x in zip(d, s):
        _put(buf, x)


def _put(buf: torch.Tensor, x) -> None:
    if x is buf:
        return
    if isinstance(x, np.ndarray) and x.ndim:
        x = torch.from_numpy(x)
    if isinstance(x, torch.Tensor):
        if x.shape != buf.shape or x.dtype != buf.dtype:
            raise ValueError(f"a {x.dtype} {tuple(x.shape)} tensor for a "
                             f"{buf.dtype} {tuple(buf.shape)} buffer")
        buf.copy_(x, non_blocking=True)
    elif buf.dim() == 0:
        buf.fill_(float(x) if buf.is_floating_point() else int(x))
    else:
        raise ValueError(f"a number for a {tuple(buf.shape)} buffer")


def _counts() -> list:
    return [w.launches for w in _WRAPPERS]


class CompiledStep:
    """``fn(state, *args) -> (new_state, out)`` captured as a CUDA graph on
    the card, run eagerly on the CPU, over the given buffers.

    ``state``: a tree of tensors, donated: a call leaves the new state in
    these tensors.  ``args``: one buffer (a tensor, or a tree of them) for
    each of ``fn``'s other arguments.  Every buffer lies on one device and
    keeps its shape and dtype: a call that gives another raises.

    After the capture ``capture_ms`` is its wall time (the warm-up
    excluded) and ``pool_bytes`` the device memory its pool reserved;
    ``launches_per_replay`` the kernel wrappers' launches a replay makes.
    """

    def __init__(self, fn, state, *args, name: str = "step"):
        self.fn = fn
        self.name = name
        self.state = state
        self.args = args
        self.device = leaves(state)[0].device
        self.graph = None
        self.out = None
        self.capture_ms = None
        self.pool_bytes = None
        self.launches_per_replay = None

    def __call__(self, state, *args):
        """Copy ``state`` and ``args`` into the buffers (nothing for the
        buffers themselves), run the step, and return (the state buffers,
        the step's outputs): the graph's replay on the card, ``eager`` on
        the CPU."""
        global replays
        if self.device.type != "cuda":
            return self.eager(state, *args)
        self._load(state, args)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        replays += 1
        for w, n in zip(_WRAPPERS, self.launches_per_replay):
            w.launches += n
        return self.state, self.out

    def eager(self, state, *args):
        """The step op by op over the same buffers, with the same donation:
        what a call runs on the CPU, and on the card the reference that
        its graph is held to."""
        self._load(state, args)
        new, out = self.fn(self.state, *self.args)
        assign(self.state, new)
        return self.state, out

    def _load(self, state, args) -> None:
        if len(args) != len(self.args):
            raise TypeError(f"{self.name}: {len(args)} arguments for "
                            f"{len(self.args)} buffers")
        assign(self.state, state)
        for buf, x in zip(self.args, args):
            assign(buf, x)

    def _capture(self) -> None:
        dev = self.device
        stream = torch.cuda.Stream(dev)
        before = _counts()
        scratch = tree_map(torch.clone, self.state)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            for _ in range(WARMUP_CALLS):
                self.fn(scratch, *self.args)
        torch.cuda.current_stream(dev).wait_stream(stream)
        warm = _counts()
        for w, a, b in zip(_WRAPPERS, before, warm):
            warmup_launches[w.NAME] += b - a
        del scratch
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(dev), torch.cuda.graph(
                    graph, stream=stream, capture_error_mode="thread_local"):
                new, out = self.fn(self.state, *self.args)
                assign(self.state, new)
        finally:
            # the capture launched nothing: its counts come back at replay
            captured = [n - w for n, w in zip(_counts(), warm)]
            for w, n in zip(_WRAPPERS, warm):
                w.launches = n
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches_per_replay = captured
        self.graph, self.out = graph, out

