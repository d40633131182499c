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
on a side stream, one a device and thread (``WARMUP_CALLS`` calls on a
scratch copy of the state, which also run each kernel launcher's one-time
set-up), is captured in the thread-local mode (other threads' launches and
event waits go on), and is then replayed at every call.  A capture that
fails raises: nothing falls back to launching the step op by op.  Its
outputs are tensors of the graph's memory pool that the next replay
overwrites, so a caller reads them, or enqueues their copy on the same
stream, before the next call.
On the CPU the same buffers serve an eager call of ``fn``, with the same
donation; so does every call inside ``disable_graphs()`` (the counterpart
of ``jax.disable_jit``), on its thread: the reference a graph is held to.

The kernel wrappers count the launches made from Python: a capture's
count is taken back (it launched nothing) and added again at each replay.
``replays`` counts the graph replays, ``captures`` the captures,
``warmup_launches`` the kernel launches of the warm-up calls.

``ChunkedScan`` runs a per-frame loop over a recording of any length T as
one ``CompiledStep`` of a fixed number of frames, replayed once a chunk
(the JAX package's ``lax.scan`` inside a jitted program, without a program
per T), and an iterative solver's loop as one step of a fixed number of
iterations, replayed until a stop flag is set (``run_until``: the JAX
package's fixed-length ``lax.scan`` over a frozen carry);
``GraphCache`` keeps such steps, at most ``CACHE_SIZE`` of them, as JAX's
``lru_cache(maxsize=16)`` keeps compiled programs.

A step built ``lazy`` runs its first call op by op on the side stream: that
call is its warm-up, and the capture waits for the second call, so a step
called once costs no more than the step op by op.  A lazy loop of
``ChunkedScan.run_until`` runs its whole first run so (a solver's first
call at a new shape), and captures at the next run.

``HostRing`` is a ring of page-locked host buffers with an event a slot,
through which the Engine's ingest and readback and offline processing's
uploads pass; ``copy_stream`` is the stream those uploads run on.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import numpy as np
import torch

from low_cost_mocap_tpu_torch.ops import detect_cuda, kalman_cuda
from low_cost_mocap_tpu_torch.utils.tree import leaves, scan, tree_map

WARMUP_CALLS = 3
CACHE_SIZE = 16
_WRAPPERS = (detect_cuda, kalman_cuda)

replays = 0
captures = 0
warmup_launches = {w.NAME: 0 for w in _WRAPPERS}
_local = threading.local()


@contextlib.contextmanager
def disable_graphs():
    """On this thread, every ``CompiledStep`` call in the block runs its
    step op by op over its buffers (``CompiledStep.eager``): no capture, no
    replay.  The reference the graphs are held to, as ``jax.disable_jit``
    is JAX's."""
    before = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = before


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


def side_stream(dev: torch.device):
    """The stream on which this thread warms up and captures the steps of
    ``dev``: one a device and thread, so that the blocks the allocator
    caches for it serve every step's warm-up (a new stream starts with
    none: a step run op by op on it allocates its whole working set)."""
    return _thread_stream(dev, "side")


def copy_stream(dev: torch.device):
    """The stream on which this thread uploads host data for the steps of
    ``dev`` (``models/offline.py``'s staging ring): one a device and
    thread, not ``side_stream``, so that an upload overlaps the replays on
    the current stream and never enters a step's warm-up or capture."""
    return _thread_stream(dev, "copy")


def _thread_stream(dev: torch.device, kind: str):
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if (kind, index) not in streams:
        streams[kind, index] = torch.cuda.Stream(torch.device("cuda", index))
    return streams[kind, index]


class HostRing:
    """A ring of host buffers for copies between the host and the card.

    On a CUDA engine the buffers are page-locked (a ``non_blocking`` copy
    from or to pageable memory is silently synchronous), and each slot has
    an event recorded after the last copy that used it.  ``acquire`` waits
    for that event before the host touches the buffer again: a pinned
    buffer rewritten under an upload still in flight corrupts that frame
    without any error.  On a CPU engine the buffers are plain tensors and
    every copy completes at once."""

    def __init__(self, n: int, shape, device: torch.device,
                 dtype=torch.float32):
        self.cuda = device.type == "cuda"
        self.device = device
        self.bufs = [torch.zeros(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(n)]
        if self.cuda and not all(b.is_pinned() for b in self.bufs):
            raise RuntimeError("host buffers are not page-locked")
        self.events = ([torch.cuda.Event() for _ in range(n)]
                       if self.cuda else None)
        self._next = 0

    def acquire(self) -> int:
        """The next slot, once the copy that last used it has completed."""
        i = self._next
        self._next = (i + 1) % len(self.bufs)
        self.wait(i)
        return i

    def fence(self, i: int) -> None:
        """Record slot i's event after the copy just enqueued."""
        if self.cuda:
            self.events[i].record(torch.cuda.current_stream(self.device))

    def wait(self, i: int) -> None:
        if self.cuda:
            self.events[i].synchronize()


def _counts() -> list:
    return [w.launches for w in _WRAPPERS]


class CompiledStep:
    """``fn(state, *args) -> (new_state, out)`` captured as a CUDA graph on
    the card, run eagerly on the CPU, over the given buffers.

    ``state``: a tree of tensors, donated: a call leaves the new state in
    these tensors (``()`` for a step without state).  ``args``: one buffer
    (a tensor, or a tree of them) for each of ``fn``'s other arguments.
    Every buffer lies on one device and keeps its shape and dtype: a call
    that gives another raises.

    After the capture ``capture_ms`` is its wall time (the warm-up
    excluded) and ``pool_bytes`` the device memory its pool reserved;
    ``launches_per_replay`` the kernel wrappers' launches a replay makes.

    ``lazy``: on the card the first call runs ``fn`` op by op over the
    buffers on the side stream (``warm_call``), in place of the
    ``WARMUP_CALLS`` warm-up calls, and the capture comes at the second
    call.
    """

    def __init__(self, fn, state, *args, name: str = "step",
                 lazy: bool = False):
        self.fn = fn
        self.name = name
        self.state = state
        self.args = args
        self.device = leaves((state, args))[0].device
        self.lazy = lazy
        self.graph = None
        self.out = None
        self.capture_ms = None
        self.pool_bytes = None
        self.launches_per_replay = None
        self._stream = None

    def __call__(self, state, *args):
        """Copy ``state`` and ``args`` into the buffers (nothing for the
        buffers themselves), run the step, and return (the state buffers,
        the step's outputs): the graph's replay on the card, ``eager`` on
        the CPU."""
        global replays
        if self.device.type != "cuda" or getattr(_local, "eager", False):
            return self.eager(state, *args)
        self._load(state, args)
        if self.graph is None:
            if self.lazy and self._stream is None:
                return self._on_stream()
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

    def warm_call(self, state, *args):
        """A call that runs the step op by op, never captures: a lazy
        step's first call, which any number of calls may precede.  On the
        card it runs on the stream the capture will use, so each library's
        one-time set-up for that stream happens here, outside the
        capture, and a lazy step captures at its next ``__call__``."""
        if self.device.type != "cuda" or getattr(_local, "eager", False):
            return self.eager(state, *args)
        self._load(state, args)
        return self._on_stream()

    def _on_stream(self):
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = side_stream(dev)
        stream = self._stream
        stream.wait_stream(cur)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            new, out = self.fn(self.state, *self.args)
            assign(self.state, new)
        cur.wait_stream(stream)
        for t in leaves(out):
            t.record_stream(cur)
        return self.state, out

    def _capture(self) -> None:
        dev = self.device
        warm = _counts()
        if self._stream is None:
            self._stream = side_stream(dev)
            scratch = tree_map(torch.clone, self.state)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.device(dev), torch.cuda.stream(self._stream):
                for _ in range(WARMUP_CALLS):
                    self.fn(scratch, *self.args)
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            before, warm = warm, _counts()
            for w, a, b in zip(_WRAPPERS, before, warm):
                warmup_launches[w.NAME] += b - a
            del scratch
        stream = self._stream
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
        global captures
        captures += 1
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches_per_replay = captured
        self.graph, self.out = graph, out


class GraphCache:
    """Compiled steps by key, the ``CACHE_SIZE`` most recently used: a new
    key beyond that drops the least recently used step and its graph.  It
    takes no lock: its user serialises the calls that use it (the steps'
    buffers are shared too)."""

    def __init__(self, size: int = CACHE_SIZE):
        self.size = size
        self._steps: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, build):
        """The step for ``key``, built by ``build()`` at its first use."""
        step = self._steps.pop(key, None)
        if step is None:
            step = build()
        self._steps[key] = step
        while len(self._steps) > self.size:
            self._steps.popitem(last=False)
        return step

    def __len__(self) -> int:
        return len(self._steps)

    def values(self) -> list:
        return list(self._steps.values())

    def clear(self) -> None:
        self._steps.clear()


class ChunkedScan:
    """A per-frame loop ``step(carry, *x_k) -> (carry, y_k)`` over T frames,
    whatever T, as one ``CompiledStep`` of ``length`` frames replayed once
    a chunk; or, with no ``xs``, an iterative loop ``step(carry, *consts)
    -> carry`` as one step of ``length`` iterations (``run_until``).

    Built from an example ``carry`` and example sequences ``xs`` ((T, ...)
    tensors; only their trailing shapes, dtypes and device count).  ``run``
    copies each chunk of the sequences into the step's buffers and the
    chunk's ys out of the graph's memory into (T, ...) tensors of its own.
    The chunk past the end (the one before the start with ``reverse``,
    where the loop runs from the last frame to the first) is padded with
    zeros; its padded frames run after every real frame, so no returned y
    depends on them, and the carry after them is not returned.  A step
    that reads a value to the host cannot be captured: the capture raises.
    The buffers are the step's: its user runs one ``run`` at a time.

    ``consts``: example buffers of an iterative loop's other arguments,
    copied in at each ``run_until``; ``stop(carry)``: its stop flag (a
    bool tensor), read between two chunks and, where a chunk runs op by
    op (the CPU, ``disable_graphs()``, a lazy loop's first run), after
    each iteration, ending the chunk early as the loop it replaces did.
    ``chunk``: in place of ``step``, an
    object called like a ``CompiledStep`` (``chunk(carry, *consts) ->
    (carry, ())`` over buffers ``chunk.args``) that runs ``length``
    iterations itself, as a solver spread over several devices does with
    a graph per device.  ``chunks`` and ``reads`` count the chunks
    ``run_until`` replayed and the stop flags it read, over the step's
    life.
    """

    def __init__(self, step, carry, xs, length: int, *, reverse=False,
                 consts=(), stop=None, lazy: bool = False,
                 name: str = "scan", chunk=None):
        self.length = int(length)
        self.reverse = reverse
        self.stop = stop
        self.chunks = self.reads = 0
        if chunk is not None:
            self.step = chunk
            return
        if xs:
            fn = functools.partial(scan, step, reverse=reverse)
            bufs = tuple(torch.zeros((self.length,) + tuple(x.shape[1:]),
                                     dtype=x.dtype, device=x.device)
                         for x in xs)
        else:
            fn = functools.partial(_repeat, step, self.length, stop)
            bufs = tuple(tree_map(torch.clone, c) for c in consts)
        self.step = CompiledStep(fn, tree_map(torch.clone, carry), *bufs,
                                 name=name, lazy=lazy)

    def run(self, carry, *xs):
        """The ys of the loop (``utils.tree.scan``) from ``carry`` over
        ``xs`` ((T, ...) tensors, T >= 1) as (T, ...) tensors; the chunks
        in loop order."""
        T, L = xs[0].shape[0], self.length
        ys, state = None, carry
        for c in range(-(-T // L)):
            lo = T - (c + 1) * L if self.reverse else c * L
            a, b = max(lo, 0), min(lo + L, T)
            state, out = self.step(state, *(
                x[a:b] if b - a == L else _padded(x, a, b, a - lo, L)
                for x in xs))
            if ys is None:
                ys = tree_map(
                    lambda y: y.new_empty((T,) + tuple(y.shape[1:])), out)
            for dst, y in zip(leaves(ys), leaves(out)):
                dst[a:b].copy_(y[a - lo:b - lo])
        return ys

    def run_until(self, carry, iterations: int, *consts):
        """The iterative loop from ``carry`` over ``consts``: the chunk
        replayed ``ceil(iterations / length)`` times, ``stop`` read once
        between two chunks, ending the loop when it is set.  The step must
        leave its carry unchanged once it has stopped (or spent its
        budget), so the iterations a graph runs past that point change
        nothing.  A lazy loop's first run goes op by op
        (``CompiledStep.warm_call``), and the next run captures: a solver
        called once at a shape costs what it costs op by op.  Returns the
        final carry: the step's buffers, which the next run overwrites."""
        state, args = carry, consts
        call = self.step
        if getattr(call, "lazy", False) and self.chunks == 0:
            call = call.warm_call
        for c in range(-(-int(iterations) // self.length)):
            if c:
                self.reads += 1
                if bool(self.stop(state)):
                    break
            state, _ = call(state, *args)
            self.chunks += 1
            args = self.step.args
        return state


def _repeat(step, n: int, stop, carry, *consts):
    """``n`` iterations of ``step(carry, *consts) -> carry``; outside a
    capture, the first iteration that sets ``stop`` ends them (the carry
    would not change after it)."""
    for _ in range(n):
        carry = step(carry, *consts)
        if stop is not None:
            flag = stop(carry)
            if not (flag.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()) \
                    and bool(flag):
                break
    return carry, ()


def _padded(x, a, b, at, length):
    """Frames a..b of ``x`` at offset ``at`` of ``length`` zero frames."""
    out = x.new_zeros((length,) + tuple(x.shape[1:]))
    out[at:at + b - a] = x[a:b]
    return out
