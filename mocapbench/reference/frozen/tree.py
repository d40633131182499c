"""Frozen copy of ``low_cost_mocap_tpu_torch/utils/tree.py`` (commit
9b1e9ac), its imports made relative; the benchmark's reference runs it
op by op and never imports the program.

Functions over nested outputs: tensors, tuples and NamedTuples of them,
with None leaves left as None."""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """``fn`` over the matching tensor leaves of ``trees``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    parts = [tree_map(fn, *xs) for xs in zip(*trees)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def stack(trees):
    """Leaves of a sequence of like trees stacked along a new leading
    axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def cat(trees):
    """Leaves of a sequence of like trees concatenated along axis 0."""
    return tree_map(lambda *xs: torch.cat(xs), *trees)


def leaves(tree) -> list:
    """The tensor leaves of a tree, in order (None leaves dropped)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in leaves(sub)]


def scan(step, carry, *xs, reverse: bool = False):
    """``step(carry, *x_k) -> (carry, y_k)`` over the frames of ``xs``
    ((T, ...) tensors), first to last (last to first with ``reverse``), op
    by op: (the final carry, the ys stacked along T in frame order).  The
    loop runner of the offline passes; ``runtime.compiled.ChunkedScan``
    runs the same loop as a replayed graph."""
    n = xs[0].shape[0]
    ys = [None] * n
    for k in (range(n - 1, -1, -1) if reverse else range(n)):
        carry, ys[k] = step(carry, *(x[k] for x in xs))
    return carry, stack(ys)
