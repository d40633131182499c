"""Functions over nested outputs: tensors, tuples and NamedTuples of them,
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
