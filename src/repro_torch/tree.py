"""Nested dicts, lists and tuples of tensors (the port's param trees)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tree_leaves", "tree_map", "tree_copy"]


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_copy(tree):
    """A copy of ``tree`` whose tensors and arrays share no memory with it
    (tensors requiring grad where the originals do)."""
    def leaf(t):
        if isinstance(t, torch.Tensor):
            return t.detach().clone().requires_grad_(t.requires_grad)
        return np.array(t) if isinstance(t, np.ndarray) else t
    return tree_map(leaf, tree)
