"""Dict-of-tensor pytree helpers in **jax's flatten order**.

The counter-hash z stream of leaf ``i`` is seeded by ``leaf_seed(seed, i)``,
so the leaf index must be exactly the one ``jax.tree_util`` assigns: dict keys
sorted, depth first.  Lists, tuples and named tuples flatten in order;
``None`` is an empty subtree (jax treats it as having no leaves).  Paths
render as ``jax.tree_util.keystr`` does (``['layers']['attn']['wq']``, and
``.field`` for a named tuple's field).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, List, Tuple

import torch

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild(t, values):
    """A sequence node of ``t``'s type holding ``values``."""
    if _is_namedtuple(t):
        return type(t)(*values)
    return type(t)(values)


def flatten_with_path(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in jax order (sorted dict keys, sequences in order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_path(tree[k], f"{prefix}[{k!r}]"))
        return out
    if _is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out.extend(flatten_with_path(v, f"{prefix}.{name}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(flatten_with_path(v, f"{prefix}[{i}]"))
        return out
    return [(prefix, tree)]


def tree_leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map_with_index(fn: Callable[[int, Any], Any], tree: PyTree) -> PyTree:
    """Map ``fn(leaf_index, leaf)`` with the jax leaf index."""
    counter = itertools.count()

    def rec(t):
        if t is None:
            return None
        if isinstance(t, dict):
            # visit in sorted order (the index order) but keep insertion order
            done = {k: rec(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [rec(v) for v in t])
        return fn(next(counter), t)

    return rec(tree)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``jax.tree_util.tree_map``: ``fn`` over corresponding leaves of trees
    of one structure (the first tree's)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """``like``'s structure holding ``leaves`` (in jax flatten order)."""
    leaves = list(leaves)
    return tree_map_with_index(lambda i, _: leaves[i], like)


def tree_clone(tree: PyTree) -> PyTree:
    """A copy of every tensor leaf (other leaves are shared)."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


def is_floating(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype.is_floating_point

