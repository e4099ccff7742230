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



def tree_map_with_path_str(fn: Callable[[str, Any], Any],
                           tree: PyTree) -> PyTree:
    """Map ``fn(path_string, leaf)``, the path as ``jax.tree_util.keystr``
    renders it (``['layers']['wq']``, ``.field``, ``[0]``)."""
    paths = [path for path, _ in flatten_with_path(tree)]
    return tree_map_with_index(lambda i, x: fn(paths[i], x), tree)


def tree_size(tree: PyTree) -> int:
    """Total number of scalar parameters in the tree."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Global dot product of two same-structure trees: each leaf's
    ``sum(x·y)`` in f32, the leaf sums added in leaf order in f32 from 0.
    Returns a 0-d f32 tensor on the leaves' device (JAX returns a 0-d f32
    array); the in-leaf sums run in torch's order, not XLA's."""
    acc = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        part = torch.sum(x.to(torch.float32) * y.to(torch.float32))
        acc = part if acc is None else acc + part
    return torch.zeros((), dtype=torch.float32) if acc is None else acc


def tree_sq_norm(tree: PyTree) -> torch.Tensor:
    return tree_dot(tree, tree)


def tree_add_scaled(a: PyTree, b: PyTree, scale) -> PyTree:
    """a + scale * b, elementwise over matching trees (in a's dtype).  A
    Python scalar is weakly typed, as in JAX: it is rounded to the leaf
    dtype and the arithmetic runs there; a tensor scale is a strongly typed
    f32, so the sum is formed in f32 and rounded once."""
    def one(x, y):
        y = y.to(x.dtype)
        if isinstance(scale, torch.Tensor):
            s = scale.to(torch.float32)
            return (x.to(torch.float32) + s * y.to(torch.float32)).to(x.dtype)
        s = torch.tensor(float(scale), dtype=x.dtype, device=x.device)
        return x + s * y
    return tree_map(one, a, b)


def tree_cast(tree: PyTree, dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), tree)


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_allclose(a: PyTree, b: PyTree, rtol=1e-5, atol=1e-6) -> bool:
    def one(x, y):
        dt = torch.promote_types(x.dtype, y.dtype)
        return bool(torch.allclose(x.to(dt), y.to(dt), rtol=rtol, atol=atol))
    return all(one(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_max_abs_diff(a: PyTree, b: PyTree) -> float:
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.numel():
            d = (x.to(torch.float32) - y.to(torch.float32)).abs().max()
            worst = max(worst, float(d))
    return worst
