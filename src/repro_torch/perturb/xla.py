"""The threefry backend — the port of ``repro.perturb.xla``, JAX's default.

z for leaf ``i`` of stream ``ref`` is ``jax.random.normal`` (or
``rademacher``) of ``fold_in(ref.key, i)`` in the leaf's dtype, under the
threefry layout in force (``perturb.stream.threefry_partitionable``, JAX's
knob).  Either way element e's bits are a function of (leaf key, leaf
size, e) — partitionable: the hash of (key, e); original: a word of the
pairing across the whole leaf — so a band or a chunk is generated alone,
given the leaf's size, and rows plans are written band by band.  Every write is one X1 pass
(``kernels/threefry``): the CUDA kernel on the card, its plain torch version
on the CPU, bitwise JAX's ``xla`` backend on the CPU for every method.  The
stream id is ``xla``, so ledgers move between the two frameworks both ways
(MZOL1, which predates backend records, implies it).

Each method writes the graph JAX's backend traces (``kernel.FORMS``):

* ``perturb``: θ + s·z (form ``xpbz``);
* ``fused_restore_update``: decay·(θ + ε·z) − η·g·z (form ``restore``);
* ``apply_rank1``: (1 − decay_term)·θ − coeff·z (form ``axpbz``), z times
  the leaf's d under rescaled SPSA's ``d_tree``;
* ``leaf_z``: z itself (form ``z``); ``perturb_leaf``: one leaf's
  θ + s·z (form ``xpbz``).

Scalars are cast to the leaf dtype as JAX's ``jnp.asarray(s, p.dtype)``
does.  ``sphere`` is the gaussian stream times √d/‖z‖ (``_sphere_scale``:
‖z‖² regenerated leaf by leaf in chunks, never stored), rounded to the leaf
dtype as a z scale — in ``perturb``, ``fused_restore_update`` and
``perturb_many``; ``apply_rank1`` and ``leaf_z`` take the plain gaussian
direction, as in JAX (its sphere callers pre-scale the coefficient).
The backend writes in place; unselected and non-floating leaves are left
alone.

The module also holds JAX's functional API, ``repro.perturb.xla``'s
module-level functions (re-exported by ``repro_torch.core.perturb``):
``leaf_key``, ``sample_leaf_z``, ``sample_z_tree``, ``perturb``,
``fused_restore_update``, ``apply_rank1``, ``perturb_jit`` and
``_sphere_scale``.  These are pure, as JAX's are: each write launches X1
with a fresh output leaf (the same form and scalars as the backend's
in-place write, so the same bits), and the caller's leaves keep theirs;
unselected and non-floating leaves come back as the same objects.  X1's
forms are the graphs XLA:CPU compiles under ``jit``; JAX called outside
``jit`` runs its functions op by op, which rounds s·z on its own and
contracts nothing: bf16 and rademacher ``perturb`` writes agree bitwise,
the f32 and f16 gaussian ones within one ulp of the leaf dtype (ROADMAP
Queue 3).
"""
from __future__ import annotations

from typing import Literal, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.threefry.kernel import zo_affine_threefry
from repro_torch.perturb.base import PerturbBackend, per_stream_scales
from repro_torch.perturb.counter import _active, _leaf_blocks
from repro_torch.perturb.stream import StreamRef, fold_in
from repro_torch.tree_utils import (PyTree, is_floating, tree_leaves,
                                    tree_map, tree_map_with_index,
                                    tree_size, tree_sq_norm)

Distribution = Literal["gaussian", "rademacher", "sphere"]

f32 = np.float32
#: elements of z generated per pass of the sphere's ‖z‖² (bounds the
#: temporary to a chunk, not a leaf)
SQNORM_CHUNK = 1 << 24


def in_dtype(v, dtype: torch.dtype) -> float:
    """``jnp.asarray(v, dtype)`` of an f32 scalar, as a Python float."""
    return float(torch.tensor(float(f32(v)), dtype=torch.float32).to(dtype))


def leaf_sqnorm(p: torch.Tensor, key, bands=None) -> np.float32:
    """Σ z² (f32 z of the leaf's gaussian stream) over the leaf or its
    bands, generated chunk by chunk with X1's ``z`` form."""
    ranges = [(0, p.numel())] if bands is None else bands
    acc = 0.0
    buf = None
    for lo0, hi0 in ranges:
        for lo in range(lo0, hi0, SQNORM_CHUNK):
            hi = min(lo + SQNORM_CHUNK, hi0)
            if buf is None or buf.numel() < hi - lo:
                buf = torch.empty(min(SQNORM_CHUNK, hi0 - lo0),
                                  dtype=p.dtype, device=p.device)
            z = zo_affine_threefry(None, key, "z", out=buf[:hi - lo],
                                   offset=lo, total=p.numel())
            acc += float(torch.sum(z.float().square(), dtype=torch.float64))
    return f32(acc)


def _sphere_scale(params: PyTree, key, mask: Optional[tuple] = None,
                  blocks: Optional[tuple] = None) -> np.float32:
    """sqrt(d)/‖z(key)‖ over the selected floating leaves (d and ‖z‖
    counting selected row bands only under a rows plan); ‖z‖² regenerated
    leaf by leaf in chunks and summed in f32, as JAX's ``_sphere_scale``
    does.  A host f32 (JAX returns a 0-d f32 array)."""
    d, sq = 0, f32(0.0)
    for i, p in enumerate(tree_leaves(params)):
        if not _active(p, mask, i):
            continue
        rb = _leaf_blocks(blocks, i)
        d += p.numel() if rb is None else rb.selected_elems()
        sq = f32(sq + leaf_sqnorm(p, fold_in(key, i),
                                  None if rb is None else rb.ranges()))
    if d == 0:
        raise ValueError(
            "sphere perturbation needs at least one selected floating "
            "leaf (the sqrt(d)/‖z‖ rescale is undefined on an empty "
            "subspace)")
    return f32(np.sqrt(f32(f32(d) / sq)))


def _write(params: PyTree, key, form: str, a, b, e, dist: str, zs=None,
           d_leaves=None, mask: Optional[tuple] = None,
           blocks: Optional[tuple] = None, in_place: bool = False) -> PyTree:
    """One X1 pass of ``form`` over every selected floating leaf, each
    scalar cast to the leaf dtype; into the leaf itself (``in_place``) or
    into a fresh leaf (under a rows plan a copy of the leaf, whose bands
    are then written)."""
    kdist = "gaussian" if dist == "sphere" else dist

    def one(i, p):
        if not _active(p, mask, i):
            return p
        dt = p.dtype
        z_scale = zs if d_leaves is None else d_leaves[i]
        rb = _leaf_blocks(blocks, i)
        if in_place:
            out = p
        elif rb is None:
            out = torch.empty(p.shape, dtype=dt, device=p.device)
        else:
            out = p.clone(memory_format=torch.contiguous_format)
        return zo_affine_threefry(
            p, fold_in(key, i), form, in_dtype(a, dt), in_dtype(b, dt),
            in_dtype(e, dt),
            None if z_scale is None else in_dtype(z_scale, dt), kdist,
            out=out, bands=None if rb is None else rb.ranges())

    return tree_map_with_index(one, params)


def _check_dist(dist: str) -> None:
    if dist not in ("gaussian", "rademacher", "sphere"):
        raise ValueError(f"unknown distribution {dist!r}")


# --------------------------------------------------------------------------- #
# The functional API (JAX's module-level functions; pure)
# --------------------------------------------------------------------------- #
def leaf_key(key, leaf_idx: int):
    """Stable per-leaf PRNG key: ``fold_in(key, leaf_idx)``."""
    return fold_in(key, leaf_idx)


def sample_leaf_z(key, leaf: torch.Tensor, dist: Distribution = "gaussian",
                  zo_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One leaf's z (X1's ``z`` form into a fresh tensor): drawn in
    ``zo_dtype`` (default the leaf dtype, f32 for a non-floating leaf),
    then cast to the leaf dtype (round to nearest even, as ``astype``).
    ``sphere`` is the gaussian direction; the caller applies √d/‖z‖."""
    _check_dist(dist)
    sdtype = zo_dtype or (leaf.dtype if is_floating(leaf)
                          else torch.float32)
    z = torch.empty(leaf.shape, dtype=sdtype, device=leaf.device)
    zo_affine_threefry(None, key, "z",
                       dist="gaussian" if dist == "sphere" else dist, out=z)
    return z.to(leaf.dtype)


def sample_z_tree(params: PyTree, key,
                  dist: Distribution = "gaussian") -> PyTree:
    """The whole z tree, materialized (tests and oracles only).  Under
    ``sphere`` every leaf is scaled by sqrt(d / ‖z‖²) (an f32 0-d tensor,
    the sum in torch's order) cast to the leaf dtype."""
    z = tree_map_with_index(
        lambda i, p: sample_leaf_z(leaf_key(key, i), p, dist), params)
    if dist == "sphere":
        scale = torch.sqrt(tree_size(params) / tree_sq_norm(z))
        z = tree_map(lambda x: x * scale.to(x.dtype), z)
    return z


def perturb(params: PyTree, key, scale, dist: Distribution = "gaussian",
            mask: Optional[tuple] = None,
            blocks: Optional[tuple] = None) -> PyTree:
    """θ + scale·z(key) as a new tree (form ``xpbz``).  ``mask`` is a
    per-leaf selection (unselected leaves pass through), ``blocks`` the
    per-leaf rows plans (only the selected bands are written)."""
    _check_dist(dist)
    sph = _sphere_scale(params, key, mask, blocks) if dist == "sphere" \
        else None
    return _write(params, key, "xpbz", 0.0, scale, 0.0, dist, sph,
                  mask=mask, blocks=blocks)


def fused_restore_update(params_minus: PyTree, key, eps, lr_g,
                         weight_decay=0.0, dist: Distribution = "gaussian",
                         mask: Optional[tuple] = None,
                         blocks: Optional[tuple] = None) -> PyTree:
    """From θ − εz, (1 − λ)·(θ − εz + εz) − η·g·z as a new tree in one pass
    (form ``restore``): the paper's reset and descent loops fused."""
    _check_dist(dist)
    sph = (_sphere_scale(params_minus, key, mask, blocks)
           if dist == "sphere" else None)
    return _write(params_minus, key, "restore", f32(1.0) - f32(weight_decay),
                  -f32(lr_g), eps, dist, sph, mask=mask, blocks=blocks)


def apply_rank1(params: PyTree, key, coeff, decay_term=0.0,
                dist: Distribution = "gaussian",
                d_tree: Optional[PyTree] = None,
                mask: Optional[tuple] = None,
                blocks: Optional[tuple] = None) -> PyTree:
    """(1 − decay_term)·θ − coeff·z(key) as a new tree (form ``axpbz``), z
    times the leaf's d under ``d_tree`` (Definition 6's D·z); ``sphere``
    takes the plain gaussian direction, as in JAX."""
    _check_dist(dist)
    d_leaves = (None if d_tree is None else
                [f32(float(v)) for v in tree_leaves(d_tree)])
    return _write(params, key, "axpbz", f32(1.0) - f32(decay_term),
                  -f32(coeff), 0.0, dist, d_leaves=d_leaves, mask=mask,
                  blocks=blocks)


def perturb_jit(params: PyTree, key, scale,
                dist: Distribution = "gaussian") -> PyTree:
    """JAX's jitted ``perturb``.  X1's forms are the graphs XLA:CPU
    compiles under ``jit``, so this is ``perturb``: bitwise JAX's
    ``perturb_jit``."""
    return perturb(params, key, scale, dist)


# --------------------------------------------------------------------------- #
# Backend adapter
# --------------------------------------------------------------------------- #
class XLABackend(PerturbBackend):
    """Threefry z streams through X1, all distributions."""

    name = "xla"
    dists = frozenset({"gaussian", "rademacher", "sphere"})

    def _sphere_scale(self, params: PyTree, ref: StreamRef) -> np.float32:
        return _sphere_scale(params, ref.key, ref.selection_mask(params),
                             ref.selection_blocks(params))

    def _map(self, params: PyTree, ref: StreamRef, form: str, a, b, e, dist,
             zs=None, d_leaves=None) -> PyTree:
        return _write(params, ref.key, form, a, b, e, dist, zs, d_leaves,
                      ref.selection_mask(params),
                      ref.selection_blocks(params), in_place=True)

    def perturb(self, params: PyTree, ref: StreamRef, scale,
                dist: str = "gaussian") -> PyTree:
        self.check_dist(dist)
        sph = self._sphere_scale(params, ref) if dist == "sphere" else None
        return self._map(params, ref, "xpbz", 0.0, scale, 0.0, dist, sph)

    def fused_restore_update(self, params_minus: PyTree, ref: StreamRef, eps,
                             lr_g, weight_decay=0.0,
                             dist: str = "gaussian") -> PyTree:
        # decay·(θ − εz + εz) − η·g·z, the restore and the descent in one
        # pass with z regenerated once
        self.check_dist(dist)
        sph = (self._sphere_scale(params_minus, ref) if dist == "sphere"
               else None)
        decay = f32(1.0) - f32(weight_decay)
        return self._map(params_minus, ref, "restore", decay, -f32(lr_g),
                         eps, dist, sph)

    def apply_rank1(self, params: PyTree, ref: StreamRef, coeff,
                    decay_term=0.0, dist: str = "gaussian",
                    d_tree: Optional[PyTree] = None) -> PyTree:
        self.check_dist(dist)
        d_leaves = (None if d_tree is None else
                    [f32(v) for v in tree_leaves(d_tree)])
        return self._map(params, ref, "axpbz", f32(1.0) - f32(decay_term),
                         -f32(coeff), 0.0, dist, d_leaves=d_leaves)

    def leaf_z(self, ref: StreamRef, leaf_index: int, like: torch.Tensor,
               dist: str = "gaussian") -> torch.Tensor:
        # sphere: the direction only — callers apply sqrt(d)/‖z‖
        self.check_dist(dist)
        return sample_leaf_z(fold_in(ref.key, leaf_index), like, dist)

    def perturb_leaf(self, p: torch.Tensor, ref: StreamRef, leaf_index: int,
                     scale, dist: str = "gaussian") -> torch.Tensor:
        self.check_dist(dist)
        return zo_affine_threefry(p, fold_in(ref.key, leaf_index), "xpbz",
                                  b=in_dtype(scale, p.dtype),
                                  dist="gaussian" if dist == "sphere"
                                  else dist, out=p)

    def perturb_many(self, params: PyTree, refs: Sequence[StreamRef], scale,
                     dist: str = "gaussian") -> PyTree:
        """θ + scale_j·z(ref_j) stacked on a new leading axis, each slice one
        X1 pass from θ into the stack — bitwise stacked ``perturb``
        singles (JAX vmaps them).  Unselected leaves ride along as
        broadcast views."""
        self.check_dist(dist)
        if not refs:
            raise ValueError("perturb_many needs at least one StreamRef")
        n = len(refs)
        mask = refs[0].selection_mask(params)
        blocks = refs[0].selection_blocks(params)
        per = per_stream_scales(scale, n)
        scales = [scale] * n if per is None else per
        sphs = ([self._sphere_scale(params, r) for r in refs]
                if dist == "sphere" else [None] * n)
        kdist = "gaussian" if dist == "sphere" else dist

        def one(i, p):
            if not _active(p, mask, i):
                return p.expand((n,) + tuple(p.shape))
            dt = p.dtype
            rb = _leaf_blocks(blocks, i)
            # a rows plan writes its bands only: the rest of each slice is θ
            out = (torch.empty((n,) + tuple(p.shape), dtype=dt,
                               device=p.device) if rb is None
                   else p.unsqueeze(0).repeat((n,) + (1,) * p.dim()))
            for j, r in enumerate(refs):
                zo_affine_threefry(
                    p, fold_in(r.key, i), "xpbz", 0.0,
                    in_dtype(scales[j], dt), 0.0,
                    None if sphs[j] is None else in_dtype(sphs[j], dt),
                    kdist, out=out[j],
                    bands=None if rb is None else rb.ranges())
            return out

        return tree_map_with_index(one, params)
