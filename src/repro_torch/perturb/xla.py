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
Writes go in place; unselected and non-floating leaves are left alone.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.threefry.kernel import zo_affine_threefry
from repro_torch.perturb.base import PerturbBackend, per_stream_scales
from repro_torch.perturb.counter import _active, _leaf_blocks
from repro_torch.perturb.stream import StreamRef, fold_in
from repro_torch.tree_utils import (PyTree, is_floating, tree_leaves,
                                    tree_map_with_index)

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


class XLABackend(PerturbBackend):
    """Threefry z streams through X1, all distributions."""

    name = "xla"
    dists = frozenset({"gaussian", "rademacher", "sphere"})

    def _sphere_scale(self, params: PyTree, ref: StreamRef) -> np.float32:
        """sqrt(d)/‖z(ref)‖ over the selected floating leaves (d and ‖z‖
        counting selected row bands only under a rows plan); ‖z‖² summed
        leaf by leaf in f32, as ``_sphere_scale`` does."""
        mask, blocks = ref.selection_mask(params), ref.selection_blocks(params)
        d, sq = 0, f32(0.0)
        for i, p in enumerate(tree_leaves(params)):
            if not _active(p, mask, i):
                continue
            rb = _leaf_blocks(blocks, i)
            d += p.numel() if rb is None else rb.selected_elems()
            sq = f32(sq + leaf_sqnorm(p, fold_in(ref.key, i),
                                      None if rb is None else rb.ranges()))
        if d == 0:
            raise ValueError(
                "sphere perturbation needs at least one selected floating "
                "leaf (the sqrt(d)/‖z‖ rescale is undefined on an empty "
                "subspace)")
        return f32(np.sqrt(f32(f32(d) / sq)))

    def _map(self, params: PyTree, ref: StreamRef, form: str, a, b, e, dist,
             zs=None, d_leaves=None) -> PyTree:
        mask, blocks = ref.selection_mask(params), ref.selection_blocks(params)
        kdist = "gaussian" if dist == "sphere" else dist

        def one(i, p):
            if not _active(p, mask, i):
                return p
            dt = p.dtype
            z_scale = zs if d_leaves is None else d_leaves[i]
            rb = _leaf_blocks(blocks, i)
            return zo_affine_threefry(
                p, fold_in(ref.key, i), form, in_dtype(a, dt),
                in_dtype(b, dt), in_dtype(e, dt),
                None if z_scale is None else in_dtype(z_scale, dt), kdist,
                out=p, bands=None if rb is None else rb.ranges())

        return tree_map_with_index(one, params)

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
        out = torch.empty(like.shape, dtype=like.dtype if is_floating(like)
                          else torch.float32, device=like.device)
        return zo_affine_threefry(None, fold_in(ref.key, leaf_index), "z",
                                  dist="gaussian" if dist == "sphere"
                                  else dist, out=out)

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
