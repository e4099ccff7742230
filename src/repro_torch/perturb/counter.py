"""The counter-hash backend — the port of ``repro.perturb.pallas``.

z for leaf ``i`` of stream ``ref`` is the counter stream seeded by
``ref.leaf_seed(i)`` (``kernels/zo_fused``): the CUDA kernels on the card,
their plain torch versions on the CPU, bitwise-equal to each other and to
the JAX ``pallas`` backend.  It therefore records the same stream id,
``pallas+z2``, and ledgers move between the two frameworks both ways.

Selection-aware, as ``PallasBackend`` is (``pallas.py:266-514``): a
``StreamRef`` carrying a ``repro_torch.select.Selection`` scopes every
method to the selected leaves — an unselected leaf gets no launch at all
(no z, no write, no decoupled decay) — and, under ``rows``, to the selected
row-blocks of each leaf.  A leaf whose row-blocks are all selected takes the
whole-leaf kernels (``_leaf_blocks``), which keeps ``rows(block=R, k=1)``
bitwise ≡ ``full``.

Which kernel serves which method (whole leaf | partial rows plan):

* ``perturb`` / ``fused_restore_update`` / ``apply_rank1`` → K1
  ``zo_affine`` | K7 ``zo_affine_rows``; ``leaf_z`` and ``perturb_leaf``
  → K1; ``apply_rank1`` along rescaled SPSA's D·z folds b = −coeff·d_i
  into K1's scalar per leaf;
* ``perturb_many`` with a shared scale → K5 ``zo_affine_batched``, with
  per-stream scales (spsa's ±ε pair) or ``sphere`` → K4 ``zo_affine_multi``
  | K8 ``zo_affine_multi_rows`` either way;
* ``affine_many`` → K3 ``zo_affine_chain`` | K9 ``zo_affine_chain_rows``;
* ``sphere``: pass 1, ‖z‖² of each selected leaf → K6 ``zo_sqnorm_many``
  (one call for all whole leaves) | K10 ``zo_sqnorm_rows_many`` (one call
  for all partial rows plans) with d counting the selected elements; pass
  2 folds sqrt(d)/‖z‖ into the affine b of the gaussian stream.

One deliberate difference from JAX: under a partial rows plan JAX's
``perturb_many`` stacks K7 singles instead of using its multi-rows kernel
(``pallas.py:444-459``), because XLA:CPU contracts the two graphs into FMAs
differently.  Here K7 and K8 share ``csrc/zo_stream.cuh``, so K8 ≡ stacked
K7 holds by construction, and ``perturb_many`` uses K8.

Every scalar is a separately rounded f32 formed in the order
``PallasBackend`` pins (``_pin_scalars``, ``pallas.py:250-263``): e.g.
a = 1 − decay, b = −coeff, then b·sph.  ``sph`` itself is
sqrt(f32(d) / Σ_leaves ‖z_leaf‖²), the per-leaf norms folded in leaf order
in f32 on the host.

Writes go IN PLACE into the caller's leaves (the paper's in-place trick):
each single-stream method and ``affine_many`` return the same tree they were
given, updated; ``perturb_many`` returns new stacked leaves and leaves θ
alone.  Non-floating and unselected leaves are left alone (in
``perturb_many`` they ride along as broadcast views).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import host_array
from repro_torch.kernels.zo_fused.kernel import zo_affine, zo_affine_batched
from repro_torch.kernels.zo_fused.multi import (zo_affine_chain,
                                                zo_affine_multi,
                                                zo_sqnorm_many)
from repro_torch.kernels.zo_fused.rows import (zo_affine_chain_rows,
                                               zo_affine_multi_rows,
                                               zo_affine_rows,
                                               zo_sqnorm_rows_many)
from repro_torch.perturb.base import (PerturbBackend, _check_many,
                                      per_stream_scales)
from repro_torch.perturb.stream import StreamRef, leaf_seed
from repro_torch.tree_utils import (PyTree, is_floating, tree_leaves,
                                    tree_map_with_index)

f32 = np.float32


def _leaf_blocks(blocks, i: int):
    """Leaf ``i``'s partial rows plan, or ``None`` for whole-leaf semantics
    (no ``rows`` selection, or every block of the leaf selected — the route
    that keeps ``rows(..., k=1)`` bitwise ≡ ``full``)."""
    if blocks is None:
        return None
    rb = blocks[i]
    if rb is None or rb.all_selected:
        return None
    return rb


def _active(p, mask, i: int) -> bool:
    return is_floating(p) and (mask is None or mask[i])


class CounterBackend(PerturbBackend):
    """Counter-hash z streams through the zo_fused kernels K1 and K3–K10."""

    name = "pallas"
    dists = frozenset({"gaussian", "rademacher", "sphere"})
    stream_version = 2

    def __init__(self, interpret: Optional[bool] = None):
        # JAX's ``PallasBackend(interpret=...)``: the port has no
        # interpreter, the plain torch versions run for CPU tensors
        if interpret:
            from repro_torch.perturb import INTERPRET_REFUSAL
            raise ValueError(INTERPRET_REFUSAL)
        self.interpret = False

    def _map(self, params: PyTree, ref: StreamRef, a, b, dist: str,
             b_leaves=None) -> PyTree:
        seed = ref.counter_seed()
        mask, blocks = ref.selection_mask(params), ref.selection_blocks(params)
        a, b_shared = float(f32(a)), float(f32(b))

        def one(i, p):
            if not _active(p, mask, i):
                return p
            b = float(b_leaves[i]) if b_leaves is not None else b_shared
            rb = _leaf_blocks(blocks, i)
            if rb is None:
                return zo_affine(p, leaf_seed(seed, i), a, b, dist, out=p)
            return zo_affine_rows(p, leaf_seed(seed, i), a, b,
                                  rb.block_elems, rb.k, rb.phase, dist, out=p)

        return tree_map_with_index(one, params)

    def _sphere_scale(self, params: PyTree, ref: StreamRef) -> np.float32:
        """sqrt(d)/‖z(ref)‖ over the selected floating leaves — pass 1 of
        the sphere rescale: one K6 call for every whole leaf and one K10
        call for every partial rows plan (d counting its selected
        elements) on the gaussian counter stream the affine kernels read,
        the norms folded in leaf order in f32."""
        seed = ref.counter_seed()
        mask, blocks = ref.selection_mask(params), ref.selection_blocks(params)
        d, device = 0, None
        whole, rows = [], []      # (slot in leaf order, n, leaf seed[, plan])
        for i, p in enumerate(tree_leaves(params)):
            if not _active(p, mask, i):
                continue
            rb = _leaf_blocks(blocks, i)
            leaf = (len(whole) + len(rows), p.numel(), leaf_seed(seed, i))
            device = p.device
            if rb is None:
                d += p.numel()
                whole.append(leaf)
            else:
                d += rb.selected_elems()
                rows.append(leaf + ((rb.block_elems, rb.k, rb.phase),))
        if not whole and not rows:
            raise ValueError(
                "sphere perturbation needs at least one selected floating "
                "leaf (the sqrt(d)/‖z‖ rescale is undefined on an empty "
                "subspace)")
        parts = [None] * (len(whole) + len(rows))
        if whole:
            slots, ns, seeds = zip(*whole)
            for slot, norm in zip(slots, zo_sqnorm_many(ns, seeds, "gaussian",
                                                        device)):
                parts[slot] = norm
        if rows:
            slots, ns, seeds, plans = zip(*rows)
            for slot, norm in zip(slots, zo_sqnorm_rows_many(
                    ns, seeds, plans, "gaussian", device)):
                parts[slot] = norm
        sq = None
        for part in host_array(torch.stack(parts)):
            sq = f32(part) if sq is None else f32(sq + f32(part))
        ratio = f32(f32(d) / sq)
        return f32(np.sqrt(ratio))

    def perturb(self, params: PyTree, ref: StreamRef, scale,
                dist: str = "gaussian") -> PyTree:
        self.check_dist(dist)
        if dist == "sphere":
            b = f32(f32(scale) * self._sphere_scale(params, ref))
            return self._map(params, ref, f32(1.0), b, "gaussian")
        return self._map(params, ref, f32(1.0), f32(scale), dist)

    def fused_restore_update(self, params_minus: PyTree, ref: StreamRef, eps,
                             lr_g, weight_decay=0.0,
                             dist: str = "gaussian") -> PyTree:
        # decay·(θ − εz + εz) − η·g·z = decay·θ_minus + (decay·ε − η·g)·z
        self.check_dist(dist)
        decay = f32(1.0) - f32(weight_decay)
        b = f32(decay * f32(eps)) - f32(lr_g)
        if dist == "sphere":
            b = f32(b * self._sphere_scale(params_minus, ref))
            dist = "gaussian"
        return self._map(params_minus, ref, decay, b, dist)

    def apply_rank1(self, params: PyTree, ref: StreamRef, coeff,
                    decay_term=0.0, dist: str = "gaussian",
                    d_tree: Optional[PyTree] = None) -> PyTree:
        # along D·z, b = −coeff·d_i folds into K1's scalar leaf by leaf, as
        # the pallas backend folds it (pallas.py:388)
        self.check_dist(dist)
        b = -f32(coeff)
        b_leaves = (None if d_tree is None else
                    [f32(b * f32(d)) for d in tree_leaves(d_tree)])
        if dist == "sphere":
            sph = self._sphere_scale(params, ref)
            b = f32(b * sph)
            if b_leaves is not None:
                b_leaves = [f32(bi * sph) for bi in b_leaves]
            dist = "gaussian"
        return self._map(params, ref, f32(1.0) - f32(decay_term), b, dist,
                         b_leaves)

    def perturb_leaf(self, p: torch.Tensor, ref: StreamRef, leaf_index: int,
                     scale, dist: str = "gaussian") -> torch.Tensor:
        self.check_dist(dist)
        return zo_affine(p, ref.leaf_seed(leaf_index), 1.0, float(f32(scale)),
                         "gaussian" if dist == "sphere" else dist, out=p)

    def leaf_z(self, ref: StreamRef, leaf_index: int, like: torch.Tensor,
               dist: str = "gaussian") -> torch.Tensor:
        # sphere: the direction only, as in JAX — callers apply sqrt(d)/‖z‖
        self.check_dist(dist)
        zeros = torch.zeros(like.shape, dtype=like.dtype if is_floating(like)
                            else torch.float32, device=like.device)
        return zo_affine(zeros, ref.leaf_seed(leaf_index), 0.0, 1.0,
                         "gaussian" if dist == "sphere" else dist, out=zeros)

    def perturb_many(self, params: PyTree, refs: Sequence[StreamRef], scale,
                     dist: str = "gaussian") -> PyTree:
        """Shared scale → K5 per leaf; per-stream scales or sphere → K4 per
        leaf (each stream's b_j = scale_j·sph_j); a partial rows plan → K8
        either way.  Bitwise-equal to stacked ``perturb`` singles."""
        self.check_dist(dist)
        if not refs:
            raise ValueError("perturb_many needs at least one StreamRef")
        n = len(refs)
        mask = refs[0].selection_mask(params)
        blocks = refs[0].selection_blocks(params)
        seeds0 = [r.counter_seed() for r in refs]
        per = per_stream_scales(scale, n)
        kdist = dist
        if dist == "sphere":
            base = [scale] * n if per is None else per
            per = [f32(f32(s) * self._sphere_scale(params, r))
                   for s, r in zip(base, refs)]
            kdist = "gaussian"
        b_list = ([float(f32(scale))] * n if per is None
                  else [float(f32(s)) for s in per])

        def one(i, p):
            if not _active(p, mask, i):
                return p.expand((n,) + tuple(p.shape))
            seeds = [leaf_seed(s, i) for s in seeds0]
            rb = _leaf_blocks(blocks, i)
            if rb is not None:
                return zo_affine_multi_rows(p, seeds, [1.0] * n, b_list,
                                            rb.block_elems, rb.k, rb.phase,
                                            kdist)
            if per is None:
                return zo_affine_batched(p, seeds, 1.0, float(f32(scale)),
                                         kdist)
            return zo_affine_multi(p, seeds, [1.0] * n, b_list, kdist)

        return tree_map_with_index(one, params)

    def affine_many(self, params: PyTree, refs: Sequence[StreamRef],
                    coeffs: Sequence, decay_terms: Sequence,
                    dist: str = "gaussian") -> PyTree:
        """K3 per leaf (K9 per partial rows plan), in place: the B streams
        folded in one read and one write of θ — bitwise the base class's
        sequential ``apply_rank1`` fold (the same f32 scalars; the kernels
        cast to the leaf dtype between streams).  The streams share the
        first ref's selection and phase (one step, one phase)."""
        self.check_dist(dist)
        _check_many(refs, coeffs, decay_terms)
        mask = refs[0].selection_mask(params)
        blocks = refs[0].selection_blocks(params)
        seeds0 = [r.counter_seed() for r in refs]
        a_list, b_list = [], []
        for ref, coeff, decay in zip(refs, coeffs, decay_terms):
            b = -f32(coeff)
            if dist == "sphere":
                # ‖z_j‖ depends on (seed_j, leaf sizes, selection) only,
                # never on θ
                b = f32(b * self._sphere_scale(params, ref))
            a_list.append(float(f32(1.0) - f32(decay)))
            b_list.append(float(b))
        kdist = "gaussian" if dist == "sphere" else dist

        def one(i, p):
            if not _active(p, mask, i):
                return p
            seeds = [leaf_seed(s, i) for s in seeds0]
            rb = _leaf_blocks(blocks, i)
            if rb is None:
                return zo_affine_chain(p, seeds, a_list, b_list, kdist, out=p)
            return zo_affine_chain_rows(p, seeds, a_list, b_list,
                                        rb.block_elems, rb.k, rb.phase,
                                        kdist, out=p)

        return tree_map_with_index(one, params)
