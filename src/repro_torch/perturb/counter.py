"""The counter-hash backend — the port of ``repro.perturb.pallas``.

z for leaf ``i`` of stream ``ref`` is the counter stream seeded by
``ref.leaf_seed(i)`` (``kernels/zo_fused``): the CUDA kernels on the card,
their plain torch versions on the CPU, bitwise-equal to each other and to
the JAX ``pallas`` backend.  It therefore records the same stream id,
``pallas+z2``, and ledgers move between the two frameworks both ways.

Which kernel serves which method:

* ``perturb`` / ``fused_restore_update`` / ``apply_rank1`` / ``leaf_z`` →
  K1 ``zo_affine``;
* ``perturb_many`` with a shared scale → K5 ``zo_affine_batched``; with
  per-stream scales (spsa's ±ε pair) or ``sphere`` → K4 ``zo_affine_multi``;
* ``affine_many`` → K3 ``zo_affine_chain``;
* ``sphere``: pass 1, ‖z‖² of each leaf → K6 ``zo_sqnorm``; pass 2 folds
  sqrt(d)/‖z‖ into the affine b of the gaussian stream.

Every scalar is a separately rounded f32 formed in the order
``PallasBackend`` pins (``_pin_scalars``, ``pallas.py:250-263``): e.g.
a = 1 − decay, b = −coeff, then b·sph.  ``sph`` itself is
sqrt(f32(d) / Σ_leaves ‖z_leaf‖²), the per-leaf norms folded in leaf order
in f32 on the host.

Writes go IN PLACE into the caller's leaves (the paper's in-place trick):
each single-stream method and ``affine_many`` return the same tree they were
given, updated; ``perturb_many`` returns new stacked leaves and leaves θ
alone.  Non-floating leaves are left alone (in ``perturb_many`` they ride
along as broadcast views).  Parameter selections come with the selection
slice; a ``StreamRef`` carrying one is refused.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.zo_fused.kernel import zo_affine, zo_affine_batched
from repro_torch.kernels.zo_fused.multi import (zo_affine_chain,
                                                zo_affine_multi, zo_sqnorm)
from repro_torch.perturb.base import (PerturbBackend, _check_many,
                                      per_stream_scales)
from repro_torch.perturb.stream import StreamRef, leaf_seed
from repro_torch.tree_utils import (PyTree, is_floating, tree_leaves,
                                    tree_map_with_index)

f32 = np.float32


def _full_tree(ref: StreamRef) -> None:
    if ref.selection is not None:
        raise NotImplementedError(
            "parameter selections are ported with the selection slice; "
            "this backend updates the full tree only")


class CounterBackend(PerturbBackend):
    """Counter-hash z streams through the zo_fused kernels K1, K3–K6."""

    name = "pallas"
    dists = frozenset({"gaussian", "rademacher", "sphere"})
    stream_version = 2

    def _map(self, params: PyTree, ref: StreamRef, a, b, dist: str) -> PyTree:
        _full_tree(ref)
        seed = ref.counter_seed()
        a, b = float(f32(a)), float(f32(b))
        return tree_map_with_index(
            lambda i, p: zo_affine(p, leaf_seed(seed, i), a, b, dist, out=p)
            if is_floating(p) else p, params)

    def _sphere_scale(self, params: PyTree, ref: StreamRef) -> np.float32:
        """sqrt(d)/‖z(ref)‖ over the floating leaves — pass 1 of the sphere
        rescale: one K6 per leaf on the gaussian counter stream the affine
        kernels read, the leaf norms folded in leaf order in f32."""
        _full_tree(ref)
        seed = ref.counter_seed()
        d, parts = 0, []
        for i, p in enumerate(tree_leaves(params)):
            if not is_floating(p):
                continue
            d += p.numel()
            parts.append(zo_sqnorm(p.numel(), leaf_seed(seed, i), "gaussian",
                                   p.device))
        if not parts:
            raise ValueError(
                "sphere perturbation needs at least one floating leaf (the "
                "sqrt(d)/‖z‖ rescale is undefined on an empty subspace)")
        sq = None
        for part in torch.stack(parts).cpu().numpy():
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
        self.check_dist(dist)
        if d_tree is not None:
            raise NotImplementedError(
                "apply_rank1 along D·z (rescaled_spsa's d_tree) is ported "
                "with rescaled_spsa, a later slice")
        b = -f32(coeff)
        if dist == "sphere":
            b = f32(b * self._sphere_scale(params, ref))
            dist = "gaussian"
        return self._map(params, ref, f32(1.0) - f32(decay_term), b, dist)

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
        leaf (each stream's b_j = scale_j·sph_j).  Bitwise-equal to stacked
        ``perturb`` singles."""
        self.check_dist(dist)
        if not refs:
            raise ValueError("perturb_many needs at least one StreamRef")
        for r in refs:
            _full_tree(r)
        n = len(refs)
        seeds0 = [r.counter_seed() for r in refs]
        per = per_stream_scales(scale, n)
        kdist = dist
        if dist == "sphere":
            base = [scale] * n if per is None else per
            per = [f32(f32(s) * self._sphere_scale(params, r))
                   for s, r in zip(base, refs)]
            kdist = "gaussian"

        def one(i, p):
            if not is_floating(p):
                return p.expand((n,) + tuple(p.shape))
            seeds = [leaf_seed(s, i) for s in seeds0]
            if per is None:
                return zo_affine_batched(p, seeds, 1.0, float(f32(scale)),
                                         kdist)
            return zo_affine_multi(p, seeds, [1.0] * n,
                                   [float(f32(s)) for s in per], kdist)

        return tree_map_with_index(one, params)

    def affine_many(self, params: PyTree, refs: Sequence[StreamRef],
                    coeffs: Sequence, decay_terms: Sequence,
                    dist: str = "gaussian") -> PyTree:
        """K3 per leaf, in place: the B streams folded in one read and one
        write of θ — bitwise the base class's sequential ``apply_rank1``
        fold (the same f32 scalars; K3 casts to the leaf dtype between
        streams)."""
        self.check_dist(dist)
        _check_many(refs, coeffs, decay_terms)
        for r in refs:
            _full_tree(r)
        seeds0 = [r.counter_seed() for r in refs]
        a_list, b_list = [], []
        for ref, coeff, decay in zip(refs, coeffs, decay_terms):
            b = -f32(coeff)
            if dist == "sphere":
                # ‖z_j‖ depends on (seed_j, leaf sizes) only, never on θ
                b = f32(b * self._sphere_scale(params, ref))
            a_list.append(float(f32(1.0) - f32(decay)))
            b_list.append(float(b))
        kdist = "gaussian" if dist == "sphere" else dist
        return tree_map_with_index(
            lambda i, p: zo_affine_chain(
                p, [leaf_seed(s, i) for s in seeds0], a_list, b_list, kdist,
                out=p) if is_floating(p) else p, params)
