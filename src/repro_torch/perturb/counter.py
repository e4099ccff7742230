"""The counter-hash backend — the port of ``repro.perturb.pallas``.

z for leaf ``i`` of stream ``ref`` is the K1 counter stream seeded by
``ref.leaf_seed(i)`` (``kernels/zo_fused``): the CUDA kernel on the card,
the plain torch version on the CPU, bitwise-equal to each other and to the
JAX ``pallas`` backend.  It therefore records the same stream id,
``pallas+z2``, and ledgers move between the two frameworks both ways.

Coefficients are formed as ``PallasBackend`` forms them (``_pin_scalars`` /
``apply_rank1``): every scalar a separately rounded f32 value.

Writes go IN PLACE into the caller's leaves (the paper's in-place trick):
each method returns the same tree it was given, updated.  Non-floating
leaves are left alone.  Parameter selections come with the selection
slice; a ``StreamRef`` carrying one is refused.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.zo_fused.kernel import zo_affine
from repro_torch.perturb.base import PerturbBackend
from repro_torch.perturb.stream import StreamRef, leaf_seed
from repro_torch.tree_utils import PyTree, is_floating, tree_map_with_index

f32 = np.float32


class CounterBackend(PerturbBackend):
    """Counter-hash z streams through K1."""

    name = "pallas"
    dists = frozenset({"gaussian", "rademacher"})
    stream_version = 2

    def _map(self, params: PyTree, ref: StreamRef, a, b, dist: str) -> PyTree:
        if ref.selection is not None:
            raise NotImplementedError(
                "parameter selections are ported with the selection slice; "
                "this backend updates the full tree only")
        seed = ref.counter_seed()
        a, b = float(f32(a)), float(f32(b))
        return tree_map_with_index(
            lambda i, p: zo_affine(p, leaf_seed(seed, i), a, b, dist, out=p)
            if is_floating(p) else p, params)

    def perturb(self, params: PyTree, ref: StreamRef, scale,
                dist: str = "gaussian") -> PyTree:
        self.check_dist(dist)
        return self._map(params, ref, f32(1.0), f32(scale), dist)

    def fused_restore_update(self, params_minus: PyTree, ref: StreamRef, eps,
                             lr_g, weight_decay=0.0,
                             dist: str = "gaussian") -> PyTree:
        # decay·(θ − εz + εz) − η·g·z = decay·θ_minus + (decay·ε − η·g)·z
        self.check_dist(dist)
        decay = f32(1.0) - f32(weight_decay)
        b = decay * f32(eps) - f32(lr_g)
        return self._map(params_minus, ref, decay, b, dist)

    def apply_rank1(self, params: PyTree, ref: StreamRef, coeff,
                    decay_term=0.0, dist: str = "gaussian") -> PyTree:
        self.check_dist(dist)
        return self._map(params, ref, f32(1.0) - f32(decay_term), -f32(coeff),
                         dist)
