"""MeZO-Adam / MeZO-momentum (paper §2.2 + Appendix B.2) — the port of
``repro.core.mezo_adam``.

.. deprecated::
    ``MeZOAdam`` is a thin shim over the composable API —
    ``zo.mezo_adam`` builds the identical optimizer (bitwise-equal steps)
    as::

        ZOOptimizer(estimators.spsa(eps),
                    chain(clip_projected_grad?, scale_by_schedule(lr),
                          scale_by_zo_adam(β1, β2, materialized, window)))

The SPSA gradient at step τ is the rank-1 tensor g_τ·z_τ with z_τ a pure
function of (base_key, τ), so any moving average of gradients is a function
of the scalar history {g_τ}: ``materialized=False`` keeps a ring buffer of
``window`` scalars and recomputes m and v leaf by leaf;
``materialized=True`` stores them as full trees (the oracle).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.mezo import MeZOConfig
from repro_torch.tree_utils import PyTree
from repro_torch.zo.base import ZOOptimizer, ZOState
from repro_torch.zo.presets import mezo_adam as _mezo_adam_preset


@dataclasses.dataclass(frozen=True)
class MeZOAdamConfig(MeZOConfig):
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    materialized: bool = False
    window: int = 32                # ring-buffer length for recomputed mode
    momentum_only: bool = False     # True -> SGD+momentum


# Deprecated alias: the g-history ring buffer and m/v trees live inside the
# uniform ``ZOState``'s transform carry.
MeZOAdamState = ZOState


class MeZOAdam(ZOOptimizer):
    """Deprecated shim: ZO-Adam as the ``repro_torch.zo`` composition
    above."""

    def __init__(self, config: MeZOAdamConfig):
        self.config = config
        composed = _mezo_adam_preset(
            lr=config.lr, eps=config.eps, beta1=config.beta1,
            beta2=config.beta2, adam_eps=config.adam_eps,
            materialized=config.materialized, window=config.window,
            momentum_only=config.momentum_only, dist=config.dist,
            weight_decay=config.weight_decay, lr_schedule=config.lr_schedule,
            total_steps=config.total_steps, warmup_steps=config.warmup_steps,
            clip_projected_grad=config.clip_projected_grad)
        super().__init__(composed.estimator, composed.transform,
                         name="mezo_adam")

    def init(self, params: Optional[PyTree] = None, seed: int = 0) -> ZOState:
        # legacy positional order preserved: init(params, seed)
        return ZOOptimizer.init(self, params, seed=seed)
