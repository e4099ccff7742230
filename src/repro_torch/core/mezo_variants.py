"""MeZO variants from paper Appendix B.3/B.4 — the port of
``repro.core.mezo_variants``: variance- and expectation-modified SPSA with
a block-diagonal rescaling D (one scalar per leaf).

.. deprecated::
    ``MeZOVariant`` is a thin shim over the composable API —
    ``zo.mezo_rescaled`` builds the identical optimizer as::

        ZOOptimizer(estimators.rescaled_spsa(eps, d_source, ...),
                    chain(clip?, scale_by_schedule(lr), add_weight_decay(λ)))

* D = parameter norms  -> layerwise-adaptive-style rescaling (Table 9).
* D = gradient norms   -> control-variate rescaling, the norms estimated
  with Proposition 1's ZO probe (no backprop) (Table 8).
* ``modify_expectation=True`` multiplies the update by z (not D·z): the
  biased normalized-gradient estimate of Definition 7 (Table 10).

``d_refresh_every`` is inert, as in JAX: D is computed once, at ``init``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.mezo import MeZOConfig
from repro_torch.tree_utils import PyTree
from repro_torch.zo.base import ZOOptimizer, ZOState
from repro_torch.zo.presets import mezo_rescaled as _mezo_rescaled_preset


@dataclasses.dataclass(frozen=True)
class MeZOVariantConfig(MeZOConfig):
    d_source: str = "param_norm"        # param_norm | grad_norm_zo | ones
    modify_expectation: bool = False    # Definition 7 vs Definition 6
    d_refresh_every: int = 0            # inert (JAX: D computed at init)
    d_probe_eps: float = 1e-4


# Deprecated alias: the D-tree lives in the estimator carry of ``ZOState``.
MeZOVariantState = ZOState


class MeZOVariant(ZOOptimizer):
    """Definition 6/7 optimizer: perturb by ε·(d⁻¹ ⊙ z), update along
    (D or I)·z with the same regenerated z.  Deprecated shim over
    ``zo.mezo_rescaled``."""

    def __init__(self, config: MeZOVariantConfig):
        self.config = config
        composed = self._compose(None, None)
        super().__init__(composed.estimator, composed.transform,
                         name="mezo_rescaled")

    def _compose(self, probe_loss_fn, probe_batch) -> ZOOptimizer:
        c = self.config
        return _mezo_rescaled_preset(
            lr=c.lr, eps=c.eps, dist=c.dist, d_source=c.d_source,
            modify_expectation=c.modify_expectation,
            probe_loss_fn=probe_loss_fn, probe_batch=probe_batch,
            probe_eps=c.d_probe_eps, weight_decay=c.weight_decay,
            lr_schedule=c.lr_schedule, total_steps=c.total_steps,
            warmup_steps=c.warmup_steps,
            clip_projected_grad=c.clip_projected_grad)

    def init(self, params: PyTree, loss_fn: Optional[Callable] = None,
             batch=None, *, seed: int = 0) -> ZOState:
        """Legacy signature: ``d_source='grad_norm_zo'`` estimates D with
        Proposition-1 probes, which need the loss and a batch at init time
        (the composable API passes them to the estimator factory,
        ``zo.estimators.rescaled_spsa(probe_loss_fn=..., probe_batch=...)``)."""
        if self.config.d_source == "grad_norm_zo":
            if loss_fn is None or batch is None:
                raise ValueError("d_source='grad_norm_zo' estimates D with "
                                 "ZO probes at init: pass loss_fn and batch")
            self.estimator = self._compose(loss_fn, batch).estimator
        return ZOOptimizer.init(self, params, seed=seed)
