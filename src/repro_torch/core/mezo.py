"""MeZO: memory-efficient ZO-SGD (paper Algorithm 1) — the port of
``repro.core.mezo``.

.. deprecated::
    ``MeZO`` is a thin shim over the composable API in
    :mod:`repro_torch.zo` — ``zo.mezo(lr=..., eps=...)`` builds the
    identical optimizer (bitwise-equal steps) as::

        ZOOptimizer(estimators.spsa(eps),
                    chain(clip_projected_grad?, scale_by_schedule(lr),
                          add_weight_decay(λ)))

    New code uses ``repro_torch.zo`` directly.

Usage (unchanged from JAX, save that the step writes θ in place):
    opt = MeZO(MeZOConfig(lr=1e-6, eps=1e-3))
    state = opt.init(0)
    step = opt.step_fn(loss_fn)
    params, state, metrics = step(params, state, batch)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import schedules
from repro_torch.perturb.xla import Distribution
from repro_torch.tree_utils import PyTree
from repro_torch.zo.base import ZOOptimizer, ZOState
from repro_torch.zo.presets import mezo as _mezo_preset
from repro_torch.zo.updates import apply_rank1

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class MeZOConfig:
    lr: float = 1e-6
    eps: float = 1e-3
    n: int = 1                          # n-SPSA samples per step
    dist: Distribution = "gaussian"
    weight_decay: float = 0.0
    estimator: str = "spsa"             # "spsa" | "one_point"
    lr_schedule: str = "constant"       # see core/schedules.py
    total_steps: int = 0                # required by decaying schedules
    warmup_steps: int = 0
    sequential_perturb: bool = True     # paper-faithful in-place chain
    clip_projected_grad: float = 0.0    # 0 = off; else |g| clamp (stability)

    def lr_at(self, step) -> np.float32:
        return schedules.lr_at(self.lr_schedule, self.lr, step,
                               self.total_steps, self.warmup_steps)


# Uniform optimizer state (deprecated alias — kept for old imports).
MeZOState = ZOState


class MeZO(ZOOptimizer):
    """Deprecated shim: ZO-SGD as the ``repro_torch.zo`` composition
    above."""

    def __init__(self, config: MeZOConfig):
        self.config = config
        composed = _mezo_preset(
            lr=config.lr, eps=config.eps, n=config.n, dist=config.dist,
            weight_decay=config.weight_decay, estimator=config.estimator,
            lr_schedule=config.lr_schedule, total_steps=config.total_steps,
            warmup_steps=config.warmup_steps,
            sequential_perturb=config.sequential_perturb,
            clip_projected_grad=config.clip_projected_grad)
        super().__init__(composed.estimator, composed.transform, name="mezo")

    def init(self, seed_or_params=0, *, seed: Optional[int] = None,
             params: Optional[PyTree] = None) -> ZOState:
        """Accepts both the legacy form ``init(seed)`` and the protocol form
        ``init(params, seed=...)`` (ints are seeds, trees are params)."""
        if seed is None and isinstance(seed_or_params, (int, np.integer)):
            return ZOOptimizer.init(self, params, seed=int(seed_or_params))
        if not isinstance(seed_or_params, (int, np.integer)):
            params = seed_or_params
        return ZOOptimizer.init(self, params, seed=int(seed or 0))


def apply_projected_update(params: PyTree, skey, projected_grad, lr,
                           weight_decay: float = 0.0,
                           dist: Distribution = "gaussian",
                           d_tree: Optional[PyTree] = None) -> PyTree:
    """θ ← (1 − η·λ)·θ − η·g·z(skey) (Algorithm 1's descent loop), in
    place through the default backend's ``apply_rank1`` with η·g and η·λ
    each one f32 product.  ``d_tree`` rescales z per leaf (Definitions
    6/7)."""
    lr = f32(lr)
    return apply_rank1(params, skey, lr * f32(projected_grad),
                       lr * f32(weight_decay), dist, d_tree=d_tree)
