"""Named compositions — the port of ``repro.zo.presets``: ``mezo``, the
single-stream spsa recipe, as ledger replay needs it."""
from __future__ import annotations

from repro_torch.zo.base import ZOEstimator, ZOOptimizer


def mezo(lr: float = 1e-6, eps: float = 1e-3, dist: str = "gaussian",
         weight_decay: float = 0.0, backend=None) -> ZOOptimizer:
    """ZO-SGD with in-place seed-replay perturbations (paper Algorithm 1):
    spsa(eps) under an η-schedule and decoupled weight decay λ.  A ledger
    records η per step, so replay reads only ``weight_decay`` and the
    backend's stream; ``backend`` defaults to the counter stream
    (``"pallas"``), the one the port has so far."""
    est = ZOEstimator(eps=eps, dist=dist, name="spsa", backend=backend)
    return ZOOptimizer(est, {"lr": lr, "weight_decay": weight_decay},
                       name="mezo")


def as_zo_optimizer(optimizer) -> ZOOptimizer:
    if callable(getattr(optimizer, "replay_update", None)):
        return optimizer
    raise TypeError(f"{type(optimizer).__name__} is not a ZO optimizer "
                    "(legacy config objects are ported with the training "
                    "slice)")
