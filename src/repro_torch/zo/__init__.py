"""``repro_torch.zo`` — composable zeroth-order optimization (estimator ×
transforms behind one facade), the port of ``repro.zo``."""
from repro_torch.zo import estimators, transforms, updates
from repro_torch.zo.base import (TransformCtx, Updates, ZOEstimate,
                                 ZOEstimator, ZOOptimizer, ZOState,
                                 ZOTransform, chain, identity)
from repro_torch.zo.presets import (as_zo_optimizer, fzoo, mezo, mezo_adam,
                                    mezo_rescaled)

__all__ = ["TransformCtx", "Updates", "ZOEstimate", "ZOEstimator",
           "ZOOptimizer", "ZOState", "ZOTransform", "as_zo_optimizer",
           "chain", "estimators", "fzoo", "identity", "mezo", "mezo_adam",
           "mezo_rescaled", "transforms", "updates"]
