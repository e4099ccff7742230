"""``repro_torch.zo`` — composable zeroth-order optimization (estimator ×
transforms behind one facade), the port of ``repro.zo``."""
from repro_torch.zo import estimators, transforms, updates
from repro_torch.zo.base import (Optimizer, TransformCtx, Updates,
                                 ZOEstimate, ZOEstimator, ZOLossFn,
                                 ZOOptimizer, ZOState, ZOTransform, chain,
                                 identity)
from repro_torch.zo.presets import (as_zo_optimizer, from_config, fzoo, mezo,
                                    mezo_adam, mezo_rescaled)
from repro_torch.zo.updates import apply_rank1, apply_rank1_batch

__all__ = ["Optimizer", "TransformCtx", "Updates", "ZOEstimate",
           "ZOEstimator", "ZOLossFn", "ZOOptimizer", "ZOState", "ZOTransform",
           "apply_rank1", "apply_rank1_batch", "as_zo_optimizer", "chain",
           "estimators", "from_config", "fzoo", "identity", "mezo",
           "mezo_adam", "mezo_rescaled", "transforms", "updates"]
