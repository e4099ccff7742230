"""``repro_torch.zo`` — the ZO optimizer facade (replay side, so far)."""
from repro_torch.zo.base import ZOEstimator, ZOOptimizer
from repro_torch.zo.presets import as_zo_optimizer, mezo

__all__ = ["ZOEstimator", "ZOOptimizer", "as_zo_optimizer", "mezo"]
