"""Models — the five families of ``repro.models``: dense, moe, ssm, hybrid
and encdec."""
from repro_torch.models.config import (ALL_CELLS, DECODE_32K, LONG_500K,
                                       PREFILL_32K, TRAIN_4K, ModelConfig,
                                       ShapeCell, cells_for)
from repro_torch.models.registry import (FAMILY_ARCHS, OBJECTIVES, Arch,
                                         Bundle, all_archs, bundle,
                                         default_selection, family_arch, get,
                                         register)

__all__ = ["ALL_CELLS", "Arch", "Bundle", "DECODE_32K", "FAMILY_ARCHS",
           "LONG_500K", "ModelConfig", "OBJECTIVES", "PREFILL_32K",
           "ShapeCell", "TRAIN_4K", "all_archs", "bundle", "cells_for",
           "default_selection", "family_arch", "get", "register"]
