"""Models — the dense, moe and ssm families of ``repro.models``."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (FAMILY_ARCHS, OBJECTIVES, Arch,
                                         Bundle, all_archs, bundle, get,
                                         register)

__all__ = ["Arch", "Bundle", "FAMILY_ARCHS", "ModelConfig", "OBJECTIVES",
           "all_archs", "bundle", "get", "register"]
