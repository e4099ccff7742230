"""Models — the five families of ``repro.models``: dense, moe, ssm, hybrid
and encdec."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (FAMILY_ARCHS, OBJECTIVES, Arch,
                                         Bundle, all_archs, bundle,
                                         family_arch, get, register)

__all__ = ["Arch", "Bundle", "FAMILY_ARCHS", "ModelConfig", "OBJECTIVES",
           "all_archs", "bundle", "family_arch", "get", "register"]
