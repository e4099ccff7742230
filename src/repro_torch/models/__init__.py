"""Models — the dense family of ``repro.models``."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (Arch, Bundle, all_archs, bundle, get,
                                         register)

__all__ = ["Arch", "Bundle", "ModelConfig", "all_archs", "bundle", "get",
           "register"]
