"""``repro_torch.data`` — step-indexed synthetic data (the ``lm`` kind)."""
from repro_torch.data.pipeline import DataSpec, Pipeline
from repro_torch.data.synthetic import lm_batch, plant_structure

__all__ = ["DataSpec", "Pipeline", "lm_batch", "plant_structure"]
