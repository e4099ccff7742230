"""``repro_torch.data`` — step-indexed synthetic data: the ``lm`` stream,
prompt-based classification and span extraction."""
from repro_torch.data.pipeline import DataSpec, Pipeline
from repro_torch.data.synthetic import (PromptClassification, SpanExtraction,
                                        lm_batch, plant_structure)

__all__ = ["DataSpec", "Pipeline", "PromptClassification", "SpanExtraction",
           "lm_batch", "plant_structure"]
