"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (kv=32, MHA) d_ff=8192
vocab=32064.  phi3-mini backbone + CLIP vision tower.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The vision frontend is a STUB per the assignment: input_specs() provides the
merged text+patch embedding sequence (B, S, 3072) directly
(models/frontends.py documents what the CLIP tower + projector would emit).
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32064, activation="silu", gated_ffn=True, norm="rmsnorm",
    rope_theta=10000.0, frontend="vision_stub", max_seq=131072,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, activation="silu", gated_ffn=True, norm="rmsnorm",
    frontend="vision_stub", max_seq=128, dtype="float32",
)

register("phi-3-vision-4.2b", CONFIG, SMOKE,
         notes="VLM backbone; patch embeddings stubbed")
