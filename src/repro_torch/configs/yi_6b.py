"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-architecture GQA.  [arXiv:2403.04652; hf]
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64000, activation="silu", gated_ffn=True, norm="rmsnorm",
    rope_theta=5_000_000.0, max_seq=32768, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="yi-6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=256, activation="silu", gated_ffn=True, norm="rmsnorm",
    max_seq=128, dtype="float32",
)

register("yi-6b", CONFIG, SMOKE, notes="llama-arch GQA kv=4")
