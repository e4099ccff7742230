"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention 4096 (as in
``repro.configs.mixtral_8x7b``)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, n_experts=8, top_k=2, sliding_window=4096,
    activation="silu", gated_ffn=True, norm="rmsnorm",
    rope_theta=1_000_000.0, max_seq=32768, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, n_experts=4, top_k=2, sliding_window=32,
    moe_group_size=32, activation="silu", gated_ffn=True, norm="rmsnorm",
    max_seq=128, dtype="float32",
)

register("mixtral-8x7b", CONFIG, SMOKE, notes="8 experts top-2, SWA 4096")
