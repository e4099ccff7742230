"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 (as in
``repro.configs.granite_moe_3b_a800m``, which takes the shape spec's 40
experts)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, n_experts=40, top_k=8,
    activation="silu", gated_ffn=True, norm="rmsnorm",
    rope_theta=10000.0, max_seq=32768, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="granite-moe-3b-a800m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, n_experts=5, top_k=2, moe_group_size=32,
    activation="silu", gated_ffn=True, norm="rmsnorm",
    max_seq=128, dtype="float32",
)

register("granite-moe-3b-a800m", CONFIG, SMOKE, notes="40 experts top-8")
