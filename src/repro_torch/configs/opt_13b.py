"""OPT-13B — the paper's main large autoregressive LM (Table 1).
40L d_model=5120 40H d_ff=20480 vocab=50272, ReLU FFN, LayerNorm.
(Positions: OPT uses learned absolute; we use RoPE — structural proxy,
noted in DESIGN.md §10.)
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="opt-13b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=20480,
    vocab_size=50272, activation="relu", gated_ffn=False, norm="layernorm",
    max_seq=2048, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="opt-13b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=256, activation="relu", gated_ffn=False, norm="layernorm",
    max_seq=128, dtype="float32",
)

register("opt-13b", CONFIG, SMOKE, notes="paper's model (Table 1)")
