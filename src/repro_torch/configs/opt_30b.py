"""OPT-30B (paper Table 2): 48L d_model=7168 56H d_ff=28672 vocab=50272."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="opt-30b", family="dense",
    n_layers=48, d_model=7168, n_heads=56, n_kv_heads=56, d_ff=28672,
    vocab_size=50272, activation="relu", gated_ffn=False, norm="layernorm",
    max_seq=2048, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="opt-30b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=256, activation="relu", gated_ffn=False, norm="layernorm",
    max_seq=128, dtype="float32",
)

register("opt-30b", CONFIG, SMOKE, notes="paper's model (Table 2)")
