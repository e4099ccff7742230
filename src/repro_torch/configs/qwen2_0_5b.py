"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
GQA with QKV bias, untied head (as in ``repro.configs.qwen2_0_5b``)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, qkv_bias=True, activation="silu", gated_ffn=True,
    norm="rmsnorm", rope_theta=1_000_000.0, max_seq=32768, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, qkv_bias=True, activation="silu", gated_ffn=True,
    norm="rmsnorm", max_seq=128, dtype="float32",
)

register("qwen2-0.5b", CONFIG, SMOKE, notes="GQA kv=2, QKV bias")
