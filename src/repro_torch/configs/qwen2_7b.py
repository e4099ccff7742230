"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
GQA, QKV bias.  [arXiv:2407.10671; hf]
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab_size=152064, qkv_bias=True, activation="silu", gated_ffn=True,
    norm="rmsnorm", rope_theta=1_000_000.0, max_seq=32768, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab_size=256, qkv_bias=True, activation="silu", gated_ffn=True,
    norm="rmsnorm", max_seq=128, dtype="float32",
)

register("qwen2-7b", CONFIG, SMOKE, notes="GQA kv=4, QKV bias")
