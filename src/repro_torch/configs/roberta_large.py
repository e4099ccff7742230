"""RoBERTa-large (355M) — the paper's medium masked LM (Figure 2, Table 18).
24L d_model=1024 16H d_ff=4096 vocab=50265, bidirectional (causal=False),
GELU, LayerNorm.  Used by the paper-claims quality benchmarks (prompt-based
classification with [MASK] label words, scaled down for CPU).
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="roberta-large", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=50265, causal=False, activation="gelu", gated_ffn=False,
    norm="layernorm", use_rope=False, max_seq=512, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="roberta-large-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, causal=False, activation="gelu", gated_ffn=False,
    norm="layernorm", use_rope=False, max_seq=128, dtype="float32",
)

register("roberta-large", CONFIG, SMOKE, notes="paper's masked LM; encoder-only")
