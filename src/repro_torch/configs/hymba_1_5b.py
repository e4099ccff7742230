"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer
(as in ``repro.configs.hymba_1_5b``).  Attention is sliding-window (2048),
so the KV cache is a ring bounded by the window and the SSM state is O(1).
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, ssm_state=16, ssm_heads=25, sliding_window=2048,
    activation="silu", gated_ffn=True, norm="rmsnorm",
    rope_theta=10000.0, max_seq=1_048_576, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, ssm_state=4, ssm_heads=4, sliding_window=16,
    activation="silu", gated_ffn=True, norm="rmsnorm",
    max_seq=128, dtype="float32",
)

register("hymba-1.5b", CONFIG, SMOKE,
         notes="parallel attn+mamba heads; SWA 2048 -> long_500k eligible")
