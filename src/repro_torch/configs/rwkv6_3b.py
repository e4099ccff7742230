"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
RWKV-6 "Finch": data-dependent decay (as in ``repro.configs.rwkv6_3b``).

Head layout: 40 heads x head_dim 64; ``scan_chunk`` 16 is K11's envelope.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, head_dim=64, d_ff=8960,
    vocab_size=65536, use_rope=False, norm="rmsnorm", scan_chunk=16,
    max_seq=1_048_576, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128,
    vocab_size=256, use_rope=False, norm="rmsnorm", scan_chunk=16,
    max_seq=128, dtype="float32",
)

register("rwkv6-3b", CONFIG, SMOKE, notes="Finch data-dependent decay; attn-free")
