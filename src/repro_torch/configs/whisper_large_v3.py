"""whisper-large-v3 [audio] — enc-dec, 32L (each side) d_model=1280 20H
(MHA) d_ff=5120 vocab=51866, conv frontend stubbed (as in
``repro.configs.whisper_large_v3``): ``input_specs`` / ``make_batch``
provide precomputed frame embeddings (B, S_enc, 1280)
(``models/frontends.py``).
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, encoder_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866, cross_attention=True,
    activation="gelu", gated_ffn=False, norm="layernorm", use_rope=False,
    frontend="audio_stub", max_seq=32768, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="whisper-large-v3-smoke", family="encdec",
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, cross_attention=True,
    activation="gelu", gated_ffn=False, norm="layernorm", use_rope=False,
    frontend="audio_stub", max_seq=128, dtype="float32",
)

register("whisper-large-v3", CONFIG, SMOKE,
         notes="enc-dec; conv frontend stubbed; sinusoidal positions")
