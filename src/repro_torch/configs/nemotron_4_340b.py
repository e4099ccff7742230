"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.  GQA, squared-ReLU (non-gated) FFN.  [arXiv:2402.16819; unverified]

The largest assigned cell: 340B parameters.  MeZO's memory story is most
dramatic here — the dry-run's memory_analysis shows the train step fitting in
inference-level HBM (no optimizer state, no activation stash).
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab_size=256000, activation="sq_relu", gated_ffn=False,
    norm="layernorm", rope_theta=10000.0, max_seq=32768, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=384,
    vocab_size=256, activation="sq_relu", gated_ffn=False,
    norm="layernorm", max_seq=128, dtype="float32",
)

register("nemotron-4-340b", CONFIG, SMOKE, notes="GQA kv=8, squared-ReLU")
