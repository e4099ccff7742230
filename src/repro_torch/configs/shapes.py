"""The assigned and the paper's arch id lists (as in
``repro.configs.shapes``; hymba-1.5b, whisper-large-v3,
granite-moe-3b-a800m and mixtral-8x7b are registered with the
other-families slice)."""

ASSIGNED_ARCHS = [
    "phi-3-vision-4.2b",
    "hymba-1.5b",
    "whisper-large-v3",
    "qwen2-0.5b",
    "yi-6b",
    "qwen2-7b",
    "nemotron-4-340b",
    "granite-moe-3b-a800m",
    "mixtral-8x7b",
    "rwkv6-3b",
]

PAPER_ARCHS = ["opt-13b", "opt-30b", "opt-66b", "roberta-large"]
