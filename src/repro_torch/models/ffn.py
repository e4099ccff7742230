"""Dense feed-forward blocks (gated SwiGLU / GeGLU and plain two-matmul) —
the port of ``repro.models.ffn``."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init


def ffn_params(cfg, gen: torch.Generator, dtype, layers: int) -> dict:
    """FFN leaves stacked over ``layers`` on axis 0."""
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(gen, (layers, d, ff), dtype, fan_in=d),
         "w2": dense_init(gen, (layers, ff, d), dtype, fan_in=ff)}
    if cfg.gated_ffn:
        p["w3"] = dense_init(gen, (layers, d, ff), dtype, fan_in=d)
    return p


def ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w1"]
    if cfg.gated_ffn:
        h = activation(cfg.activation, h) * (x @ p["w3"])
    else:
        h = activation(cfg.activation, h)
    return h @ p["w2"]
