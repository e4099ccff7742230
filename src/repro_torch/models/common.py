"""Shared model building blocks — the port of ``repro.models.common``:
norms, activations, RoPE, sinusoidal positions, and initializers that draw
from a ``torch.Generator``.  The JAX package's activation-sharding hooks
have no counterpart here (one device)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: dict) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_params(cfg, d: int, dtype, device, layers: Optional[int] = None) -> dict:
    """Norm leaves, stacked over ``layers`` on axis 0 when given."""
    shape = (d,) if layers is None else (layers, d)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------------------- #
# Activations
# --------------------------------------------------------------------------- #
def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":            # jax.nn.gelu defaults to the tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "sq_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name!r}")


# --------------------------------------------------------------------------- #
# RoPE / positions
# --------------------------------------------------------------------------- #
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> f32 cos/sin (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_at(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Sinusoidal rows for arbitrary positions: (S,) -> (S, d)."""
    dim = torch.arange(d // 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    ang = positions.to(torch.float32)[:, None] / torch.pow(
        torch.tensor(10000.0, device=positions.device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------- #
# Initializers (torch.Generator; JAX's threefry normals are not reproduced —
# parity tests hand both sides the same weights through repro_torch.convert)
# --------------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape: tuple, dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in f32, stored in ``dtype``.  ``fan_in``
    defaults to ``shape[0]``; a leaf stacked over layers passes its own.

    The leaf is allocated once in ``dtype``; a 3-D leaf (stacked over
    layers on axis 0) is filled one layer at a time, so the f32 draw held
    at once is one layer's slice — OPT-30b's (48, 7168, 28672) ``w1`` would
    need 79 GB of f32 temporaries drawn whole (a 4-D moe expert leaf
    (L, E, d, ff) likewise, one layer's experts at a time)."""
    fan_in = fan_in or shape[0]
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for part in (out if len(shape) >= 3 else out[None]):
        _fill_normal(gen, part, 1.0 / math.sqrt(fan_in))
    return out


def embed_init(gen: torch.Generator, shape: tuple, dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    _fill_normal(gen, out, 0.02)
    return out


def _fill_normal(gen: torch.Generator, part: torch.Tensor,
                 scale: float) -> None:
    """part ← N(0, scale²): an f32 draw of part's shape, scaled in place,
    copied (cast) into ``part``."""
    w = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    part.copy_(w.mul_(scale))
