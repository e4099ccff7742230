"""Shared model building blocks — the port of ``repro.models.common``:
norms, activations, RoPE, sinusoidal positions, initializers that draw
from a ``torch.Generator``, and the activation-sharding hook used by the
distributed layer."""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# Activation-sharding context: models call shard_hint(x, logical_name) at
# JAX's points; the distributed layer installs a resolver mapping
# (logical, shape) to a spec.  Without a resolver this is the identity, so
# model code never imports mesh machinery.
# --------------------------------------------------------------------------- #
_tls = threading.local()


def set_shard_resolver(fn: Optional[Callable[[str, tuple], object]]) -> None:
    _tls.resolver = fn


@contextlib.contextmanager
def shard_resolver(fn):
    prev = getattr(_tls, "resolver", None)
    _tls.resolver = fn
    try:
        yield
    finally:
        _tls.resolver = prev


def shard_hint(x: torch.Tensor, logical: str) -> torch.Tensor:
    """Annotate an activation with a logical sharding name: the resolver
    (``repro_torch.distributed.make_activation_resolver``) is called as
    ``fn(logical, tuple(x.shape))``.  Where it returns a spec (a
    ``PartitionSpec``, which gives its own ``placements(mesh)``) and ``x``
    is a ``DTensor``, ``x`` is redistributed to those placements on its
    mesh; a plain tensor passes through unchanged (as JAX's
    ``with_sharding_constraint`` changes nothing on one device)."""
    fn = getattr(_tls, "resolver", None)
    if fn is None:
        return x
    spec = fn(logical, tuple(x.shape))
    if spec is None or not hasattr(x, "redistribute"):
        return x
    return x.redistribute(x.device_mesh, spec.placements(x.device_mesh))


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``.  A DTensor (a dry run's trace) whose sharding
    the reshape cannot keep — a sharded dim split or merged unevenly, such
    as 14 heads over a model axis of 16, or merged with a sharded dim
    inside — is first gathered on the mesh dims that shard the reshaped
    dims, as a compiler reshards there; a plain tensor reshapes as it
    is."""
    if not hasattr(x, "placements"):
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        pass                     # DTensor's view rule refused the sharding
    from torch.distributed.tensor import Replicate
    keep = 0
    while keep < min(x.dim(), len(shape)) and x.shape[keep] == shape[keep]:
        keep += 1
    pl = [Replicate() if p.is_shard() and p.dim >= keep else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl).reshape(*shape)


def placed_like(ref: torch.Tensor, tree):
    """``tree`` — plain tensors made inside a step, a prefill's fresh cache
    or state — as DTensors replicated on ``ref``'s mesh when ``ref`` is a
    DTensor (a dry run's trace: an in-place write of DTensor values needs
    a DTensor target); else ``tree`` as it is."""
    if not hasattr(ref, "placements"):
        return tree
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.tree_utils import tree_map
    mesh = ref.device_mesh
    return tree_map(lambda t: DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False), tree)


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


def sinusoidal_embedding(seq: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal positions (S, d), computed in
    float64 numpy and cast, as JAX builds them."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


def sinusoidal_at(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Sinusoidal rows for arbitrary positions: (S,) -> (S, d)."""
    dim = torch.arange(d // 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    ang = positions.to(torch.float32)[:, None] / torch.pow(
        torch.tensor(10000.0, device=positions.device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------- #
# Initializers (torch.Generator; JAX's threefry normals are reproduced only
# by ``dense_init_key`` — parity tests hand both sides the same weights
# through repro_torch.convert)
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


def dense_init_key(key, shape: tuple, dtype, device,
                   fan_in: Optional[int] = None) -> torch.Tensor:
    """JAX's ``dense_init(key, shape, dtype)`` bit for bit: the f32
    ``jax.random.normal(key, shape)`` of a threefry key (``perturb.stream``'s
    ``prng_key`` / ``fold_in``) in the layout in force, times 1/√fan_in
    rounded to f32 (JAX's float64 scalar, canonicalized), cast to
    ``dtype``.  Drawn whole on ``device``: for small leaves (the LoRA
    factors a tenant's ledger seeds)."""
    from repro_torch.kernels.threefry.kernel import normal_f32, random_bits
    from repro_torch.perturb.stream import partitionable
    fan_in = fan_in or shape[0]
    n = math.prod(shape)
    bits = random_bits(key, torch.arange(n, dtype=torch.int64, device=device),
                       n, 32, partitionable())
    std = float(np.float32(1.0 / np.sqrt(fan_in)))
    return (normal_f32(bits) * std).reshape(shape).to(dtype)


def embed_init(gen: torch.Generator, shape: tuple, dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    _fill_normal(gen, out, 0.02)
    return out


def _fill_normal(gen: torch.Generator, part: torch.Tensor,
                 scale: float) -> None:
    """part ← N(0, scale²): an f32 draw of part's shape, scaled in place,
    copied (cast) into ``part``.  A ``meta`` leaf holds no values: nothing
    is drawn (``Bundle.param_shapes``)."""
    if part.is_meta:
        return
    w = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    part.copy_(w.mul_(scale))


class MetaGen:
    """The stand-in for a ``torch.Generator`` that ``Bundle.param_shapes``
    hands the init code: leaves land on the ``meta`` device and no draw is
    made (``torch.Generator(device="meta")`` does not exist)."""

    device = torch.device("meta")


class KeyGen:
    """Deterministic named key dispenser for param init: the n-th call
    returns ``fold_in(key, n)`` (n from 1) over the port's threefry keys
    (``perturb.stream``'s ``prng_key`` / ``fold_in``), JAX's key words."""

    def __init__(self, key):
        self._key = key
        self._n = 0

    def __call__(self):
        from repro_torch.perturb.stream import fold_in
        self._n += 1
        return fold_in(self._key, self._n)
