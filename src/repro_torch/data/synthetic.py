"""Stateless step-indexed LM batches — the port of
``repro.data.synthetic.lm_batch``.

``lm_batch(seed, step, ...)`` is a pure function of (seed, step): a restart
at step k regenerates the same batch with no iterator state to checkpoint.
It is JAX's batch bit for bit: the base tokens are
``jax.random.randint(fold_in(PRNGKey(seed), step), (batch, seq), 0, vocab)``
under the partitionable threefry layout (``randint``), and every other
token is then ``(prev·1103515245 + 12345) mod vocab`` in wrapping int32
arithmetic with a floor mod, as jnp computes it (``plant_structure``).  The
tokens are drawn on the host CPU (a batch is small) and moved to
``device``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.threefry.kernel import threefry_bits
from repro_torch.perturb.stream import fold_in, prng_key

_MASK = 0xFFFFFFFF


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's-complement wraparound."""
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: two
    32-bit draws from the keys of ``split(key)`` (fold-like under the
    partitionable layout: key j = threefry2x32(key, (0, j))), combined as
    ``(hi % span) · ((2¹⁶ % span)² % span) + lo % span`` in wrapping uint32
    arithmetic, mod span; an int64 tensor of int32 values."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64)
    hi = threefry_bits(fold_in(key, 0), idx)
    lo = threefry_bits(fold_in(key, 1), idx)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    off = (off & _MASK) % span
    return _wrap_int32(off + minval).reshape(tuple(shape))


def plant_structure(base: torch.Tensor, vocab: int) -> torch.Tensor:
    """(batch, seq) int base tokens → tokens whose odd positions are a
    function of their predecessor (int32 result)."""
    b = base.to(torch.int64)
    shifted = torch.remainder(_wrap_int32(b * 1103515245 + 12345), vocab)
    alt = (torch.arange(b.shape[1], device=b.device) % 2 == 1)[None, :]
    return torch.where(alt, torch.roll(shifted, 1, dims=1), b).to(torch.int32)


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device="cpu") -> dict:
    """Deterministic (seed, step) -> {"tokens", "labels", "loss_mask"}."""
    base = randint(fold_in(prng_key(seed), step), (batch, seq), 0, vocab)
    tokens = plant_structure(base, vocab)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(batch, seq, dtype=torch.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens.to(device), "labels": labels.to(device),
            "loss_mask": mask.to(device)}
