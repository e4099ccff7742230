"""Stateless step-indexed LM batches — the port of
``repro.data.synthetic.lm_batch``.

``lm_batch(seed, step, ...)`` is a pure function of (seed, step): a restart
at step k regenerates the same batch with no iterator state to checkpoint.
The base tokens come from a CPU ``torch.Generator`` seeded by the threefry
key ``fold_in(PRNGKey(seed), step)`` — JAX draws them with threefry
``randint``, which the port does not reproduce (it arrives with the ``xla``
stream), so the two frameworks' batches differ.  The planted structure on
top is JAX's exactly: every other token is ``(prev·1103515245 + 12345) mod
vocab`` in wrapping int32 arithmetic with a floor mod, as jnp computes it
(``plant_structure``, test-held to JAX on JAX's own base tokens).
"""
from __future__ import annotations

import torch

from repro_torch.perturb.stream import fold_in, prng_key


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's-complement wraparound."""
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


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
    k0, k1 = fold_in(prng_key(seed), step)
    gen = torch.Generator().manual_seed((k0 << 32) | k1)
    base = torch.randint(0, vocab, (batch, seq), generator=gen,
                         dtype=torch.int64)
    tokens = plant_structure(base, vocab)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(batch, seq, dtype=torch.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens.to(device), "labels": labels.to(device),
            "loss_mask": mask.to(device)}
