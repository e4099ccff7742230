"""Scalar-ledger transforms for the ``ZOTransform`` chain — the port of
``repro.zo.transforms`` (the scalar ones; the applier transforms
``scale_by_zo_adam`` / ``trace`` come with mezo_adam, a later slice).

Ordering is significant, exactly as in optax:

    chain(clip_projected_grad(c),      # on the raw scalar g
          scale_by_schedule(lr, ...),  # sets Updates.lr and η-scales coeff
          add_weight_decay(λ))         # reads Updates.lr

Scalars are host f32 (numpy), one rounding per JAX op.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import schedules
from repro_torch.zo.base import TransformCtx, Updates, ZOTransform

f32 = np.float32


def clip_projected_grad(clip: float) -> ZOTransform:
    """|g| ← min(|g|, clip) on the raw projected gradient.  Place before
    ``scale_by_schedule``."""
    if clip <= 0:
        raise ValueError("clip must be positive; omit the transform to disable")

    def update(u: Updates, state, ctx: TransformCtx):
        return u._replace(g=np.clip(u.g, f32(-clip), f32(clip))), state

    return ZOTransform(lambda params: (), update,
                       {"clip_projected_grad": clip})


def scale_by_schedule(lr: float, schedule: str = "constant",
                      total_steps: int = 0,
                      warmup_steps: int = 0) -> ZOTransform:
    """coeff ← (η_t / n_seeds)·g and record η_t for downstream transforms
    (each of the n interleaved seeds carries η_t/n, Algorithm 2)."""

    def lr_at(step):
        return schedules.lr_at(schedule, lr, step, total_steps, warmup_steps)

    def update(u: Updates, state, ctx: TransformCtx):
        lr_t = lr_at(ctx.step)
        return u._replace(coeff=(lr_t / f32(ctx.n_seeds)) * u.g,
                          lr=lr_t), state

    return ZOTransform(lambda params: (), update, {"lr_at": lr_at})


def add_weight_decay(weight_decay: float) -> ZOTransform:
    """Decoupled weight decay: the term η_t·λ, applied once per step (on
    the first seed under n-SPSA, Algorithm 2).  Follows
    ``scale_by_schedule``."""

    def update(u: Updates, state, ctx: TransformCtx):
        lr_t = u.lr if u.lr is not None else f32(1.0)
        wd_j = weight_decay if ctx.seed_index == 0 else 0.0
        return u._replace(decay=f32(lr_t * f32(wd_j))), state

    return ZOTransform(lambda params: (), update,
                       {"weight_decay": weight_decay, "scalar_decay": True})


def scale_by_fzoo_std(std_floor: float = 1e-8) -> ZOTransform:
    """FZOO's adaptive step (Dang et al., 2025): divide the per-seed g by
    the standard deviation (ddof 0, as ``jnp.std``) of the B one-sided loss
    differences ε·g_j.  A no-op for B == 1.  Place it FIRST in the chain."""
    if std_floor <= 0:
        raise ValueError("std_floor must be positive")

    def update(u: Updates, state, ctx: TransformCtx):
        g = np.asarray(u.g, f32)
        if g.ndim == 0 or g.shape[0] < 2:
            return u, state                     # B == 1: σ ≡ 0, no-op
        sigma = f32(torch.std(torch.from_numpy(g * f32(ctx.eps)),
                              correction=0).item())
        return u._replace(g=g / max(sigma, f32(std_floor))), state

    return ZOTransform(lambda params: (), update, {"fzoo_std_floor": std_floor})
