"""Transforms for the ``ZOTransform`` chain — the port of
``repro.zo.transforms``: the scalar ones and the applier transforms
``scale_by_zo_adam`` / ``trace``.

Ordering is significant, exactly as in optax:

    chain(clip_projected_grad(c),      # on the raw scalar g
          scale_by_schedule(lr, ...),  # sets Updates.lr and η-scales coeff
          add_weight_decay(λ))         # reads Updates.lr

Applier transforms materialize the whole update themselves
(``Updates.final_params``) and take their own ``weight_decay=`` instead of
``add_weight_decay`` (the facade refuses that combination).

Scalars are host f32 (numpy), one rounding per JAX op; the appliers'
leaf arithmetic runs in f32 torch ops on the leaf's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import schedules
from repro_torch.perturb import StreamRef, get_backend, step_key
from repro_torch.tree_utils import is_floating, tree_leaves, tree_map, \
    tree_unflatten
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


# --------------------------------------------------------------------------- #
# ZO-Adam / momentum (paper §2.2 + Appendix B.2)
# --------------------------------------------------------------------------- #
def _bias(beta: float, t: int) -> np.float32:
    """1 − β^t in f32, β^t by libm's ``powf`` as on XLA:CPU."""
    return f32(f32(1.0) - schedules.powf(beta, t))


def scale_by_zo_adam(beta1: float = 0.9, beta2: float = 0.999,
                     adam_eps: float = 1e-8, materialized: bool = False,
                     window: int = 32, momentum_only: bool = False,
                     weight_decay: float = 0.0) -> ZOTransform:
    """Adam (or momentum) preconditioning of the rank-1 ZO gradient.  Any
    moving average of g_τ·z_τ is a function of the scalar history {g_τ}:

    * ``materialized=True`` — m, v stored as full trees (2× parameter
      memory, the oracle);
    * ``materialized=False`` — a ring buffer of ``window`` scalars; m, v
      rebuilt leaf by leaf each step from the window's z's (App. B.2):
      O(largest leaf) of f32 beyond θ, truncation error β^W.

    The update is written into the center parameters' leaves in place
    (``final_params``); one ledger entry per step, last in a chain."""

    def init(params):
        g_hist = np.zeros((window,), f32)
        if materialized:
            if params is None:
                raise ValueError("materialized scale_by_zo_adam needs params "
                                 "at init")
            zeros = tree_map(torch.zeros_like, params)
            return (g_hist, zeros, tree_map(torch.zeros_like, params))
        return (g_hist, (), ())

    def _write(p, m, v, lr, t):
        """p ← p − η·Δ − η·λ·p in f32, cast back; Δ = m̂/(√v̂ + ε) or m."""
        if momentum_only:
            delta = m
        else:
            delta = (m / float(_bias(beta1, t))) / (
                torch.sqrt(v / float(_bias(beta2, t))) + float(f32(adam_eps)))
        p32 = p.float()
        new = p32 - delta * float(lr) - p32 * float(f32(lr * f32(
            weight_decay)))
        p.copy_(new.to(p.dtype))

    def _materialized(params, m_tree, v_tree, ref, g, lr, t, dist, be):
        new_m, new_v = [], []
        b1, b2 = float(f32(beta1)), float(f32(beta2))
        for i, (p, m, v) in enumerate(zip(tree_leaves(params),
                                          tree_leaves(m_tree),
                                          tree_leaves(v_tree))):
            ghat = be.leaf_z(ref, i, p, dist).float() * float(g)
            m_new = m.float() * b1 + ghat * float(f32(1.0 - beta1))
            if momentum_only:
                v_new = m_new * 0
            else:
                v_new = v.float() * b2 + (ghat * float(
                    f32(1.0 - beta2))) * ghat
            del ghat
            _write(p, m_new, v_new, lr, t)
            new_m.append(m_new)
            new_v.append(v_new)
        return (tree_unflatten(m_tree, new_m), tree_unflatten(v_tree, new_v))

    def _recomputed(params, base_key, cur_step, g_hist, lr, t, dist, be):
        """App. B.2: m (and v) rebuilt one leaf at a time by replaying the
        window's z's — W z passes of compute, O(largest leaf) memory."""
        j_idx = np.arange(window, dtype=f32)           # 0 = most recent
        pw1 = np.array([schedules.powf(beta1, j) for j in j_idx], f32)
        pw2 = np.array([schedules.powf(beta2, j) for j in j_idx], f32)
        cm = f32(1.0 - beta1) * pw1 * g_hist
        cv = f32(1.0 - beta2) * pw2 * (g_hist * g_hist)
        refs = [StreamRef(step_key(base_key, cur_step - j))
                for j in range(window) if cur_step - j >= 0]
        for i, p in enumerate(tree_leaves(params)):
            if not is_floating(p):
                continue
            m = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            v = None if momentum_only else torch.zeros_like(m)
            for j, ref in enumerate(refs):
                z = be.leaf_z(ref, i, p, dist).float()
                m.add_(z * float(cm[j]))
                if v is not None:
                    v.add_((z * float(cv[j])) * z)
                del z
            _write(p, m, v, lr, t)
            del m, v
        return params

    def update(u: Updates, state, ctx: TransformCtx):
        g_hist, m, v = state
        g_hist = np.concatenate([np.reshape(np.asarray(u.g, f32), (1,)),
                                 g_hist[:-1]]).astype(f32)
        t = ctx.step + 1                      # Adam bias-correction index
        lr = f32(u.lr) if u.lr is not None else f32(1.0)
        params0 = ctx.restore()
        be = get_backend(ctx.backend)
        if materialized:
            m, v = _materialized(params0, m, v, StreamRef(ctx.key),
                                 f32(u.g), lr, t, ctx.dist, be)
            new_params = params0
        else:
            new_params = _recomputed(params0, ctx.base_key, ctx.step, g_hist,
                                     lr, t, ctx.dist, be)
            m, v = (), ()
        return u._replace(final_params=new_params), (g_hist, m, v)

    return ZOTransform(init, update,
                       {"applier": True, "window": window,
                        "weight_decay": weight_decay})


def trace(decay: float = 0.9, window: int = 32,
          materialized: bool = False) -> ZOTransform:
    """SGD-momentum on the rank-1 ZO gradient: m_t = β·m_{t−1} + (1−β)·g_t·z_t,
    rebuilt from the scalar ring buffer exactly like ZO-Adam's first moment
    (no second moment, no bias correction)."""
    return scale_by_zo_adam(beta1=decay, materialized=materialized,
                            window=window, momentum_only=True)
