"""Backprop baselines — the port of ``repro.train.adam``: Adam (the paper's
FT) and SGD with or without momentum (App. F.1), behind the same
``init`` / ``step_fn`` / ``restore`` protocol as the ZO optimizers.

The step is ``value_and_grad`` (``torch.autograd.grad`` on detached copies
of the leaves; gradients come out in the parameters' dtype, as JAX's do)
and then the reference's arithmetic, operation for operation in f32:

* the clip: ``gnorm = sqrt(Σ_leaves sum(g.f32²))`` in the JAX leaf order,
  ``scale = min(1, clip / max(gnorm, 1e-9))``, g ← g.f32 · scale (with
  ``grad_clip`` 0, gnorm is 0 and g ← g.f32);
* the scalars on the host: η = ``lr_at(step)``, t = step + 1,
  bc = 1 − β^t in f32, β^t by libm's ``powf`` (the function XLA:CPU calls
  for ``jnp.power``);
* Adam: m ← β₁·m + (1−β₁)·g, v ← β₂·v + ((1−β₂)·g)·g,
  θ ← (θ − η·((m/bc₁)/(√(v/bc₂) + ε)) − (η·λ)·θ), cast to θ's dtype;
  SGD: m ← μ·m + g when μ ≠ 0, θ ← (θ − η·u − (η·λ)·θ) with u = m or g.

Each operation is rounded on its own (no ``alpha=`` / ``addcdiv`` /
``_foreach`` forms, which change the rounding); the square root is
correctly rounded on every device.  m and v start as zeros in θ's dtype
and become f32 at the first step, as JAX's promotion makes them (a bf16
product with a weak float, then an f32 sum); the step keeps both, since
checkpoints show them.

θ, m and v are written in place, leaf by leaf and in chunks of ``CHUNK``
elements under ``no_grad``, so a step holds θ + grads + m + v and the
activations, plus a few chunk-sized temporaries — no second tree; a
moment that turns f32 replaces its zeros in the state's own tree, so the
two coexist for one leaf at a time.  ``params`` and the state are
consumed: continue from the returned ones (the same tensors and trees).

``cfg.remat`` is inert, as in the reference (no JAX code reads it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import schedules
from repro_torch.kernels.zo_fused.kernel import _sqrt_rn
from repro_torch.tree_utils import PyTree, tree_leaves, tree_map, \
    tree_unflatten

f32 = np.float32
#: elements per chunk of the in-place update (its temporaries are f32
#: tensors of this size)
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    lr_schedule: str = "linear"     # the paper's FT convention
    total_steps: int = 1000
    warmup_steps: int = 0
    sgd: bool = False               # True -> plain SGD (paper App. F.1)
    momentum: float = 0.0           # SGD momentum

    def lr_at(self, step) -> np.float32:
        return schedules.lr_at(self.lr_schedule, self.lr, step,
                               self.total_steps, self.warmup_steps)


class AdamState(NamedTuple):
    step: np.int32
    m: Any
    v: Any


def bias_correction(beta: float, t) -> np.float32:
    """1 − β^t in f32, β^t by libm's ``powf`` — bitwise what JAX's jitted
    ``1.0 - beta ** t`` gives on XLA:CPU (which calls ``powf`` too and
    flushes subnormal powers to 0, which leaves 1 − β^t unchanged)."""
    return f32(f32(1.0) - schedules.powf(beta, t))


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, in place on the card: CUDA's
    ``sqrtf`` is correctly rounded, the CPU's vectorized ``torch.sqrt`` is
    not (``_sqrt_rn`` corrects it)."""
    return t.sqrt_() if t.device.type == "cuda" else _sqrt_rn(t)


def value_and_grad(loss_fn: Callable, params: PyTree, batch) -> tuple:
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient tree, each
    leaf in its parameter's dtype (zeros where the loss does not reach)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _chunks(n: int):
    return ((a, min(a + CHUNK, n)) for a in range(0, n, CHUNK))


def _slots(tree) -> list:
    """(container, key) of every leaf of a dict / list tree, in JAX's leaf
    order — where a moment that turns f32 replaces its param-dtype zeros,
    so the two coexist for one leaf at a time."""
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, list):
        keys = range(len(tree))
    else:
        raise TypeError("the moment trees are written in place: dicts and "
                        f"lists of tensors, not {type(tree).__name__}")
    out = []
    for k in keys:
        if isinstance(tree[k], (dict, list)):
            out.extend(_slots(tree[k]))
        elif tree[k] is not None:
            out.append((tree, k))
    return out


def _grad_norm(grads: list) -> torch.Tensor:
    """sqrt(Σ_leaves Σ g.f32²) as a 0-d f32 tensor on the grads' device,
    the leaves added in order (no host sync)."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        flat = g.reshape(-1)
        for a, b in _chunks(flat.numel()):
            x = flat[a:b].float()
            total = total + torch.sum(x * x)
    return sqrt_rn(total)


def _scaled(g: torch.Tensor, scale) -> torch.Tensor:
    """A fresh f32 chunk: g.f32 · scale, or g.f32 when there is no clip."""
    if scale is None:
        return g.to(torch.float32, copy=True)
    return g.float() * scale


def _moment(old: torch.Tensor, beta: float, term: torch.Tensor,
            out: torch.Tensor) -> None:
    """out ← β·old + term (``out`` may be ``old``); β rounded to ``old``'s
    dtype first, as JAX casts a weak float to the array's dtype (a bf16 m
    at the first step)."""
    b = float(torch.tensor(beta, dtype=old.dtype))
    torch.add(old * b, term, out=out)


def _write_params(p: torch.Tensor, u: torch.Tensor, lr: float,
                  lr_wd: float) -> None:
    """p ← (p32 − η·u − (η·λ)·p32).to(p.dtype), each product and
    difference one f32 rounding; ``u`` is overwritten."""
    p32 = p.float()                       # p itself when p is f32
    decay = p32 * lr_wd
    p32.sub_(u.mul_(lr)).sub_(decay)
    if p32 is not p:
        p.copy_(p32)


class Adam:
    """Backprop Adam / SGD behind the uniform optimizer protocol:
    ``init`` / ``step_fn`` / ``restore``."""

    def __init__(self, config: AdamConfig):
        self.config = config

    def init(self, params: PyTree, *, seed: int = 0) -> AdamState:
        del seed  # deterministic init; accepted for protocol uniformity
        c = self.config
        m = tree_map(torch.zeros_like, params) if (not c.sgd or c.momentum) \
            else ()
        v = tree_map(torch.zeros_like, params) if not c.sgd else ()
        return AdamState(np.int32(0), m, v)

    def restore(self, state: AdamState, step: int) -> AdamState:
        """Resume bookkeeping: realign the step counter (lr index and bias
        correction) after a checkpoint restore."""
        return state._replace(step=np.int32(step))

    def step_fn(self, loss_fn: Callable) -> Callable:
        """``step(params, state, batch) -> (params, state, metrics)``; θ and
        the state's moments are written in place (both are consumed)."""
        c = self.config

        def step(params: PyTree, state: AdamState, batch):
            loss, grad_tree = value_and_grad(loss_fn, params, batch)
            grads = tree_leaves(grad_tree)
            del grad_tree
            with torch.no_grad():
                if c.grad_clip > 0:
                    gnorm = _grad_norm(grads)
                    q = torch.full_like(gnorm, float(f32(c.grad_clip))).div_(
                        torch.clamp_min(gnorm, float(f32(1e-9))))
                    scale = torch.clamp_max(q, 1.0)
                else:
                    gnorm, scale = f32(0.0), None
                lr = c.lr_at(state.step)
                self._update(params, state, grads, scale, lr)
            new_state = AdamState(np.int32(state.step + 1), state.m, state.v)
            return params, new_state, {"loss": loss, "lr": lr,
                                       "grad_norm": gnorm}

        return step

    def _update(self, params, state, grads, scale, lr) -> None:
        """θ, m and v in place, leaf by leaf and chunk by chunk; the
        gradients are released as they are used."""
        c = self.config
        lr_f, lr_wd = float(lr), float(lr * f32(c.weight_decay))
        if not c.sgd:
            t = f32(state.step + 1)
            bc1, bc2 = (float(bias_correction(b, t))
                        for b in (c.beta1, c.beta2))
            a1, a2 = float(f32(1 - c.beta1)), float(f32(1 - c.beta2))
            eps = float(f32(c.eps))
        m_slots = _slots(state.m) if state.m != () else None
        v_slots = _slots(state.v) if state.v != () else None
        for i, p in enumerate(tree_leaves(params)):
            g = grads[i].reshape(-1)
            grads[i] = None
            pf = p.view(-1)
            mo, mn = _f32_pair(m_slots, i)
            vo, vn = _f32_pair(v_slots, i)
            for a, b in _chunks(pf.numel()):
                gc = _scaled(g[a:b], scale)
                if c.sgd:
                    if mo is not None:
                        _moment(mo[a:b], c.momentum, gc, mn[a:b])
                        gc.copy_(mn[a:b])
                    _write_params(pf[a:b], gc, lr_f, lr_wd)
                    continue
                u = gc * a1
                _moment(mo[a:b], c.beta1, u, mn[a:b])
                torch.mul(gc, a2, out=u).mul_(gc)
                _moment(vo[a:b], c.beta2, u, vn[a:b])
                torch.div(mn[a:b], bc1, out=u)
                torch.div(vn[a:b], bc2, out=gc)
                u.div_(sqrt_rn(gc).add_(eps))
                _write_params(pf[a:b], u, lr_f, lr_wd)
            for slots, new in ((m_slots, mn), (v_slots, vn)):
                if slots is not None:
                    container, key = slots[i]
                    container[key] = new.view(container[key].shape)


def _f32_pair(slots, i: int) -> tuple:
    """(old, new) flat views of moment leaf ``i``: ``new`` is the leaf
    itself when it is f32, else a fresh f32 leaf — a param-dtype moment
    turns f32 at its first update, as under JAX's promotion."""
    if slots is None:
        return None, None
    container, key = slots[i]
    old = container[key]
    new = old if old.dtype == torch.float32 else torch.empty(
        old.shape, dtype=torch.float32, device=old.device)
    return old.view(-1), new.view(-1)
