"""SPSA-family gradient estimators (paper §2, Definitions 1/6/7/8) — the
port of ``repro.core.spsa``'s functional primitives.

Every estimator here consumes only forward passes of a loss function
``loss_fn(params, batch) -> scalar`` and returns projected-gradient
scalars; the full estimate g·z is never materialized (save by
``spsa_full_gradient_oracle``, for tests and analysis).  The perturbed
trees come from the functional API of ``repro_torch.perturb.xla`` (the
threefry stream through X1, each write into a fresh tree): the caller's θ
keeps its bits.  Losses come back to the host as f32, and every scalar is
formed there in JAX's order, e.g. g = (ℓ₊ − ℓ₋) / f32(2ε).

  * ``spsa_projected_grad``        — two-point SPSA (Definition 1), n=1.
  * ``nspsa_projected_grads``      — n-SPSA: one projected grad per key.
  * ``one_point_projected_grad``   — residual-feedback one-point estimate
                                     (Definition 8).
  * ``variance_modified_projected_grad`` — Definition 6: ε·(d⁻¹ ⊙ z).
  * ``zo_grad_norm``               — Proposition 1's ZO gradient-norm probe.

The estimators the optimizers run are ``repro_torch.zo.estimators``, which
write in place; this module imports nothing of ``repro_torch.zo`` at load
time (``zo.estimators`` imports it).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.perturb import StreamRef, get_backend
from repro_torch.perturb.xla import (Distribution, leaf_key, perturb,
                                     sample_leaf_z)
from repro_torch.tree_utils import (PyTree, is_floating, tree_leaves,
                                    tree_map_with_index)

f32 = np.float32
LossFn = Callable[[PyTree, Any], torch.Tensor]


def _host(x) -> np.float32:
    from repro_torch.zo.base import host_f32
    return host_f32(x)


class SPSAResult(NamedTuple):
    projected_grad: np.float32   # (ℓ+ − ℓ−) / 2ε — a scalar
    loss: np.float32             # (ℓ+ + ℓ−) / 2  — unbiased loss estimate
    l_plus: np.float32
    l_minus: np.float32


@torch.no_grad()
def spsa_projected_grad(loss_fn: LossFn, params: PyTree, batch, key,
                        eps: float, dist: Distribution = "gaussian",
                        sequential: bool = True) -> SPSAResult:
    """Two-point SPSA projected gradient (paper Algorithm 1 lines 3–8).

    ``sequential=True`` is the paper's chain θ → θ+εz → θ−εz, each step a
    functional ``perturb`` of the one before (the θ+εz tree is dropped once
    θ−εz is written); ``False`` perturbs from the center twice."""
    if sequential:
        p_plus = perturb(params, key, eps, dist)
        l_plus = _host(loss_fn(p_plus, batch))
        p_minus = perturb(p_plus, key, -2.0 * eps, dist)
        del p_plus
        l_minus = _host(loss_fn(p_minus, batch))
        del p_minus
    else:
        l_plus = _host(loss_fn(perturb(params, key, eps, dist), batch))
        l_minus = _host(loss_fn(perturb(params, key, -eps, dist), batch))
    g = f32(l_plus - l_minus) / f32(2.0 * eps)
    return SPSAResult(f32(g), f32(f32(0.5) * f32(l_plus + l_minus)),
                      l_plus, l_minus)


def nspsa_projected_grads(loss_fn: LossFn, params: PyTree, batch,
                          keys: Sequence, eps: float,
                          dist: Distribution = "gaussian") -> tuple:
    """n-SPSA: one projected grad per key (Algorithm 2's inner loop).
    Returns (the (n,) f32 projected grads, their mean loss as f32)."""
    gs, losses = [], []
    for k in keys:
        r = spsa_projected_grad(loss_fn, params, batch, k, eps, dist)
        gs.append(r.projected_grad)
        losses.append(r.loss)
    return (np.asarray(gs, dtype=f32),
            f32(np.sum(np.asarray(losses, dtype=f32), dtype=f32)
                / f32(len(losses))))


class OnePointState(NamedTuple):
    """Carry for the residual-feedback one-point estimator (Definition 8)."""
    prev_perturbed_loss: np.float32  # L(θ_{t-1} + ε z_{t-1}; B_{t-1})


def one_point_init() -> OnePointState:
    return OnePointState(np.float32(0.0))


@torch.no_grad()
def one_point_projected_grad(loss_fn: LossFn, params: PyTree, batch, key,
                             eps: float, state: OnePointState,
                             dist: Distribution = "gaussian") -> tuple:
    """One forward pass per step: g_t = (L(θ_t + εz_t) − L_prev) / ε.
    Returns (g, the perturbed loss, the next carry)."""
    l_pert = _host(loss_fn(perturb(params, key, eps, dist), batch))
    g = f32(f32(l_pert - f32(state.prev_perturbed_loss)) / f32(eps))
    return g, l_pert, OnePointState(l_pert)


@torch.no_grad()
def variance_modified_projected_grad(loss_fn: LossFn, params: PyTree, batch,
                                     key, eps: float, d_tree: PyTree,
                                     modify_expectation: bool = False
                                     ) -> np.float32:
    """Definition 6 (and 7 with ``modify_expectation=True``): perturb by
    ε·(d⁻¹ ⊙ z) with one positive scalar d per leaf.  JAX forms the write
    op by op (``p + ε·d⁻¹·z``, every scalar in the leaf dtype), and so does
    the port: z from X1's ``z`` form (``sample_leaf_z``, bitwise JAX's),
    then torch's elementwise ops, each rounded to the leaf dtype.  The
    caller applies the update with the same key and d_tree."""
    del modify_expectation  # the D vs identity factor is applied at update
    d_leaves = [f32(float(v)) for v in tree_leaves(d_tree)]

    def scal(i, p):
        dt = p.dtype
        eps_ = torch.tensor(float(f32(eps)), dtype=torch.float32).to(dt)
        dinv = 1.0 / torch.tensor(float(d_leaves[i])).to(dt)
        return eps_, dinv

    def pert(i, p):
        z = sample_leaf_z(leaf_key(key, i), p)
        eps_, dinv = scal(i, p)
        return p + (eps_ * dinv) * z

    def pert_m(i, p):
        z = sample_leaf_z(leaf_key(key, i), p)
        eps_, dinv = scal(i, p)
        return p - (2.0 * eps_ * dinv) * z

    p_plus = tree_map_with_index(pert, params)
    l_plus = _host(loss_fn(p_plus, batch))
    p_minus = tree_map_with_index(pert_m, p_plus)
    del p_plus
    l_minus = _host(loss_fn(p_minus, batch))
    return f32(f32(l_plus - l_minus) / f32(2.0 * eps))


@torch.no_grad()
def zo_grad_norm(loss_fn: LossFn, params: PyTree, batch, key, eps: float,
                 leaf_indices: Sequence[int]) -> np.float32:
    """Proposition 1: |L(θ+εz_ℓ) − L(θ−εz_ℓ)| / 2ε estimates ‖∇_ℓ L‖ where
    z_ℓ is the threefry (``xla``) z on the leaves in ``leaf_indices`` and
    zero elsewhere — JAX draws it with ``sample_leaf_z`` whatever the run's
    backend.  The probed leaves are perturbed on copies (θ is left alone):
    θ + ε·z, then − 2ε·z from there, each scalar in the leaf dtype."""
    idx = set(leaf_indices)
    be, ref = get_backend("xla"), StreamRef(key)

    def copy(i, p):
        return p.clone() if i in idx and is_floating(p) else p

    probe = tree_map_with_index(copy, params)

    def pert(sign: float):
        def one(i, p):
            if i not in idx or not is_floating(p):
                return p
            eps_ = torch.tensor(float(f32(eps))).to(p.dtype)
            return be.perturb_leaf(p, ref, i, float(eps_ * sign))
        return tree_map_with_index(one, probe)

    l_plus = _host(loss_fn(pert(1.0), batch))
    l_minus = _host(loss_fn(pert(-2.0), batch))
    return f32(abs(f32(l_plus - l_minus)) / f32(2.0 * eps))


@torch.no_grad()
def spsa_full_gradient_oracle(loss_fn: LossFn, params: PyTree, batch, key,
                              eps: float,
                              dist: Distribution = "gaussian") -> PyTree:
    """Materialized ĝ = projected_grad · z as an f32 tree, g from the
    centered (``sequential=False``) estimate.  TEST/ANALYSIS ONLY — this is
    the object the paper's memory trick never constructs."""
    r = spsa_projected_grad(loss_fn, params, batch, key, eps, dist,
                            sequential=False)
    g = float(r.projected_grad)

    def one(i, p):
        z = sample_leaf_z(leaf_key(key, i), p, dist)
        return z.to(torch.float32) * g

    return tree_map_with_index(one, params)
