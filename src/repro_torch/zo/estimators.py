"""ZO estimators behind the ``ZOEstimator`` protocol — the port of
``repro.zo.estimators``: ``spsa`` (both chains), ``n_spsa``, ``fzoo`` and
``one_point`` (``rescaled_spsa`` comes with a later slice).

Every perturbation and parameter write goes through the perturbation
backend, which writes in place.  Where JAX perturbs and then keeps θ for
the update (``one_point``), the port perturbs a copy: an in-place perturb
followed by an in-place "restore" is not bitwise θ in bf16.  ``fzoo``'s
batched forward over the stacked ``(B, …)`` view is a loop over the B views
(``vmap`` cannot trace the kernels' launches); its losses are JAX's ``(B,)``
vector.  Losses come back to the host as f32, and g is formed there in
JAX's order, e.g. (ℓ₊ − ℓ₋) / f32(2ε).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spsa import OnePointState, one_point_init
from repro_torch.perturb import StreamRef, get_backend
from repro_torch.perturb.stream import fold_in
from repro_torch.select import resolve_selection
from repro_torch.tree_utils import tree_clone, tree_map
from repro_torch.zo.base import ZOEstimate, ZOEstimator, host_f32
from repro_torch.zo.updates import apply_rank1_batch

f32 = np.float32


def _view(stacked, j: int):
    return tree_map(lambda s: s[j], stacked)


# --------------------------------------------------------------------------- #
# SPSA (Definition 1) and n-SPSA (Algorithm 2)
# --------------------------------------------------------------------------- #
def spsa(eps: float = 1e-3, dist: str = "gaussian", sequential: bool = True,
         backend=None, selection=None) -> ZOEstimator:
    """Two-point SPSA.  ``sequential=True`` is the paper's in-place chain
    θ → θ+εz → θ−εz with a fused restore+descent pass (one parameter copy
    live); ``False`` perturbs from the center twice as one antithetic ±ε
    fan-out (K4), leaving θ untouched."""
    be = get_backend(backend)
    be.check_dist(dist)
    resolve_selection(selection)

    def init(params, key):
        del params, key
        return ()

    def estimate(loss_fn, params, batch, key, est_state, phase: int = 0):
        del phase
        ref = StreamRef(key)
        if sequential:
            p_plus = be.perturb(params, ref, eps, dist)
            l_plus = host_f32(loss_fn(p_plus, batch))
            p_minus = be.perturb(p_plus, ref, -2.0 * eps, dist)
            l_minus = host_f32(loss_fn(p_minus, batch))

            def apply_update(coeff, decay_term):
                return be.fused_restore_update(p_minus, ref, eps, coeff,
                                               weight_decay=decay_term,
                                               dist=dist)

            def restore():
                return be.fused_restore_update(p_minus, ref, eps, 0.0, 0.0,
                                               dist)
        else:
            pair = be.perturb_many(params, [ref, ref], (eps, -eps), dist)
            l_plus = host_f32(loss_fn(_view(pair, 0), batch))
            l_minus = host_f32(loss_fn(_view(pair, 1), batch))
            del pair

            def apply_update(coeff, decay_term):
                return be.apply_rank1(params, ref, coeff, decay_term, dist)

            def restore():
                return params

        g = (l_plus - l_minus) / f32(2.0 * eps)
        return ZOEstimate(projected_grad=g, loss=f32(0.5) * (l_plus + l_minus),
                          apply_update=apply_update, restore=restore,
                          est_state=est_state, aux={})

    return ZOEstimator(init=init, estimate=estimate, n_seeds=1, eps=eps,
                       dist=dist, name="spsa", backend=be)


def n_spsa(n: int, eps: float = 1e-3, dist: str = "gaussian",
           sequential: bool = True, backend=None,
           selection=None) -> ZOEstimator:
    """n-SPSA, sequential over seeds (Algorithm 2): the facade runs the
    two-point estimate once per folded seed key and applies each seed's
    update (η/n per seed) before the next seed's perturbation."""
    base = spsa(eps=eps, dist=dist, sequential=sequential, backend=backend,
                selection=selection)
    return base._replace(n_seeds=int(n), name="n_spsa")


# --------------------------------------------------------------------------- #
# FZOO batched seeds (Dang et al., 2025)
# --------------------------------------------------------------------------- #
def fzoo(batch_seeds: int = 8, eps: float = 1e-3, dist: str = "gaussian",
         backend=None, selection=None) -> ZOEstimator:
    """Batched-seed one-sided estimator: B seed streams folded from the step
    key, the B perturbed views from ONE ``perturb_many`` (K5, or K4 for
    sphere), their forwards plus the center forward ℓ₀; g_j = (ℓ_j − ℓ₀)/ε.
    The update walks the B rank-1 updates through ``apply_rank1_batch``
    (K3) — the call ledger replay makes."""
    be = get_backend(backend)
    be.check_dist(dist)
    resolve_selection(selection)
    n_batch = int(batch_seeds)
    if n_batch < 1:
        raise ValueError(f"batch_seeds must be >= 1, got {batch_seeds}")

    def init(params, key):
        del params, key
        return ()

    def estimate(loss_fn, params, batch, key, est_state, phase: int = 0):
        del phase
        # B == 1 is one-sided SPSA on the unfolded step key
        refs = ([StreamRef(key)] if n_batch == 1 else
                [StreamRef(fold_in(key, j)) for j in range(n_batch)])
        stacked = be.perturb_many(params, refs, eps, dist)
        losses = torch.stack([loss_fn(_view(stacked, j), batch).float()
                              for j in range(n_batch)]).cpu().numpy()
        del stacked
        l0 = host_f32(loss_fn(params, batch))
        diffs = losses - l0
        g_vec = diffs / f32(eps)                  # (B,) per-seed projected g

        def apply_update(coeff, decay_term):
            if n_batch == 1:
                return be.apply_rank1(params, refs[0], coeff, decay_term,
                                      dist)
            return apply_rank1_batch(params, key, coeff, decay_term, dist,
                                     backend=be)

        def restore():
            return params

        std = f32(torch.std(torch.from_numpy(diffs), correction=0).item())
        return ZOEstimate(projected_grad=g_vec[0] if n_batch == 1 else g_vec,
                          loss=l0, apply_update=apply_update, restore=restore,
                          est_state=est_state, aux={"fzoo_loss_std": std})

    return ZOEstimator(init=init, estimate=estimate, n_seeds=1, eps=eps,
                       dist=dist, name="fzoo", replayable=True, backend=be,
                       batch_seeds=n_batch)


# --------------------------------------------------------------------------- #
# One-point residual feedback (Definition 8)
# --------------------------------------------------------------------------- #
def one_point(eps: float = 1e-3, dist: str = "gaussian", backend=None,
              selection=None) -> ZOEstimator:
    """g_t = (L(θ_t + εz_t) − L_prev) / ε — one forward per step, the
    previous perturbed loss carried as estimator state.  θ + εz is a copy:
    the update applies to the unperturbed θ."""
    be = get_backend(backend)
    be.check_dist(dist)
    resolve_selection(selection)

    def init(params, key):
        del params, key
        return one_point_init()

    def estimate(loss_fn, params, batch, key, est_state: OnePointState,
                 phase: int = 0):
        del phase
        ref = StreamRef(key)
        p_pert = be.perturb(tree_clone(params), ref, eps, dist)
        l_pert = host_f32(loss_fn(p_pert, batch))
        del p_pert
        g = (l_pert - f32(est_state.prev_perturbed_loss)) / f32(eps)

        def apply_update(coeff, decay_term):
            return be.apply_rank1(params, ref, coeff, decay_term, dist)

        def restore():
            return params

        return ZOEstimate(projected_grad=g, loss=l_pert,
                          apply_update=apply_update, restore=restore,
                          est_state=OnePointState(l_pert), aux={})

    return ZOEstimator(init=init, estimate=estimate, n_seeds=1, eps=eps,
                       dist=dist, name="one_point", backend=be)
