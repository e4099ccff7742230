"""ZO estimators behind the ``ZOEstimator`` protocol — the port of
``repro.zo.estimators``: ``spsa`` (both chains), ``n_spsa``, ``fzoo``,
``one_point`` and ``rescaled_spsa`` (Definitions 6/7, with its D-tree
constructors ``compute_d_tree``).

Every perturbation and parameter write goes through the perturbation
backend, which writes in place.  Where JAX perturbs and then keeps θ for
the update (``one_point``), the port perturbs a copy: an in-place perturb
followed by an in-place "restore" is not bitwise θ in bf16.  ``fzoo``'s
batched forward over the stacked ``(B, …)`` view is a loop over the B views
(``vmap`` cannot trace the kernels' launches); its losses are JAX's ``(B,)``
vector.  Losses come back to the host as f32, and g is formed there in
JAX's order, e.g. (ℓ₊ − ℓ₋) / f32(2ε).  Every factory takes ``selection=``
(a ``repro_torch.select.Selection`` or spec string): the estimator scopes
its streams to it at the phase the facade passes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spsa import OnePointState, one_point_init, zo_grad_norm
from repro_torch.device import host_array
from repro_torch.perturb import StreamRef, get_backend
from repro_torch.perturb.stream import fold_in
from repro_torch.select import resolve_selection
from repro_torch.tree_utils import (is_floating, tree_clone, tree_leaves,
                                    tree_map, tree_map_with_index,
                                    tree_unflatten)
from repro_torch.zo.base import ZOEstimate, ZOEstimator, host_f32
from repro_torch.zo.updates import apply_rank1_batch

f32 = np.float32


def _view(stacked, j: int):
    # on a DTensor stack (tensor parallelism, ``base.rewrap_stacked``)
    # DTensor's select drops the leading axis and moves each Shard(d + 1)
    # back to Shard(d): the view has θ's placements, nothing is gathered
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
    sel = resolve_selection(selection)

    def init(params, key):
        del params, key
        return ()

    def estimate(loss_fn, params, batch, key, est_state, phase: int = 0):
        ref = StreamRef(key, sel, phase)
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
                       dist=dist, name="spsa", backend=be, selection=sel)


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
    sel = resolve_selection(selection)
    n_batch = int(batch_seeds)
    if n_batch < 1:
        raise ValueError(f"batch_seeds must be >= 1, got {batch_seeds}")

    def init(params, key):
        del params, key
        return ()

    def estimate(loss_fn, params, batch, key, est_state, phase: int = 0):
        # B == 1 is one-sided SPSA on the unfolded step key
        refs = ([StreamRef(key, sel, phase)] if n_batch == 1 else
                [StreamRef(fold_in(key, j), sel, phase)
                 for j in range(n_batch)])
        stacked = be.perturb_many(params, refs, eps, dist)
        losses = host_array(torch.stack([loss_fn(_view(stacked, j),
                                                 batch).float()
                                         for j in range(n_batch)]))
        del stacked
        l0 = host_f32(loss_fn(params, batch))
        diffs = losses - l0
        g_vec = diffs / f32(eps)                  # (B,) per-seed projected g

        def apply_update(coeff, decay_term):
            if n_batch == 1:
                return be.apply_rank1(params, refs[0], coeff, decay_term,
                                      dist)
            return apply_rank1_batch(params, key, coeff, decay_term, dist,
                                     backend=be, selection=sel, phase=phase)

        def restore():
            return params

        std = f32(torch.std(torch.from_numpy(diffs), correction=0).item())
        return ZOEstimate(projected_grad=g_vec[0] if n_batch == 1 else g_vec,
                          loss=l0, apply_update=apply_update, restore=restore,
                          est_state=est_state, aux={"fzoo_loss_std": std})

    return ZOEstimator(init=init, estimate=estimate, n_seeds=1, eps=eps,
                       dist=dist, name="fzoo", replayable=True, backend=be,
                       batch_seeds=n_batch, selection=sel)


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
    sel = resolve_selection(selection)

    def init(params, key):
        del params, key
        return one_point_init()

    def estimate(loss_fn, params, batch, key, est_state: OnePointState,
                 phase: int = 0):
        ref = StreamRef(key, sel, phase)
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
                       dist=dist, name="one_point", backend=be, selection=sel)


# --------------------------------------------------------------------------- #
# Rescaled SPSA (Definitions 6/7) — block-diagonal D-trees
# --------------------------------------------------------------------------- #
def _leaf_norms(params):
    """RMS per leaf (size-free), floored at 1e-2 so zero-initialized leaves
    don't poison the geometric-mean normalization; one f32 scalar each."""
    return tree_map(lambda p: max(host_f32(torch.sqrt(torch.mean(
        p.float() ** 2))), f32(1e-2)), params)


def _grad_norms_zo(loss_fn, params, batch, key, eps, n_probe: int = 4):
    """Proposition 1 per-leaf gradient-norm estimates (no backprop): the
    RMS over ``n_probe`` single-leaf probes, floored at 1e-6."""
    out = []
    for i in range(len(tree_leaves(params))):
        acc = f32(0.0)
        for j in range(n_probe):
            g = zo_grad_norm(loss_fn, params, batch,
                             fold_in(fold_in(key, i), j), eps,
                             leaf_indices=[i])
            acc = f32(acc + f32(g * g))
        out.append(max(f32(np.sqrt(f32(acc / f32(n_probe)))), f32(1e-6)))
    return tree_unflatten(params, out)


def compute_d_tree(params, key, d_source: str = "param_norm",
                   probe_loss_fn=None, probe_batch=None,
                   probe_eps: float = 1e-4):
    """The block-diagonal D: one positive f32 scalar per leaf, normalized
    to unit geometric mean so the global lr keeps its scale."""
    if d_source == "param_norm":
        d = _leaf_norms(params)
    elif d_source == "grad_norm_zo":
        if probe_loss_fn is None or probe_batch is None:
            raise ValueError("d_source='grad_norm_zo' needs probe_loss_fn and "
                             "probe_batch at init time (Proposition 1 probes)")
        d = _grad_norms_zo(probe_loss_fn, params, probe_batch, key, probe_eps)
    elif d_source == "ones":
        d = tree_map(lambda p: f32(1.0), params)
    else:
        raise ValueError(f"unknown d_source {d_source!r}")
    logs = np.log(np.asarray(tree_leaves(d), f32))
    scale = f32(np.exp(f32(np.mean(logs, dtype=f32))))
    return tree_map(lambda x: f32(f32(x) / scale), d)


def rescaled_spsa(eps: float = 1e-3, dist: str = "gaussian",
                  d_source: str = "param_norm",
                  modify_expectation: bool = False, probe_loss_fn=None,
                  probe_batch=None, probe_eps: float = 1e-4, d_tree=None,
                  backend=None, selection=None) -> ZOEstimator:
    """Definition 6 (unbiased, update along D·z) / Definition 7
    (``modify_expectation=True``: update along z).  Perturbs by ε·(d⁻¹⊙z)
    leaf by leaf (``perturb_leaf``), in place: θ → θ+ε·d⁻¹z → θ−ε·d⁻¹z →
    restored; the update is one ``apply_rank1`` with the D-tree.  The
    D-tree is the estimator state, so it rides through checkpoints; pass
    ``d_tree`` to skip building it at ``init``."""
    be = get_backend(backend)
    be.check_dist(dist)
    sel = resolve_selection(selection)
    if sel is not None and sel.kind == "rows":
        raise ValueError(
            "rescaled_spsa builds its perturbation from per-leaf D·z "
            "(leaf_z + whole-leaf mask math), which cannot honor sub-leaf "
            "rows(...) selections — the perturbation would touch whole "
            "leaves while the update writes only the selected row blocks. "
            "Use a whole-leaf selection kind (full / block_cyclic / leaves "
            "/ peft / moe_experts) or the spsa/fzoo estimators with "
            "rows(...)")

    def init(params, key):
        if d_tree is not None:
            return d_tree
        if params is None:
            raise ValueError("rescaled_spsa.init needs params to build D")
        return compute_d_tree(params, key, d_source, probe_loss_fn,
                              probe_batch, probe_eps)

    def estimate(loss_fn, params, batch, key, est_state, phase: int = 0):
        ref = StreamRef(key, sel, phase)
        mask = ref.selection_mask(params)
        d_leaves = tree_leaves(est_state)

        def pert(sign: float):
            def one(i, p):
                if not is_floating(p) or (mask is not None and not mask[i]):
                    return p
                # ((sign·ε)·d⁻¹)·z with each product rounded to p's dtype
                dt = p.dtype
                s = torch.tensor(float(f32(eps))).to(dt) * sign
                dinv = torch.tensor(float(f32(f32(1.0) / f32(d_leaves[i])))
                                    ).to(dt)
                return be.perturb_leaf(p, ref, i, float(s * dinv), dist)
            return tree_map_with_index(one, params)

        l_plus = host_f32(loss_fn(pert(1.0), batch))
        l_minus = host_f32(loss_fn(pert(-2.0), batch))
        g = (l_plus - l_minus) / f32(2.0 * eps)
        d_for_update = None if modify_expectation else est_state

        def restore():
            return pert(1.0)

        def apply_update(coeff, decay_term):
            return be.apply_rank1(restore(), ref, coeff, decay_term, dist,
                                  d_tree=d_for_update)

        return ZOEstimate(projected_grad=g, loss=f32(0.5) * (l_plus + l_minus),
                          apply_update=apply_update, restore=restore,
                          est_state=est_state, aux={})

    # Definition 7 updates along plain z — a ledger triple reproduces it;
    # Definition 6 updates along D·z, which only the live est_state carries
    return ZOEstimator(init=init, estimate=estimate, n_seeds=1, eps=eps,
                       dist=dist, name="rescaled_spsa",
                       replayable=bool(modify_expectation), backend=be,
                       selection=sel)
