"""``StepProgram`` — the port of ``repro.exec.engine``: one ZO step engine
for every execution plan (local, seed-parallel, the async worker protocol's
building blocks, ledger replay).

The one seed schedule (``group_key``): stream g of step t is
``fold_in(step_key(base, t), g)`` when ``n_groups > 1``, the unfolded step
key when ``n_groups == 1`` — exactly the local facade's per-seed fold, so

* ``seed_parallel(1)`` delegates to the local step: bitwise by construction;
* a local n-SPSA run and a seed-parallel run with the same ``n_groups``
  record interchangeable ledger entries;
* ``apply_group_updates`` is the write path shared by the live
  seed-parallel step and ledger replay: the whole step's
  n_groups × batch_seeds streams go to ONE ``affine_many`` call (K3 on the
  card), with the coefficients (η/n)·g formed as the same f32 operations;
  an async worker applies each contribution through ``apply_group_update``
  (on ``xla``, ``affine_many`` is that fold, one stream at a time).

``seed_parallel(n)``'s groups are evaluated one after another on their
batch slices, all at the step's center parameters.  A plan that carries a
materialized mesh (a ``DeviceMesh``) runs every loss evaluation data
parallel over the mesh's batch axes (``distributed.collectives.
data_parallel_loss``): each rank evaluates its rows of the global batch and
the loss scalars are the step's only collectives; z is regenerated on every
rank.  Every write is in place.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.exec import plan as plan_mod
from repro_torch.exec.plan import ExecPlan, check_replay_plan
from repro_torch.perturb import StreamRef, check_replay_backend, step_key
from repro_torch.perturb.stream import Key, fold_in, prng_key
from repro_torch.select import check_replay_selection
from repro_torch.tree_utils import PyTree, tree_clone, tree_map
from repro_torch.zo.base import TransformCtx, Updates, ZOState
from repro_torch.zo.presets import as_zo_optimizer
from repro_torch.zo.updates import apply_rank1_batch

f32 = np.float32


# --------------------------------------------------------------------------- #
# The one seed schedule
# --------------------------------------------------------------------------- #
def group_key(skey0: Key, group: int, n_groups: int) -> Key:
    """Stream ``group`` of a step: folded when there are several streams,
    the unfolded step key when there is one (== the local schedule)."""
    return fold_in(skey0, group) if n_groups > 1 else skey0


def group_stream_key(base_key: Key, step: int, group: int,
                     n_groups: int) -> Key:
    """run key → step t → group g."""
    return group_key(step_key(base_key, step), group, n_groups)


# --------------------------------------------------------------------------- #
# The one write path (live seed-parallel step == replay)
# --------------------------------------------------------------------------- #
def apply_group_update(params: PyTree, skey0: Key, group: int, n_groups: int,
                       coeff, decay_term, batch_seeds: int, dist: str,
                       backend, selection=None, phase: int = 0) -> PyTree:
    """One group's rank-1 update(s): ``coeff`` is the η-scaled scalar, or the
    (B,) vector of a batched-seed estimator.  ``selection``/``phase`` scope
    it to the step's selected parameters (the phase is the STEP's, shared
    by every group)."""
    gkey = group_key(skey0, group, n_groups)
    if batch_seeds == 1:
        return backend.apply_rank1(params, StreamRef(gkey, selection, phase),
                                   coeff, decay_term, dist)
    return apply_rank1_batch(params, gkey, coeff, decay_term, dist,
                             backend=backend, selection=selection,
                             phase=phase)


def apply_group_updates(params: PyTree, skey0: Key, coeffs: Sequence,
                        decay_term, n_groups: int, batch_seeds: int,
                        dist: str, backend, selection=None,
                        phase: int = 0) -> PyTree:
    """All groups of one step in group order as ONE ``affine_many`` call
    (K3, or K9 under a partial rows plan); decoupled decay once, on stream 0
    of group 0 (``add_weight_decay``'s seed-0 rule); a batched group's
    coefficients are ``coeff_j / B``; every stream scoped to the step's
    selection and phase."""
    refs, cs, ds = [], [], []
    for g in range(n_groups):
        gkey = group_key(skey0, g, n_groups)
        decay_g = decay_term if g == 0 else 0.0
        if batch_seeds == 1:
            refs.append(StreamRef(gkey, selection, phase))
            cs.append(coeffs[g])
            ds.append(decay_g)
            continue
        cvec = np.asarray(coeffs[g], f32)
        for j in range(batch_seeds):
            refs.append(StreamRef(fold_in(gkey, j), selection, phase))
            cs.append(f32(cvec[j] / f32(batch_seeds)))
            ds.append(decay_g if j == 0 else 0.0)
    return backend.affine_many(params, refs, cs, ds, dist)


def slice_group(batch, group: int, n_groups: int):
    """Group ``group``'s shard of the global batch (leading-dim split);
    identity for one group.  Leading dims must divide evenly."""
    if n_groups == 1 or batch is None:
        return batch

    def cut(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x                      # scalar leaves ride along unsliced
        if x.shape[0] % n_groups:
            raise ValueError(
                f"batch leading dim {x.shape[0]} does not divide into "
                f"n_groups={n_groups} slices; {x.shape[0] % n_groups} "
                "trailing row(s) would silently never be evaluated — pad or "
                "resize the batch")
        per = x.shape[0] // n_groups
        return x[group * per:(group + 1) * per]

    return tree_map(cut, batch)


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #
class StepProgram:
    """A ``repro_torch.zo`` optimizer lowered onto an execution plan.

    A non-ZO optimizer (a backprop baseline, ``train.adam.Adam``) runs on
    the ``local`` plan only and passes straight through; its ``meta`` has
    no seed-schedule coordinates (every one is None), as in JAX.

    >>> prog = StepProgram(zo.fzoo(lr=1e-6, batch_seeds=8, backend="pallas"),
    ...                    exec.seed_parallel(2))
    >>> state = prog.init(params, seed=0)
    >>> step = prog.step_fn(loss_fn)
    >>> params, state, metrics = step(params, state, batch)
    """

    def __init__(self, optimizer, plan: Optional[ExecPlan] = None):
        self.plan = plan if plan is not None else plan_mod.local()
        if callable(getattr(optimizer, "replay_update", None)) or \
                getattr(optimizer, "estimator", None) is not None or \
                (hasattr(optimizer, "eps") and hasattr(optimizer, "dist")):
            self.opt = as_zo_optimizer(optimizer)
            self.is_zo = True
        else:
            # a backprop baseline (train.adam): the local plan only, passed
            # straight through
            self.opt = optimizer
            self.is_zo = False
            if self.plan.kind != "local":
                raise ValueError(
                    f"{type(optimizer).__name__} is not a seed-replayable ZO "
                    f"optimizer; only the local plan can run it "
                    f"(got {self.plan.kind!r})")
            return
        est = self.opt.estimator
        n = self.plan.n_groups
        if self.plan.kind in ("seed_parallel", "async_worker"):
            if est.n_seeds not in (1, n):
                raise ValueError(
                    f"estimator {est.name!r} declares n_seeds={est.n_seeds} "
                    f"but the {self.plan.kind} plan runs n_groups={n}; the "
                    "plan's groups ARE the seed streams — use n_seeds=1 or "
                    f"n_seeds={n}")
            one_group = self.plan.kind == "seed_parallel" and n == 1
            if self.opt.info.get("applier") and not one_group:
                raise ValueError(
                    "applier transforms (scale_by_zo_adam / trace) "
                    "materialize their update from the live tree and "
                    "g-history; group updates are wire-replayable rank-1 "
                    "applications — run appliers under the local plan")
            if not est.replayable and not one_group:
                raise ValueError(
                    f"the {est.name!r} estimator updates along D·z "
                    "(Definition 6), which the plan's rank-1 group updates "
                    "cannot reproduce; use modify_expectation=True or the "
                    "local plan")
            if n > 1 and self.opt.info.get("lr_at") is None:
                raise ValueError(
                    f"the {self.plan.kind} plan needs a transform chain with "
                    "scale_by_schedule (its group updates and their replay "
                    "reconstruct coefficients as (η/n)·g from the recorded "
                    "learning rate); compose via zo.mezo/zo.fzoo or add "
                    "transforms.scale_by_schedule to the chain")

    # -- identity ----------------------------------------------------------- #
    @property
    def n_groups(self) -> Optional[int]:
        """Seed streams folded per step at the group level: the plan's
        groups, or — under the local plan — the estimator's n_seeds (None
        for a backprop baseline)."""
        if not self.is_zo:
            return None
        if self.plan.kind == "local":
            return int(self.opt.estimator.n_seeds)
        return int(self.plan.n_groups)

    @property
    def batch_seeds(self) -> Optional[int]:
        return self.opt.batch_seeds if self.is_zo else None

    @property
    def backend_name(self) -> Optional[str]:
        return self.opt.backend_name if self.is_zo else None

    @property
    def selection(self):
        return self.opt.selection if self.is_zo else None

    @property
    def meta(self) -> dict:
        """The artifact stamp: what a resume/replay needs to re-derive (or
        refuse to re-derive) the run's seed schedule; a backprop baseline
        has none, and every coordinate is None."""
        zo = self.is_zo
        return {"perturb_backend": self.backend_name,
                "batch_seeds": self.batch_seeds,
                "exec_plan": self.plan.kind if zo else None,
                "n_groups": self.n_groups,
                "selection": self.opt.selection_spec if zo else None,
                "sel_phase": self.opt.selection_phase if zo else None}

    # -- protocol delegation ------------------------------------------------ #
    def init(self, params: Optional[PyTree] = None, *, seed: int = 0):
        return self.opt.init(params, seed=seed)

    def restore(self, state, step: int):
        return self.opt.restore(state, step)

    def step_fn(self, loss_fn) -> Callable:
        if self.plan.mesh is not None and self.plan.kind != "replay":
            if not self.is_zo:
                raise ValueError(
                    f"{type(self.opt).__name__} differentiates its loss; a "
                    "plan's mesh reduces forward-only loss scalars — run "
                    "the backprop baselines without a mesh")
            from repro_torch.distributed.collectives import \
                data_parallel_loss
            loss_fn = data_parallel_loss(loss_fn, self.plan.mesh)
        if not self.is_zo or self.plan.kind == "local":
            return self.opt.step_fn(loss_fn)
        if self.plan.kind == "seed_parallel":
            if self.plan.n_groups == 1:
                # one group == one unfolded stream == the local plan
                return self.opt.step_fn(loss_fn)
            return self._seed_parallel_step_fn(loss_fn)
        if self.plan.kind == "async_worker":
            raise ValueError(
                "the async_worker plan has no monolithic step function — "
                "drive it through repro_torch.distributed.async_zo."
                "AsyncZOWorker (contribution_eval_fn / apply_contribution)")
        raise ValueError(
            "the replay plan is ledger-driven (no forward passes): call "
            "StepProgram.replay(params0, ledger) instead of step_fn")

    # -- seed-parallel lowering (n_groups > 1), groups one after another --- #
    def _seed_parallel_step_fn(self, loss_fn) -> Callable:
        opt = self.opt
        est, tf = opt.estimator, opt.transform
        n = self.plan.n_groups
        backend = opt.backend
        batch_seeds = opt.batch_seeds
        sel = opt.selection

        @torch.no_grad()
        def step(params: PyTree, state: ZOState, batch):
            skey0 = step_key(state.base_key, state.step)
            # the schedule phase is a function of the step counter alone,
            # so it is the same under every plan
            phase = opt.phase_at(state.step)
            p = params
            est_state, tf_state = state.est_state, state.tf_state
            gs, losses, coeffs = [], [], []
            aux: dict = {}
            lr_metric = None
            decay0 = 0.0
            for g in range(n):
                skey = group_key(skey0, g, n)
                e = est.estimate(loss_fn, p, slice_group(batch, g, n), skey,
                                 est_state, phase=phase)
                est_state = e.est_state
                ctx = TransformCtx(step=state.step, base_key=state.base_key,
                                   key=skey, seed_index=g, n_seeds=n,
                                   eps=est.eps, dist=est.dist,
                                   restore=e.restore, backend=backend)
                u, tf_state = tf.update(Updates(g=e.projected_grad), tf_state,
                                        ctx)
                # evaluations stay at the step's center; directions are
                # averaged afterwards through the shared write path
                p = e.restore()
                coeffs.append(u.coeff if u.coeff is not None else u.g)
                if g == 0:
                    decay0 = u.decay
                gs.append(u.g)
                losses.append(e.loss)
                aux.update(e.aux)
                lr_metric = u.lr
            p = apply_group_updates(p, skey0, coeffs, decay0, n, batch_seeds,
                                    est.dist, backend, selection=sel,
                                    phase=phase)
            g_mean = f32(np.mean(np.stack(gs)))
            new_state = ZOState(state.step + 1, state.base_key, est_state,
                                tf_state, g_mean)
            metrics = {"loss": f32(np.mean(np.stack(losses))),
                       "projected_grad": g_mean,
                       "lr": f32(1.0) if lr_metric is None else lr_metric,
                       **aux,
                       "projected_grads": np.stack(gs).reshape(-1)}
            return p, new_state, metrics

        return step

    def shardings(self, params_like: PyTree, batch_like=None,
                  state_like=None):
        """(params, state, batch) shardings under the plan's mesh:
        parameters through the ``sharding.py`` rule engine, optimizer state
        replicated when ``state_like`` is given (``None`` otherwise), batch
        leaves split on their leading axis over the mesh's batch axes —
        MeZO's cross-device traffic stays the loss scalars.  Each is a
        ``NamedSharding`` whose ``placements`` DTensor takes."""
        mesh = self.plan.mesh
        if mesh is None:
            raise ValueError("this plan carries no mesh; construct it as "
                             "exec.seed_parallel(n, mesh=...)")
        from repro_torch.distributed.sharding import (P, NamedSharding,
                                                      batch_axes,
                                                      device_mesh_of,
                                                      param_shardings)
        pshard = param_shardings(params_like, mesh)
        dm = device_mesh_of(mesh)
        sshard = None
        if state_like is not None:
            sshard = tree_map(lambda _: NamedSharding(dm, P()), state_like)
        ba = batch_axes(dm)
        b_ax = ba if len(ba) > 1 else (ba[0] if ba else None)
        bshard = None
        if batch_like is not None:
            bshard = tree_map(
                lambda x: NamedSharding(
                    dm, P(b_ax) if isinstance(x, torch.Tensor) and x.dim()
                    else P()),
                batch_like)
        return pshard, sshard, bshard

    # -- async building blocks (consumed by distributed.async_zo) ----------- #
    def contribution_eval_fn(self, loss_fn, worker: int,
                             est_state=None) -> Callable:
        """``fn(params, base_key, step, batch, phase=0) -> (g, lr, loss)``:
        evaluate this worker's seed group of one step through the estimator
        and the scalar transform chain (what goes on the wire is the
        post-transform g — the scalar a seed-parallel step records).  The
        estimator runs on a copy of ``params``, whose bits stay as they were
        (JAX's evaluation is pure; the port's perturbations are in place).
        ``phase`` is the step's block-schedule phase, which the worker
        derives from its step counter as every plan does."""
        opt = self.opt
        est, tf = opt.estimator, opt.transform
        n = self.plan.n_groups

        @torch.no_grad()
        def fn(params, base_key, step, batch, phase: int = 0):
            skey = group_stream_key(base_key, step, worker, n)
            e_state = (est_state if est_state is not None
                       else est.init(None, base_key))
            e = est.estimate(loss_fn, tree_clone(params), batch, skey,
                             e_state, phase=phase)
            ctx = TransformCtx(step=step, base_key=base_key, key=skey,
                               seed_index=worker, n_seeds=n, eps=est.eps,
                               dist=est.dist, restore=e.restore,
                               backend=opt.backend)
            u, _ = tf.update(Updates(g=e.projected_grad), tf.init(None), ctx)
            lr = u.lr if u.lr is not None else f32(1.0)
            return u.g, lr, e.loss

        return fn

    def apply_contribution_fn(self) -> Callable:
        """``fn(params, skey0, group, g, lr, decay_on, phase=0) -> params``
        applying one group's contribution for the step whose key is
        ``skey0``, in place — the floats a ledger replay of that group
        performs: coefficient (η/n)·g, decay η·λ·decay_on (the step's decay
        rides group 0), each one f32 operation in JAX's order."""
        opt = self.opt
        n = self.plan.n_groups
        batch_seeds = opt.batch_seeds
        dist = opt.estimator.dist
        backend = opt.backend
        wd = f32(opt.weight_decay)
        sel = opt.selection

        @torch.no_grad()
        def fn(params, skey0, group, g, lr, decay_on, phase: int = 0):
            lr = f32(lr)
            coeff = (lr / f32(n)) * np.asarray(g, f32)
            if coeff.ndim == 0:
                coeff = f32(coeff)
            decay = (lr * wd) * f32(decay_on)
            return apply_group_update(params, skey0, int(group), n, coeff,
                                      decay, batch_seeds, dist, backend,
                                      selection=sel, phase=phase)

        return fn

    # -- ledger replay ------------------------------------------------------ #
    @torch.no_grad()
    def replay(self, params0: PyTree, ledger, from_idx: int = 0,
               to_idx: Optional[int] = None) -> PyTree:
        """Reconstruct parameters from a scalar ledger — no forward passes,
        no data (paper §2.1) — writing into ``params0``'s leaves in place.

        The coordinate checks and their errors are JAX's: backend
        (``BackendMismatchError``), selection (``SelectionMismatchError``),
        batch_seeds (``ValueError``) and n_groups (``PlanMismatchError``).
        A program on the ``replay()`` plan adopts the ledger's n_groups; any
        other plan must match it (the resume path)."""
        opt = self.opt
        check_replay_backend(getattr(ledger, "backend", None),
                             self.backend_name, "trajectory ledger")
        check_replay_selection(getattr(ledger, "selection", None),
                               opt.selection_spec, "trajectory ledger",
                               getattr(ledger, "sel_phase", 0),
                               opt.selection_phase)
        led_bs = int(getattr(ledger, "batch_seeds", 1))
        if len(ledger.steps) and led_bs != int(opt.batch_seeds):
            raise ValueError(
                f"trajectory ledger records {led_bs} seed scalar(s) per "
                f"group but the optimizer evaluates batch_seeds="
                f"{opt.batch_seeds}; the seed fold schedule (and the "
                "per-step g shape) differ, so replay would misapply the "
                "updates — replay with a matching fzoo(batch_seeds=...) "
                "composition")
        n = int(getattr(ledger, "n_groups", 1))
        if self.plan.kind != "replay":    # the replay plan is ledger-driven
            check_replay_plan(n, self.n_groups, "trajectory ledger",
                              recorded_kind=getattr(ledger, "exec_plan", None),
                              active_kind=self.plan.kind)
        if n > 1:
            if opt.info.get("applier"):
                raise ValueError(
                    f"{opt.name}: scalar-ledger replay cannot reproduce "
                    "applier transforms (scale_by_zo_adam / trace); resume "
                    "from a full state checkpoint instead of a ledger tail")
            if not opt.estimator.replayable:
                raise ValueError(
                    f"{opt.name}: the {opt.estimator.name!r} estimator "
                    "updates along D·z (Definition 6), which a (seed, g, lr) "
                    "ledger entry cannot reproduce; resume from a full state "
                    "checkpoint")
            if opt.info.get("lr_at") is None:
                raise ValueError(
                    f"{opt.name}: multi-group replay reconstructs "
                    "coefficients as (η/n)·g from the recorded learning "
                    "rate, but this transform chain has no "
                    "scale_by_schedule — the live step applied raw g, which "
                    "a (seed, g, lr) entry cannot re-scale; resume from a "
                    "full state checkpoint")
        base_key = prng_key(ledger.base_seed)
        to_idx = len(ledger.steps) if to_idx is None else to_idx
        batch_seeds = int(opt.batch_seeds)
        wd = f32(opt.weight_decay)
        p = params0
        for i in range(from_idx, to_idx):
            step = int(ledger.steps[i])
            skey0 = step_key(base_key, step)
            # each record's schedule phase from its step, as the live step
            # derived it
            phase = opt.phase_at(step)
            g = np.asarray(ledger.grads[i], f32)
            lr = f32(ledger.lrs[i])
            if n == 1:
                # single-group entries: the optimizer's own replay primitive
                p = opt.replay_update(p, skey0, g, lr, phase=phase)
                continue
            g_mat = g.reshape(n, batch_seeds)
            coeffs = [(lr / f32(n)) * (g_mat[k] if batch_seeds > 1
                                       else g_mat[k, 0]) for k in range(n)]
            p = apply_group_updates(p, skey0, coeffs, lr * wd, n,
                                    batch_seeds, opt.estimator.dist,
                                    opt.backend, selection=opt.selection,
                                    phase=phase)
        return p

    def replay_update(self, params, skey, g, lr, phase: int = 0):
        """Single-entry delegation (kept for protocol compatibility)."""
        return self.opt.replay_update(params, skey, g, lr, phase=phase)


def as_step_program(optimizer, plan: Optional[ExecPlan] = None) -> StepProgram:
    if isinstance(optimizer, StepProgram):
        if plan is not None and plan != optimizer.plan:
            raise ValueError("optimizer is already a StepProgram with a "
                             f"{optimizer.plan.kind!r} plan; cannot re-plan "
                             f"it as {plan.kind!r} — build a new StepProgram")
        return optimizer
    return StepProgram(optimizer, plan)
