"""``StepProgram`` — the port of ``repro.exec.engine``: one ZO step engine
for the local and seed-parallel plans and for ledger replay.

The one seed schedule (``group_key``): stream g of step t is
``fold_in(step_key(base, t), g)`` when ``n_groups > 1``, the unfolded step
key when ``n_groups == 1`` — exactly the local facade's per-seed fold, so

* ``seed_parallel(1)`` delegates to the local step: bitwise by construction;
* a local n-SPSA run and a seed-parallel run with the same ``n_groups``
  record interchangeable ledger entries;
* ``apply_group_updates`` is the write path shared by the live
  seed-parallel step and ledger replay: the whole step's
  n_groups × batch_seeds streams go to ONE ``affine_many`` call (K3 on the
  card), with the coefficients (η/n)·g formed as the same f32 operations.

``seed_parallel(n)`` runs on one card here: its groups are evaluated one
after another on their batch slices, all at the step's center parameters
(distribution across cards is a later slice).  The async plan's worker
protocol comes with that slice too.  Every write is in place.
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
from repro_torch.tree_utils import PyTree
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
                       backend) -> PyTree:
    """One group's rank-1 update(s): ``coeff`` is the η-scaled scalar, or the
    (B,) vector of a batched-seed estimator."""
    gkey = group_key(skey0, group, n_groups)
    if batch_seeds == 1:
        return backend.apply_rank1(params, StreamRef(gkey), coeff,
                                   decay_term, dist)
    return apply_rank1_batch(params, gkey, coeff, decay_term, dist,
                             backend=backend)


def apply_group_updates(params: PyTree, skey0: Key, coeffs: Sequence,
                        decay_term, n_groups: int, batch_seeds: int,
                        dist: str, backend) -> PyTree:
    """All groups of one step in group order as ONE ``affine_many`` call;
    decoupled decay once, on stream 0 of group 0 (``add_weight_decay``'s
    seed-0 rule); a batched group's coefficients are ``coeff_j / B``."""
    refs, cs, ds = [], [], []
    for g in range(n_groups):
        gkey = group_key(skey0, g, n_groups)
        decay_g = decay_term if g == 0 else 0.0
        if batch_seeds == 1:
            refs.append(StreamRef(gkey))
            cs.append(coeffs[g])
            ds.append(decay_g)
            continue
        cvec = np.asarray(coeffs[g], f32)
        for j in range(batch_seeds):
            refs.append(StreamRef(fold_in(gkey, j)))
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

    return {k: cut(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #
class StepProgram:
    """A ``repro_torch.zo`` optimizer lowered onto an execution plan.

    >>> prog = StepProgram(zo.fzoo(lr=1e-6, batch_seeds=8, backend="pallas"),
    ...                    exec.seed_parallel(2))
    >>> state = prog.init(params, seed=0)
    >>> step = prog.step_fn(loss_fn)
    >>> params, state, metrics = step(params, state, batch)
    """

    def __init__(self, optimizer, plan: Optional[ExecPlan] = None):
        self.plan = plan if plan is not None else plan_mod.local()
        self.opt = as_zo_optimizer(optimizer)
        est = self.opt.estimator
        n = self.plan.n_groups
        if self.plan.kind in ("seed_parallel", "async_worker"):
            if est.n_seeds not in (1, n):
                raise ValueError(
                    f"estimator {est.name!r} declares n_seeds={est.n_seeds} "
                    f"but the {self.plan.kind} plan runs n_groups={n}; the "
                    "plan's groups ARE the seed streams — use n_seeds=1 or "
                    f"n_seeds={n}")
            if not est.replayable and n > 1:
                raise ValueError(
                    f"the {est.name!r} estimator updates along D·z "
                    "(Definition 6), which the plan's rank-1 group updates "
                    "cannot reproduce; use the local plan")
            if n > 1 and self.opt.info.get("lr_at") is None:
                raise ValueError(
                    f"the {self.plan.kind} plan needs a transform chain with "
                    "scale_by_schedule (its group updates and their replay "
                    "reconstruct coefficients as (η/n)·g from the recorded "
                    "learning rate); compose via zo.mezo/zo.fzoo or add "
                    "transforms.scale_by_schedule to the chain")

    # -- identity ----------------------------------------------------------- #
    @property
    def n_groups(self) -> int:
        """Seed streams folded per step at the group level: the plan's
        groups, or — under the local plan — the estimator's n_seeds."""
        if self.plan.kind == "local":
            return int(self.opt.estimator.n_seeds)
        return int(self.plan.n_groups)

    @property
    def batch_seeds(self) -> int:
        return self.opt.batch_seeds

    @property
    def backend_name(self) -> str:
        return self.opt.backend_name

    @property
    def selection(self):
        return self.opt.selection

    @property
    def meta(self) -> dict:
        """The artifact stamp: what a resume/replay needs to re-derive (or
        refuse to re-derive) the run's seed schedule."""
        return {"perturb_backend": self.backend_name,
                "batch_seeds": self.batch_seeds,
                "exec_plan": self.plan.kind,
                "n_groups": self.n_groups,
                "selection": self.opt.selection_spec,
                "sel_phase": self.opt.selection_phase}

    # -- protocol delegation ------------------------------------------------ #
    def init(self, params: Optional[PyTree] = None, *, seed: int = 0):
        return self.opt.init(params, seed=seed)

    def restore(self, state, step: int):
        return self.opt.restore(state, step)

    def step_fn(self, loss_fn) -> Callable:
        if self.plan.kind == "local":
            return self.opt.step_fn(loss_fn)
        if self.plan.kind == "seed_parallel":
            if self.plan.n_groups == 1:
                # one group == one unfolded stream == the local plan
                return self.opt.step_fn(loss_fn)
            return self._seed_parallel_step_fn(loss_fn)
        if self.plan.kind == "async_worker":
            raise ValueError(
                "the async_worker plan has no monolithic step function; its "
                "worker protocol is ported with the distribution slice")
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

        @torch.no_grad()
        def step(params: PyTree, state: ZOState, batch):
            skey0 = step_key(state.base_key, state.step)
            p = params
            est_state, tf_state = state.est_state, state.tf_state
            gs, losses, coeffs = [], [], []
            aux: dict = {}
            lr_metric = None
            decay0 = 0.0
            for g in range(n):
                skey = group_key(skey0, g, n)
                e = est.estimate(loss_fn, p, slice_group(batch, g, n), skey,
                                 est_state)
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
                                    est.dist, backend)
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
            skey0 = step_key(base_key, int(ledger.steps[i]))
            g = np.asarray(ledger.grads[i], f32)
            lr = f32(ledger.lrs[i])
            if n == 1:
                # single-group entries: the optimizer's own replay primitive
                p = opt.replay_update(p, skey0, g, lr)
                continue
            g_mat = g.reshape(n, batch_seeds)
            coeffs = [(lr / f32(n)) * (g_mat[k] if batch_seeds > 1
                                       else g_mat[k, 0]) for k in range(n)]
            p = apply_group_updates(p, skey0, coeffs, lr * wd, n,
                                    batch_seeds, opt.estimator.dist,
                                    opt.backend)
        return p

    def replay_update(self, params, skey, g, lr):
        """Single-entry delegation (kept for protocol compatibility)."""
        return self.opt.replay_update(params, skey, g, lr)


def as_step_program(optimizer, plan: Optional[ExecPlan] = None) -> StepProgram:
    if isinstance(optimizer, StepProgram):
        if plan is not None and plan != optimizer.plan:
            raise ValueError("optimizer is already a StepProgram with a "
                             f"{optimizer.plan.kind!r} plan; cannot re-plan "
                             f"it as {plan.kind!r} — build a new StepProgram")
        return optimizer
    return StepProgram(optimizer, plan)
