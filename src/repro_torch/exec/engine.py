"""``StepProgram`` — the port of ``repro.exec.engine``, so far its ledger
replay: ``StepProgram.replay`` for single-group (n_groups = 1),
single-stream (batch_seeds = 1), full-selection ledgers.  The live step
plans (local, seed_parallel, async) come with the training and multi-seed
slices.

The seed schedule is JAX's: the stream of step t is ``step_key(base, t)``
(unfolded, since n_groups == 1), and each record goes through the
optimizer's own ``replay_update`` — the same ``apply_rank1`` write path the
live step uses, writing in place.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.exec import plan as plan_mod
from repro_torch.exec.plan import ExecPlan, check_replay_plan
from repro_torch.perturb import check_replay_backend, prng_key, step_key
from repro_torch.select import check_replay_selection
from repro_torch.tree_utils import PyTree
from repro_torch.zo.presets import as_zo_optimizer


class StepProgram:
    """A ``repro_torch.zo`` optimizer lowered onto an execution plan."""

    def __init__(self, optimizer, plan: Optional[ExecPlan] = None):
        self.plan = plan if plan is not None else plan_mod.local()
        self.opt = as_zo_optimizer(optimizer)

    @property
    def n_groups(self) -> int:
        if self.plan.kind == "local":
            return int(self.opt.estimator.n_seeds)
        return int(self.plan.n_groups)

    @property
    def batch_seeds(self) -> int:
        return self.opt.batch_seeds

    @property
    def backend_name(self) -> str:
        return self.opt.backend_name

    def replay(self, params0: PyTree, ledger, from_idx: int = 0,
               to_idx: Optional[int] = None) -> PyTree:
        """Reconstruct parameters from a scalar ledger — no forward passes,
        no data (paper §2.1).  ``params0``'s leaves are updated in place and
        returned.  The coordinate checks and their errors are JAX's:
        backend (``BackendMismatchError``), selection
        (``SelectionMismatchError``), batch_seeds (``ValueError``) and
        n_groups (``PlanMismatchError``)."""
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
        led_n = int(getattr(ledger, "n_groups", 1))
        # the replay plan adopts the ledger's n_groups in JAX; this slice
        # replays single-group ledgers, so hold every plan to n_groups == 1
        active_n = self.n_groups if self.plan.kind != "replay" else 1
        check_replay_plan(led_n, active_n, "trajectory ledger",
                          recorded_kind=getattr(ledger, "exec_plan", None),
                          active_kind=self.plan.kind)
        base_key = prng_key(ledger.base_seed)
        to_idx = len(ledger.steps) if to_idx is None else to_idx
        p = params0
        for i in range(from_idx, to_idx):
            p = opt.replay_update(p, step_key(base_key, int(ledger.steps[i])),
                                  ledger.grads[i], ledger.lrs[i])
        return p


def as_step_program(optimizer, plan: Optional[ExecPlan] = None) -> StepProgram:
    if isinstance(optimizer, StepProgram):
        if plan is not None and plan != optimizer.plan:
            raise ValueError("optimizer is already a StepProgram with a "
                             f"{optimizer.plan.kind!r} plan; cannot re-plan "
                             f"it as {plan.kind!r} — build a new StepProgram")
        return optimizer
    return StepProgram(optimizer, plan)
