"""Execution plans — the port of ``repro.exec.plan`` (verbatim: plain
Python).  *Where/how* a ZO step runs, orthogonal to *what* it is.

A MeZO step is fully determined by a seed and a handful of scalars (paper
§2.1), so one step definition can be lowered onto very different execution
strategies.  An ``ExecPlan`` names the strategy; ``repro.exec.engine`` owns
the lowering:

``local()``
    Today's single-program step: the optimizer facade's jit+donate loop step,
    unchanged (the engine delegates to ``ZOOptimizer.step_fn``).

``seed_parallel(n_groups, mesh=None)``
    The global batch is split into ``n_groups`` slices; seed group g is
    evaluated only on slice g, all groups at the step's center parameters,
    and the n rank-1 directions are averaged (η/n each).  Under jit with the
    batch sharded over 'data' (pass ``mesh`` and use
    ``StepProgram.shardings``), slice g's loss reductions are data-local, so
    the only cross-device traffic is the 2n loss scalars.

``async_worker(n_workers, max_staleness=4)``
    The gossip-ring contribution protocol: worker w evaluates seed group w of
    each step on its own shard and broadcasts the scalar; contributions apply
    up to ``max_staleness`` steps late.  Staleness 0 is seed_parallel with
    per-worker jits.

``replay()``
    Ledger-driven: no forward passes, no data — reconstruct parameters from
    (seed, g, lr) records.  The engine reads the plan coordinates
    (``n_groups``, ``batch_seeds``, backend) from the ledger header.

One seed schedule serves every plan: stream g of step t is
``fold_in(step_key(base, t), g)`` when ``n_groups > 1`` and the unfolded
``step_key(base, t)`` when ``n_groups == 1`` — which is exactly the local
facade's per-seed fold, so ``seed_parallel(1)`` is bitwise-identical to
``local`` and a ledger written under any plan replays under ``replay()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PLAN_KINDS = ("local", "seed_parallel", "async_worker", "replay")


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """One execution strategy for a ZO step program.

    ``n_groups`` is the number of independent seed streams folded per step at
    the group level (batch slices for seed_parallel, workers for
    async_worker).  ``mesh`` optionally names the jax device mesh the
    seed-parallel plan shards over (metadata never records it — the stream
    schedule is mesh-invariant, that is the point).  ``max_staleness`` only
    applies to async_worker.
    """
    kind: str
    n_groups: int = 1
    mesh: Optional[object] = None
    max_staleness: int = 4

    def __post_init__(self):
        if self.kind not in PLAN_KINDS:
            raise ValueError(f"unknown exec plan kind {self.kind!r}; "
                             f"available: {PLAN_KINDS}")
        if self.n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {self.n_groups}")


def local() -> ExecPlan:
    return ExecPlan("local")


def seed_parallel(n_groups: int, mesh=None) -> ExecPlan:
    return ExecPlan("seed_parallel", n_groups=int(n_groups), mesh=mesh)


def async_worker(n_workers: int, max_staleness: int = 4) -> ExecPlan:
    return ExecPlan("async_worker", n_groups=int(n_workers),
                    max_staleness=int(max_staleness))


def replay() -> ExecPlan:
    return ExecPlan("replay")


class PlanMismatchError(RuntimeError):
    """A seed-replay artifact (ledger / checkpoint) was produced under one
    execution plan's seed schedule and is being resumed/replayed under a
    different one.  ``n_groups`` determines the batch-slice → seed-stream
    assignment (the fold schedule), so continuing would silently assign
    different z streams to the recorded scalars — refuse instead."""


def check_replay_plan(recorded_n_groups: Optional[int],
                      active_n_groups: Optional[int], what: str,
                      recorded_kind: Optional[str] = None,
                      active_kind: Optional[str] = None) -> None:
    """Raise ``PlanMismatchError`` on an ``n_groups`` mismatch.

    The seed schedule is a pure function of ``n_groups`` (plan kinds share
    it), so kind differences at equal ``n_groups`` are allowed — an async
    staleness-0 ledger replays under ``replay()``, a seed-parallel checkpoint
    resumes under local n-SPSA with the same n.  ``None`` on either side (a
    pre-engine artifact, or a non-ZO optimizer) skips the check.
    """
    if recorded_n_groups is None or active_n_groups is None:
        return
    if int(recorded_n_groups) != int(active_n_groups):
        rk = f" ({recorded_kind})" if recorded_kind else ""
        ak = f" ({active_kind})" if active_kind else ""
        raise PlanMismatchError(
            f"{what} was recorded with n_groups={int(recorded_n_groups)}{rk} "
            f"but the active step program runs n_groups="
            f"{int(active_n_groups)}{ak}; the batch-slice → seed-stream "
            "assignment (the per-step fold schedule) differs, so resuming "
            "would silently pair the recorded scalars with different z "
            "streams.  Re-create the program with a matching plan (e.g. "
            f"exec.seed_parallel({int(recorded_n_groups)})).")
