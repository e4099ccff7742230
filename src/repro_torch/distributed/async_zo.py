"""Bounded-staleness asynchronous MeZO (straggler mitigation, beyond the
paper) — the port of ``repro.distributed.async_zo``.

A ZO update is the rank-1 tensor −η·g·z(seed) with a SCALAR coefficient, so
updates commute cheaply and can be applied late: a straggling worker's
(step, worker, g) contribution can reach peers a few steps after the fact,
and every worker folds it in whenever it arrives.  Workers never exchange
tensors — the wire format is a few bytes per contribution (g as an f32,
which a Python float holds exactly).

The worker is pure *policy* (outbox, staleness window, dedup) over
``repro_torch.exec.StepProgram`` on the ``async_worker`` plan: local
evaluation is the optimizer's estimator plus the scalar transform chain
(``contribution_eval_fn``, on a copy of the worker's θ), and remote
application is the engine's shared write path (``apply_contribution_fn`` →
``PerturbBackend.apply_rank1``), so a late contribution regenerates the
identical z and performs the floats a ledger replay of it performs.

The seed schedule is the engine's: worker w's stream at step t is
``fold_in(step_key(base, t), w)`` (unfolded at n_workers == 1), the schedule
seed-parallel groups and local n-SPSA seeds use — an async staleness-0
round, a seed-parallel step and a ledger replay are the same multiset of
rank-1 updates.  Each worker holds its own copy of θ and writes it in
place; at staleness 0 the workers apply the same writes in the same order
and stay bitwise equal.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Sequence, Union

import numpy as np

from repro_torch.exec import StepProgram, group_stream_key
from repro_torch.exec import plan as plan_mod
from repro_torch.perturb import prng_key, step_key
from repro_torch.perturb.stream import Key
from repro_torch.tree_utils import PyTree, tree_clone, tree_leaves
from repro_torch.zo.presets import as_zo_optimizer

f32 = np.float32


@dataclasses.dataclass
class Contribution:
    step: int
    worker: int
    # one scalar per stream: a float (B=1) or a length-B tuple (batched-seed
    # estimators — fzoo workers put their per-stream vector on the wire)
    projected_grad: Union[float, tuple]
    lr: float


def worker_seed_key(base_key: Key, step: int, worker: int,
                    n_workers: int) -> Key:
    """Deprecated alias for the engine's seed schedule.  ``n_workers`` is
    REQUIRED because the schedule depends on it (one worker uses the
    unfolded step key); legacy 3-argument callers fail loudly here instead
    of silently deriving a stream that matches neither schedule."""
    return group_stream_key(base_key, step, worker, n_workers)


class AsyncZOWorker:
    """One logical worker of the gossip ring (driven in-process by tests; a
    deployment pushes ``Contribution`` records over its own transport).

    ``optimizer`` is a ``repro_torch.zo`` protocol conformer
    (``zo.mezo(...)``, ``zo.fzoo(...)``) or a legacy ``MeZOConfig``.  The
    worker keeps its own copy of ``params`` (the caller's tree is not
    written)."""

    def __init__(self, worker_id: int, n_workers: int, params: PyTree,
                 loss_fn: Callable, optimizer, base_seed: int = 0,
                 max_staleness: int = 4):
        self.w = worker_id
        self.n = n_workers
        self.loss_fn = loss_fn
        self.opt = as_zo_optimizer(optimizer)
        self.prog = StepProgram(
            self.opt, plan_mod.async_worker(n_workers, max_staleness))
        self.base_key = prng_key(base_seed)
        self.max_staleness = max_staleness
        self.outbox: deque[Contribution] = deque()
        self.applied: set = set()
        self.step = 0
        self._est_state = self.opt.estimator.init(params, self.base_key)
        if tree_leaves(self._est_state) and \
                self.opt.estimator.name != "rescaled_spsa":
            # a carried estimator state (e.g. one_point's residual) would be
            # frozen into the evaluation below and never advance; the async
            # path supports stateless-per-step estimators only (the
            # rescaled D-tree is constant after init, so it is fine)
            raise ValueError(
                f"AsyncZOWorker needs a stateless estimator; "
                f"{self.opt.estimator.name!r} carries per-step state")
        self.params = tree_clone(params)
        # the selection's block-schedule phase is a pure function of the
        # step index, the same every plan uses, so an async round's
        # contributions land on the leaf blocks a seed-parallel step (or a
        # ledger replay) of that round touches
        self._sel = self.prog.selection
        self._eval = self.prog.contribution_eval_fn(
            loss_fn, worker_id, est_state=self._est_state)
        self._apply = self.prog.apply_contribution_fn()

    def _phase(self, step: int) -> int:
        return 0 if self._sel is None else int(self._sel.phase_at(int(step)))

    # ---- local estimation (the optimizer's own estimator chain) ---------- #
    def produce(self, batch) -> Contribution:
        """Evaluate this worker's seed group for its current step and run the
        scalar transform chain — what goes on the wire is the post-transform
        g, the scalar a seed-parallel step of this round records."""
        g, lr, _ = self._eval(self.params, self.base_key, self.step, batch,
                              phase=self._phase(self.step))
        g_wire = (tuple(float(x) for x in np.asarray(g, f32))
                  if np.ndim(g) > 0 else float(f32(g)))
        contrib = Contribution(self.step, self.w, g_wire, float(f32(lr)))
        self.outbox.append(contrib)
        self.step += 1
        return contrib

    def consume(self, contrib: Contribution) -> bool:
        """Apply a (possibly remote, possibly stale) contribution in place
        through the engine's shared write path.

        Decay caveat (weight_decay > 0): the step's decoupled η·λ decay
        rides worker 0's contribution (the engine's group-0 rule, matching
        seed-parallel and ledger replay).  If worker 0's contribution for a
        step falls outside the staleness window and is dropped, that step's
        decay is dropped with it — peers that applied it diverge by the
        (1 − η·λ) factor, not just the missing rank-1 term."""
        key = (contrib.step, contrib.worker)
        if key in self.applied:
            return False
        if contrib.step < self.step - self.max_staleness:
            return False          # too stale: dropped (bounded staleness)
        self.params = self._apply(
            self.params, step_key(self.base_key, int(contrib.step)),
            contrib.worker, np.asarray(contrib.projected_grad, f32),
            f32(contrib.lr), f32(1.0 if contrib.worker == 0 else 0.0),
            phase=self._phase(contrib.step))
        self.applied.add(key)
        return True


def run_sync_equivalent(workers: list, batches_for) -> None:
    """Drive one fully synchronous round: every worker produces, then every
    worker consumes every contribution (staleness 0)."""
    contribs = [w.produce(batches_for(w.w, w.step)) for w in workers]
    for w in workers:
        for cb in contribs:
            w.consume(cb)


def contributions_to_ledger(ledger, contribs: Sequence[Contribution],
                            n_workers: int, selection: str = "full",
                            sel_phase: int = 0) -> tuple:
    """Fold contributions into a trajectory ledger: one record per fully
    contributed step, streams in worker order — exactly the MZOL record a
    seed-parallel step of the same round appends, so the assembled ledger
    replays under the engine's ``replay()``.

    An empty default-constructed ledger is stamped with the async plan's
    coordinates (``n_groups`` = worker count, ``exec_plan``,
    ``batch_seeds`` from the wire vectors), and with ``selection`` /
    ``sel_phase`` (the selection is not on the wire; stamped even at one
    worker).  ``n_workers`` is required: inferring it from a step's
    delivered contributions would record an incomplete round of a larger
    cluster as a complete smaller one.

    Returns ``(recorded, skipped)`` — steps appended vs. steps dropped for
    missing contributions; a nonzero ``skipped`` means the ledger
    reconstructs parameters BEHIND what live workers applied."""
    by_step: dict = {}
    for c in contribs:
        by_step.setdefault(c.step, {})[c.worker] = c
    n = int(n_workers)
    recorded = skipped = 0
    for step in sorted(by_step):
        row = by_step[step]
        if sorted(row) != list(range(n)):
            skipped += 1                  # incomplete round: not recordable
            continue
        if len(ledger) == 0 and ledger.n_groups == 1 and n > 1:
            g0 = row[0].projected_grad
            ledger.n_groups = n
            ledger.exec_plan = "async_worker"
            ledger.batch_seeds = len(g0) if isinstance(g0, tuple) else 1
        if len(ledger) == 0 and ledger.selection == "full":
            ledger.selection = selection
            ledger.sel_phase = int(sel_phase)
        flat: list = []
        for w in range(n):
            g = row[w].projected_grad
            flat.extend(g if isinstance(g, tuple) else (g,))
        ledger.append(step, flat if len(flat) > 1 else flat[0], row[0].lr)
        recorded += 1
    return recorded, skipped
