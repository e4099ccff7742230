"""Checkpointed training loop with fault-tolerance hooks — the port of
``repro.train.loop``.

  * pure step-indexed data (restart-exact);
  * full checkpoints every K steps + the per-step ZO scalar ledger;
  * resume: newest full checkpoint, then ledger replay of the tail — the
    replacement worker rejoins without data access;
  * ``HeartbeatMonitor`` / ``FailureInjector`` hooks.

``optimizer`` is a ``repro_torch.exec.StepProgram`` or a ZO optimizer
(wrapped onto the local plan).  Every artifact is stamped with the program's
seed-schedule coordinates, and resuming under mismatched ones refuses with
JAX's errors (``BackendMismatchError`` / ``PlanMismatchError`` /
``SelectionMismatchError`` / ``ValueError`` for batch_seeds).  Where JAX
jits the step with the parameter buffer donated, the port's step writes the
parameters in place (``params`` is consumed; continue from the returned
tree).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.trajectory import TrajectoryLedger
from repro_torch.exec import as_step_program, check_replay_plan
from repro_torch.perturb import check_replay_backend
from repro_torch.select import check_replay_selection
from repro_torch.tree_utils import PyTree


class HeartbeatMonitor:
    """Launcher-facing hook: the loop beats every step; deployments override
    ``on_beat`` to feed a watchdog."""

    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self.last = time.monotonic()

    def beat(self, step: int) -> None:
        now = time.monotonic()
        self.on_beat(step, now - self.last)
        self.last = now

    def on_beat(self, step: int, dt: float) -> None:  # pragma: no cover
        pass


class FailureInjector:
    """Test hook: raise at a chosen step to simulate a node crash."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step

    def check(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainResult:
    params: PyTree
    opt_state: Any
    losses: list
    steps_run: int
    resumed_from: int


def _stamp_or_check_ledger(ledger: TrajectoryLedger, meta: dict) -> None:
    if len(ledger) == 0:
        ledger.backend = meta["perturb_backend"]
        ledger.batch_seeds = int(meta["batch_seeds"])
        ledger.exec_plan = meta["exec_plan"]
        ledger.n_groups = int(meta["n_groups"])
        ledger.selection = meta["selection"]
        ledger.sel_phase = int(meta["sel_phase"])
        return
    check_replay_backend(ledger.backend, meta["perturb_backend"],
                         "the provided trajectory ledger")
    check_replay_plan(ledger.n_groups, meta["n_groups"],
                      "the provided trajectory ledger",
                      recorded_kind=ledger.exec_plan,
                      active_kind=meta["exec_plan"])
    check_replay_selection(ledger.selection, meta["selection"],
                           "the provided trajectory ledger", ledger.sel_phase,
                           meta["sel_phase"])


def _check_ckpt_meta(saved: dict, meta: dict) -> None:
    check_replay_backend(saved.get("perturb_backend"),
                         meta["perturb_backend"], "checkpoint")
    ckpt_bs = saved.get("batch_seeds")
    if ckpt_bs is not None and int(ckpt_bs) != int(meta["batch_seeds"]):
        raise ValueError(
            f"checkpoint was written by an optimizer with "
            f"batch_seeds={ckpt_bs} but the active optimizer uses "
            f"batch_seeds={meta['batch_seeds']}; the seed fold schedule (and "
            "the ledger's per-step record shape) differ — resume with a "
            "matching fzoo(batch_seeds=...) composition")
    check_replay_plan(saved.get("n_groups"), meta["n_groups"], "checkpoint",
                      recorded_kind=saved.get("exec_plan"),
                      active_kind=meta["exec_plan"])
    check_replay_selection(saved.get("selection"), meta["selection"],
                           "checkpoint", saved.get("sel_phase"),
                           meta["sel_phase"])


def train(loss_fn: Callable, params: PyTree, optimizer, pipeline,
          total_steps: int, ckpt: Optional[CheckpointManager] = None,
          ledger: Optional[TrajectoryLedger] = None,
          monitor: Optional[HeartbeatMonitor] = None,
          injector: Optional[FailureInjector] = None,
          log_every: int = 50, eval_fn: Optional[Callable] = None,
          eval_every: int = 0, verbose: bool = False,
          seed: int = 0) -> TrainResult:
    """Run (or resume) a training job; ``params`` is updated in place."""
    program = as_step_program(optimizer)
    opt_state = program.init(params, seed=seed)
    meta = program.meta
    if ledger is not None:
        _stamp_or_check_ledger(ledger, meta)

    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore_latest(params, opt_state)
        if restored is not None:
            _check_ckpt_meta(restored["meta"], meta)
            params = restored["params"]
            if restored["opt_state"] is not None:
                opt_state = restored["opt_state"]
            start_step = restored["step"]
            if ledger is not None:
                saved = ckpt.load_ledger()
                if saved is not None and len(saved):
                    if saved.steps[-1] >= start_step:
                        # the ledger tail advances params past the ckpt
                        params, start_step = ckpt.recover_via_ledger(
                            params, start_step, program)
                    # adopt the saved records even when the checkpoint is
                    # at the ledger head (JAX's loop then drops them: the
                    # next save would overwrite the file without them)
                    for field in ("steps", "grads", "lrs", "batch_seeds",
                                  "exec_plan", "n_groups", "selection",
                                  "sel_phase"):
                        setattr(ledger, field, getattr(saved, field))
            # realign the step counter (seed source + lr index)
            opt_state = program.restore(opt_state, start_step)

    step_fn = program.step_fn(loss_fn)
    losses = []
    t0 = time.time()
    for step in range(start_step, total_steps):
        if injector is not None:
            injector.check(step)
        batch = pipeline.batch(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if ledger is not None:
            # multi-stream steps expose the per-stream vector — record it so
            # replay can refold the rank-1 updates stream by stream
            g_rec = metrics.get("projected_grads")
            g_rec = (float(metrics["projected_grad"]) if g_rec is None
                     else np.asarray(g_rec))
            ledger.append(step, g_rec, float(metrics["lr"]))
            if ckpt is not None:
                ckpt.save_ledger(ledger)
        if ckpt is not None:
            ckpt.maybe_save(step + 1, params, opt_state, meta=meta)
        if monitor is not None:
            monitor.beat(step)
        if step % log_every == 0 or step == total_steps - 1:
            losses.append((step, float(metrics["loss"])))
            if verbose:
                print(f"step {step:6d} loss {float(metrics['loss']):.4f} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
        if eval_fn is not None and eval_every and (step + 1) % eval_every == 0:
            eval_fn(step + 1, params)

    if ckpt is not None:
        ckpt.maybe_save(total_steps, params, opt_state, meta=meta, force=True)
    return TrainResult(params, opt_state, losses, total_steps - start_step,
                       start_step)
