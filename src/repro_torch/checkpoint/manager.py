"""Checkpoint manager: rotation, resume, and the MeZO seed-chain ledger —
the port of ``repro.checkpoint.manager`` (same file names and layout).

Two artifact kinds per run directory:
  * ``ckpt_<step>.mz``   — full tensor checkpoints (params + optimizer state
                           + step), written every ``interval`` steps, keeping
                           the newest ``keep``;
  * ``ledger.mzl``       — the (seed, projected_grad, lr) scalar ledger,
                           rewritten atomically every step.

Recovery = newest full checkpoint + replay of the ledger tail through the
step engine (``StepProgram.replay``): no data, no forward passes (paper
§2.1).  Both artifacts record the run's seed-schedule coordinates, and
recovery refuses mismatched ones with JAX's error types.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Optional

from repro_torch.checkpoint.io import load_tree, save_tree
from repro_torch.core.trajectory import TrajectoryLedger, replay
from repro_torch.tree_utils import PyTree


class CheckpointManager:
    def __init__(self, directory: str, interval: int = 100, keep: int = 3):
        self.dir = directory
        self.interval = interval
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ---- full tensor checkpoints ---------------------------------------- #
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:09d}.mz")

    def steps(self) -> list:
        out = []
        for p in glob.glob(os.path.join(self.dir, "ckpt_*.mz")):
            m = re.search(r"ckpt_(\d+)\.mz$", p)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def maybe_save(self, step: int, params: PyTree, opt_state: Any = None,
                   meta: Optional[dict] = None, force: bool = False) -> bool:
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        save_tree(self._path(step), tree, {"step": step, **(meta or {})})
        for old in self.steps()[:-self.keep]:
            os.remove(self._path(old))
        return True

    def restore_latest(self, like_params: PyTree, like_opt: Any = None):
        steps = self.steps()
        if not steps:
            return None
        step = steps[-1]
        like = {"params": like_params}
        if like_opt is not None:
            like["opt_state"] = like_opt
        tree, meta = load_tree(self._path(step), like)
        return {"step": step, "params": tree["params"],
                "opt_state": tree.get("opt_state"), "meta": meta}

    # ---- MeZO scalar ledger ---------------------------------------------- #
    @property
    def ledger_path(self) -> str:
        return os.path.join(self.dir, "ledger.mzl")

    def save_ledger(self, ledger: TrajectoryLedger) -> int:
        raw = ledger.to_bytes()
        tmp = self.ledger_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, self.ledger_path)
        return len(raw)

    def load_ledger(self) -> Optional[TrajectoryLedger]:
        if not os.path.exists(self.ledger_path):
            return None
        with open(self.ledger_path, "rb") as f:
            return TrajectoryLedger.from_bytes(f.read())

    def recover_via_ledger(self, params_at_ckpt: PyTree, ckpt_step: int,
                           optimizer) -> tuple:
        """Full ckpt at ``ckpt_step`` + ledger tail -> params at the ledger
        head (in place).  ``optimizer`` is a ``StepProgram`` (the resume
        path: its plan must match the ledger's) or a ZO optimizer, replayed
        on the ledger-driven plan."""
        ledger = self.load_ledger()
        if ledger is None or len(ledger) == 0:
            return params_at_ckpt, ckpt_step
        tail_start = next((i for i, s in enumerate(ledger.steps)
                           if s >= ckpt_step), len(ledger))
        params = replay(params_at_ckpt, ledger, optimizer, from_idx=tail_start)
        return params, (ledger.steps[-1] + 1 if len(ledger) else ckpt_step)
