"""``repro_torch.exec`` — execution plans and the step engine (ledger
replay, so far)."""
from repro_torch.exec.engine import StepProgram, as_step_program
from repro_torch.exec.plan import (ExecPlan, PlanMismatchError, async_worker,
                                   check_replay_plan, local, replay,
                                   seed_parallel)

__all__ = ["ExecPlan", "PlanMismatchError", "StepProgram", "as_step_program",
           "async_worker", "check_replay_plan", "local", "replay",
           "seed_parallel"]
