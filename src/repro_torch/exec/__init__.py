"""``repro_torch.exec`` — execution plans and the step engine (local and
seed-parallel steps on one card, ledger replay)."""
from repro_torch.exec.engine import (StepProgram, apply_group_update,
                                     apply_group_updates, as_step_program,
                                     group_key, group_stream_key, slice_group)
from repro_torch.exec.plan import (ExecPlan, PlanMismatchError, async_worker,
                                   check_replay_plan, local, replay,
                                   seed_parallel)

__all__ = ["ExecPlan", "PlanMismatchError", "StepProgram",
           "apply_group_update", "apply_group_updates", "as_step_program",
           "async_worker", "check_replay_plan", "group_key",
           "group_stream_key", "local", "replay", "seed_parallel",
           "slice_group"]
