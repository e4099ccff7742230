"""Core: the scalar trajectory ledger and its replay, and the
non-differentiable objectives (``repro_torch.core.nondiff``, reached as
``repro.core.nondiff`` is)."""
from repro_torch.core import nondiff
from repro_torch.core.trajectory import TrajectoryLedger, replay

__all__ = ["TrajectoryLedger", "nondiff", "replay"]
