"""Core: the scalar trajectory ledger and its replay."""
from repro_torch.core.trajectory import TrajectoryLedger, replay

__all__ = ["TrajectoryLedger", "replay"]
