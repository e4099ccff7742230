"""``repro_torch.train`` — the checkpointed training loop."""
from repro_torch.train.loop import (FailureInjector, HeartbeatMonitor,
                                    TrainResult, train)

__all__ = ["FailureInjector", "HeartbeatMonitor", "TrainResult", "train"]
