"""``repro_torch.train`` — the checkpointed training loop and the backprop
baselines (Adam, SGD)."""
from repro_torch.train.adam import Adam, AdamConfig, AdamState
from repro_torch.train.loop import (FailureInjector, HeartbeatMonitor,
                                    TrainResult, train)

__all__ = ["Adam", "AdamConfig", "AdamState", "FailureInjector",
           "HeartbeatMonitor", "TrainResult", "train"]
