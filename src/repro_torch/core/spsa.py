"""SPSA-family estimator state — the port of ``repro.core.spsa``, so far
the carry of the one-point residual-feedback estimator (Definition 8); the
estimators themselves are ``repro_torch.zo.estimators``."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class OnePointState(NamedTuple):
    """Carry for the residual-feedback one-point estimator (Definition 8)."""
    prev_perturbed_loss: np.float32  # L(θ_{t-1} + ε z_{t-1}; B_{t-1})


def one_point_init() -> OnePointState:
    return OnePointState(np.float32(0.0))
