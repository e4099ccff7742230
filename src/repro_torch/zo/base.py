"""The ``ZOOptimizer`` facade — the port of ``repro.zo.base``, so far what a
MeZO ledger replay needs: the estimator's description, the scalar
transform metadata (weight decay), and ``replay_update`` for single-stream
entries.  The live step (``init`` / ``step_fn``), batched-seed estimators
and selections come with later slices; until then ``batch_seeds`` is 1 and
the selection is the full tree, which is what ``StepProgram.replay`` holds
a ledger's header to."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.perturb import PerturbBackend, StreamRef, get_backend
from repro_torch.tree_utils import PyTree

f32 = np.float32


class ZOEstimator(NamedTuple):
    """The estimator's static description (JAX field names)."""
    n_seeds: int = 1
    eps: float = 1e-3
    dist: str = "gaussian"
    name: str = "spsa"
    backend: Optional[object] = None


class ZOOptimizer:
    """estimator × scalar-transform metadata behind the replay protocol."""

    batch_seeds = 1
    selection_spec = "full"
    selection_phase = 0

    def __init__(self, estimator: ZOEstimator, info: Optional[dict] = None,
                 name: Optional[str] = None):
        self.estimator = estimator
        self.info = dict(info or {})
        self.name = name or estimator.name
        self._backend = get_backend(estimator.backend)

    @property
    def backend(self) -> PerturbBackend:
        return self._backend

    @property
    def backend_name(self) -> str:
        """The backend's ``stream_id``, recorded in ledger metadata."""
        return self._backend.stream_id

    @property
    def weight_decay(self) -> float:
        return self.info.get("weight_decay", 0.0)

    def replay_update(self, params: PyTree, skey, g, lr) -> PyTree:
        """Apply one scalar-ledger entry in place:
        θ ← (1 − η·λ)·θ − η·g·z(skey), with η·g and η·λ each one rounded f32
        product (as the JAX replay forms them)."""
        lr32 = f32(lr)
        return self._backend.apply_rank1(
            params, StreamRef(skey), lr32 * f32(g),
            lr32 * f32(self.weight_decay), self.estimator.dist)
