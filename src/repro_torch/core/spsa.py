"""SPSA-family estimator pieces — the port of ``repro.core.spsa``: the
carry of the one-point residual-feedback estimator (Definition 8) and
Proposition 1's ZO gradient-norm probe; the estimators themselves are
``repro_torch.zo.estimators``."""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.perturb import StreamRef, get_backend
from repro_torch.tree_utils import is_floating, tree_map_with_index

f32 = np.float32


class OnePointState(NamedTuple):
    """Carry for the residual-feedback one-point estimator (Definition 8)."""
    prev_perturbed_loss: np.float32  # L(θ_{t-1} + ε z_{t-1}; B_{t-1})


def one_point_init() -> OnePointState:
    return OnePointState(np.float32(0.0))


@torch.no_grad()
def zo_grad_norm(loss_fn, params, batch, key, eps: float,
                 leaf_indices: Sequence[int]) -> np.float32:
    """Proposition 1: |L(θ+εz_ℓ) − L(θ−εz_ℓ)| / 2ε estimates ‖∇_ℓ L‖ where
    z_ℓ is the threefry (``xla``) z on the leaves in ``leaf_indices`` and
    zero elsewhere — JAX draws it with ``sample_leaf_z`` whatever the run's
    backend.  The probed leaves are perturbed on copies (θ is left alone):
    θ + ε·z, then − 2ε·z from there, each scalar in the leaf dtype."""
    idx = set(leaf_indices)
    be, ref = get_backend("xla"), StreamRef(key)

    def copy(i, p):
        return p.clone() if i in idx and is_floating(p) else p

    probe = tree_map_with_index(copy, params)

    def pert(sign: float):
        def one(i, p):
            if i not in idx or not is_floating(p):
                return p
            eps_ = torch.tensor(float(f32(eps))).to(p.dtype)
            return be.perturb_leaf(p, ref, i, float(eps_ * sign))
        return tree_map_with_index(one, probe)

    from repro_torch.zo.base import host_f32
    l_plus = host_f32(loss_fn(pert(1.0), batch))
    l_minus = host_f32(loss_fn(pert(-2.0), batch))
    return f32(abs(f32(l_plus - l_minus)) / f32(2.0 * eps))
