"""Compatibility module — the port of ``repro.core.perturb``: the seeded
perturbation machinery lives in ``repro_torch.perturb``.

This module re-exports the threefry (``xla`` backend) functional API so
legacy imports keep working; new code goes through ``repro_torch.perturb``:

    from repro_torch.perturb import StreamRef, get_backend
    backend = get_backend("xla")          # or "pallas" (the counter stream)
    p_plus = backend.perturb(params, StreamRef(key), eps)   # in place

Everything here is the same object as in ``repro_torch.perturb.xla`` (and
``step_key`` as in ``repro_torch.perturb.stream``), not a copy.
"""
from __future__ import annotations

from repro_torch.perturb.stream import step_key
from repro_torch.perturb.xla import (Distribution, _sphere_scale,
                                     fused_restore_update, leaf_key, perturb,
                                     perturb_jit, sample_leaf_z,
                                     sample_z_tree)

__all__ = [
    "Distribution", "fused_restore_update", "leaf_key", "perturb",
    "perturb_jit", "sample_leaf_z", "sample_z_tree", "step_key",
    "_sphere_scale",
]
