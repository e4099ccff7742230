"""Core — the port of ``repro.core``: the scalar trajectory ledger and its
replay, the functional SPSA primitives, the deprecated optimizer shims
(``MeZO`` / ``MeZOAdam`` / ``MeZOVariant``, thin wrappers over
``repro_torch.zo`` compositions), re-exported with the composable surface,
and the non-differentiable objectives (``repro_torch.core.nondiff``).

Exports resolve lazily (PEP 562): the shims import ``repro_torch.zo``,
which imports the primitive submodules ``repro_torch.core.spsa`` /
``core.schedules`` — lazy resolution lets either package be imported first
without a cycle.  Submodules resolve on attribute access too
(``repro_torch.core.nondiff``)."""
from __future__ import annotations

import importlib

_EXPORTS = {
    # primitives -------------------------------------------------------------
    "repro_torch.core.perturb": ["fused_restore_update", "leaf_key",
                                 "sample_leaf_z", "sample_z_tree",
                                 "step_key"],
    "repro_torch.core.spsa": ["SPSAResult", "one_point_projected_grad",
                              "spsa_full_gradient_oracle",
                              "spsa_projected_grad", "zo_grad_norm"],
    # deprecated optimizer shims --------------------------------------------
    "repro_torch.core.mezo": ["MeZO", "MeZOConfig", "MeZOState",
                              "apply_projected_update"],
    "repro_torch.core.mezo_adam": ["MeZOAdam", "MeZOAdamConfig",
                                   "MeZOAdamState"],
    "repro_torch.core.mezo_variants": ["MeZOVariant", "MeZOVariantConfig",
                                       "MeZOVariantState"],
    # trajectory ledger ------------------------------------------------------
    "repro_torch.core.trajectory": ["TrajectoryLedger", "replay",
                                    "storage_report"],
    # the composable surface (estimator × transforms behind one protocol) ----
    "repro_torch.zo": ["Optimizer", "ZOOptimizer", "ZOState", "ZOEstimator",
                       "ZOTransform", "apply_rank1", "as_zo_optimizer",
                       "chain"],
}
_LOOKUP = {name: module for module, names in _EXPORTS.items()
           for name in names}
_ALIASES = {"perturb_params": ("repro_torch.core.perturb", "perturb")}

# sorted(_LOOKUP) + sorted(_ALIASES), JAX's order, spelled out (a literal
# list, as the lint of explicit re-exports reads it)
__all__ = [
    "MeZO", "MeZOAdam", "MeZOAdamConfig", "MeZOAdamState", "MeZOConfig",
    "MeZOState", "MeZOVariant", "MeZOVariantConfig", "MeZOVariantState",
    "Optimizer", "SPSAResult", "TrajectoryLedger", "ZOEstimator",
    "ZOOptimizer", "ZOState", "ZOTransform", "apply_projected_update",
    "apply_rank1", "as_zo_optimizer", "chain", "fused_restore_update",
    "leaf_key", "one_point_projected_grad", "replay", "sample_leaf_z",
    "sample_z_tree", "spsa_full_gradient_oracle", "spsa_projected_grad",
    "step_key", "storage_report", "zo_grad_norm", "perturb_params",
]
assert __all__ == sorted(_LOOKUP) + sorted(_ALIASES)


def __getattr__(name: str):
    if name in _LOOKUP:
        value = getattr(importlib.import_module(_LOOKUP[name]), name)
    elif name in _ALIASES:
        module, attr = _ALIASES[name]
        value = getattr(importlib.import_module(module), attr)
    else:
        try:  # submodule access: ``repro_torch.core.mezo``, ``.nondiff``
            value = importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError:
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value            # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(__all__))
