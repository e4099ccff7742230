"""Named compositions — the port of ``repro.zo.presets``: the paper's
optimizers as estimator × transform chains (``mezo``, ``fzoo``).  Each
returns a plain ``ZOOptimizer``.  ``mezo_adam`` / ``mezo_rescaled`` and the
legacy-config interop come with later slices."""
from __future__ import annotations

from repro_torch.zo import estimators, transforms
from repro_torch.zo.base import ZOOptimizer, chain


def _scalar_chain(lr: float, weight_decay: float, lr_schedule: str,
                  total_steps: int, warmup_steps: int,
                  clip_projected_grad: float):
    """clip → η-schedule → weight decay, the legacy order (the decay
    transform is always present, λ may be 0, as in JAX)."""
    tfs = []
    if clip_projected_grad > 0:
        tfs.append(transforms.clip_projected_grad(clip_projected_grad))
    tfs.append(transforms.scale_by_schedule(lr, lr_schedule, total_steps,
                                            warmup_steps))
    tfs.append(transforms.add_weight_decay(weight_decay))
    return chain(*tfs)


def mezo(lr: float = 1e-6, eps: float = 1e-3, n: int = 1,
         dist: str = "gaussian", weight_decay: float = 0.0,
         estimator: str = "spsa", lr_schedule: str = "constant",
         total_steps: int = 0, warmup_steps: int = 0,
         sequential_perturb: bool = True,
         clip_projected_grad: float = 0.0,
         backend=None, selection=None) -> ZOOptimizer:
    """ZO-SGD with in-place seed-replay perturbations (paper Algorithm 1;
    Algorithm 2 when ``n > 1``)::

        ZOOptimizer(spsa(eps) | n_spsa(n, eps) | one_point(eps),
                    chain(clip?, scale_by_schedule(lr), add_weight_decay))

    ``backend=None`` resolves as in JAX (``$REPRO_BACKEND``, else
    ``"xla"``, which the port refuses until that stream is ported): pass
    ``backend="pallas"``."""
    if estimator == "one_point":
        est = estimators.one_point(eps=eps, dist=dist, backend=backend,
                                   selection=selection)
    elif estimator == "spsa":
        est = (estimators.n_spsa(n, eps=eps, dist=dist,
                                 sequential=sequential_perturb,
                                 backend=backend, selection=selection)
               if n > 1 else
               estimators.spsa(eps=eps, dist=dist,
                               sequential=sequential_perturb,
                               backend=backend, selection=selection))
    else:
        raise ValueError(f"unknown estimator {estimator!r}")
    tf = _scalar_chain(lr, weight_decay, lr_schedule, total_steps,
                       warmup_steps, clip_projected_grad)
    return ZOOptimizer(est, tf, name="mezo")


def fzoo(lr: float = 1e-5, eps: float = 1e-3, batch_seeds: int = 8,
         dist: str = "gaussian", weight_decay: float = 0.0,
         lr_schedule: str = "constant", total_steps: int = 0,
         warmup_steps: int = 0, clip_projected_grad: float = 0.0,
         std_floor: float = 1e-8, backend=None,
         selection=None) -> ZOOptimizer:
    """FZOO (Dang et al., 2025): B batched one-sided seed perturbations per
    step, the step size normalized by the std of the B loss differences::

        ZOOptimizer(fzoo(batch_seeds, eps),
                    chain(scale_by_fzoo_std(std_floor), clip?,
                          scale_by_schedule(lr), add_weight_decay))"""
    est = estimators.fzoo(batch_seeds=batch_seeds, eps=eps, dist=dist,
                          backend=backend, selection=selection)
    tfs = [transforms.scale_by_fzoo_std(std_floor)]
    if clip_projected_grad > 0:
        tfs.append(transforms.clip_projected_grad(clip_projected_grad))
    tfs.append(transforms.scale_by_schedule(lr, lr_schedule, total_steps,
                                            warmup_steps))
    tfs.append(transforms.add_weight_decay(weight_decay))
    return ZOOptimizer(est, chain(*tfs), name="fzoo")


def as_zo_optimizer(optimizer) -> ZOOptimizer:
    """Accept a protocol-conforming ZO optimizer (legacy config objects are
    ported with the deprecated shims, a later slice)."""
    if callable(getattr(optimizer, "replay_update", None)):
        return optimizer
    raise TypeError(f"{type(optimizer).__name__} is not a ZO optimizer "
                    "(legacy config objects and backprop baselines are "
                    "ported with later slices)")
