"""Named compositions — the port of ``repro.zo.presets``: the paper's
optimizers as estimator × transform chains (``mezo``, ``fzoo``,
``mezo_adam``, ``mezo_rescaled``).  Each returns a plain ``ZOOptimizer``.
``from_config`` / ``as_zo_optimizer`` are the legacy-config interop of the
deprecated shims (``repro_torch.core.mezo`` and friends)."""
from __future__ import annotations

from repro_torch.zo import estimators, transforms
from repro_torch.zo.base import ZOOptimizer, chain


def _scalar_chain(lr: float, weight_decay: float, lr_schedule: str,
                  total_steps: int, warmup_steps: int,
                  clip_projected_grad: float, extra=()):
    """clip → η-schedule → weight decay (→ extra applier), the legacy order
    (the decay transform is present, λ may be 0, unless an applier takes
    the update, as in JAX)."""
    tfs = []
    if clip_projected_grad > 0:
        tfs.append(transforms.clip_projected_grad(clip_projected_grad))
    tfs.append(transforms.scale_by_schedule(lr, lr_schedule, total_steps,
                                            warmup_steps))
    if not extra:
        tfs.append(transforms.add_weight_decay(weight_decay))
    tfs.extend(extra)
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
    ``"xla"``, the threefry stream).  ``selection`` scopes the perturbation
    to a parameter subset (``repro_torch.select``: a ``Selection`` or a spec
    string such as ``"rows(block=1,k=4)"`` or ``"peft(lora)"``)."""
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


def mezo_adam(lr: float = 1e-4, eps: float = 1e-3, beta1: float = 0.9,
              beta2: float = 0.999, adam_eps: float = 1e-8,
              materialized: bool = False, window: int = 32,
              momentum_only: bool = False, dist: str = "gaussian",
              weight_decay: float = 0.0, lr_schedule: str = "constant",
              total_steps: int = 0, warmup_steps: int = 0,
              clip_projected_grad: float = 0.0, backend=None,
              selection=None) -> ZOOptimizer:
    """MeZO-Adam / MeZO-momentum (paper §2.2 + App. B.2): the sequential
    SPSA estimator with the Adam preconditioner rebuilt from the scalar
    g-history (a ring buffer of ``window`` scalars) or materialized as the
    m / v oracle.  ``selection`` is accepted for interface symmetry and
    refused by the facade (applier transforms write the full tree)."""
    est = estimators.spsa(eps=eps, dist=dist, sequential=True,
                          backend=backend, selection=selection)
    adam = transforms.scale_by_zo_adam(
        beta1=beta1, beta2=beta2, adam_eps=adam_eps,
        materialized=materialized, window=window,
        momentum_only=momentum_only, weight_decay=weight_decay)
    tf = _scalar_chain(lr, 0.0, lr_schedule, total_steps, warmup_steps,
                       clip_projected_grad, extra=(adam,))
    return ZOOptimizer(est, tf, name="mezo_adam")


def mezo_rescaled(lr: float = 1e-6, eps: float = 1e-3,
                  dist: str = "gaussian", d_source: str = "param_norm",
                  modify_expectation: bool = False, probe_loss_fn=None,
                  probe_batch=None, probe_eps: float = 1e-4,
                  weight_decay: float = 0.0, lr_schedule: str = "constant",
                  total_steps: int = 0, warmup_steps: int = 0,
                  clip_projected_grad: float = 0.0, backend=None,
                  selection=None) -> ZOOptimizer:
    """Variance/expectation-modified SPSA (paper App. B.3/B.4, Definitions
    6/7): perturb by ε·(d⁻¹⊙z), update along (D or I)·z."""
    est = estimators.rescaled_spsa(
        eps=eps, dist=dist, d_source=d_source,
        modify_expectation=modify_expectation, probe_loss_fn=probe_loss_fn,
        probe_batch=probe_batch, probe_eps=probe_eps, backend=backend,
        selection=selection)
    tf = _scalar_chain(lr, weight_decay, lr_schedule, total_steps,
                       warmup_steps, clip_projected_grad)
    return ZOOptimizer(est, tf, name="mezo_rescaled")


# --------------------------------------------------------------------------- #
# Legacy-config interop
# --------------------------------------------------------------------------- #
def from_config(config) -> ZOOptimizer:
    """Build the composition equivalent of a legacy ``MeZOConfig`` /
    ``MeZOAdamConfig`` / ``MeZOVariantConfig`` (duck-typed — any object with
    the same fields works; ``backend`` and ``selection`` are read when the
    object has them)."""
    common = dict(lr=config.lr, eps=config.eps, dist=config.dist,
                  weight_decay=config.weight_decay,
                  lr_schedule=config.lr_schedule,
                  total_steps=config.total_steps,
                  warmup_steps=config.warmup_steps,
                  clip_projected_grad=config.clip_projected_grad,
                  backend=getattr(config, "backend", None),
                  selection=getattr(config, "selection", None))
    if getattr(config, "d_source", None) is not None:
        return mezo_rescaled(d_source=config.d_source,
                             modify_expectation=config.modify_expectation,
                             probe_eps=config.d_probe_eps, **common)
    if getattr(config, "beta1", None) is not None:
        return mezo_adam(beta1=config.beta1, beta2=config.beta2,
                         adam_eps=config.adam_eps,
                         materialized=config.materialized,
                         window=config.window,
                         momentum_only=config.momentum_only, **common)
    return mezo(n=config.n, estimator=config.estimator,
                sequential_perturb=config.sequential_perturb, **common)


def as_zo_optimizer(optimizer_or_config) -> ZOOptimizer:
    """Accept either a protocol-conforming ZO optimizer or a legacy config
    object, returning something with ``replay_update`` / ``lr_at`` /
    ``estimator`` — the seam through which the trajectory replayer,
    checkpoint recovery and the execution engine take bare configs."""
    if callable(getattr(optimizer_or_config, "replay_update", None)):
        return optimizer_or_config
    return from_config(optimizer_or_config)
