"""Protocol types and the ``ZOOptimizer`` facade — the port of
``repro.zo.base``.

* ``ZOEstimator`` produces the scalar projected gradient from forward passes
  only; ``estimate`` returns a ``ZOEstimate`` whose ``apply_update`` /
  ``restore`` closures continue the estimator's own perturbation chain.
* ``ZOTransform`` rewrites the scalar ledger entry (clip, η-scale, decay).
* ``ZOOptimizer`` is the facade every consumer talks to: ``init(params, *,
  seed)`` / ``step_fn(loss_fn)`` / ``restore(state, step)`` plus
  ``replay_update`` for scalar-ledger replay.

What differs from JAX, and why:

* the step runs eagerly under ``torch.no_grad()`` on parameters that never
  require grad, and the backend writes in place: sequential spsa keeps ONE
  parameter copy live (θ → θ+εz → θ−εz → fused restore-update, each a K1
  pass over the same leaves) — the paper's inference-memory property.  The
  step returns the same (updated) tree it was given, as a donated JAX step
  hands back its buffer;
* the scalars (losses, g, η, coefficients) are host numpy f32 values, each
  formed as one separately rounded f32 operation in JAX's order, so a
  ledger's recorded (g, η) replays to the coefficients the live step used;
* a block-scheduled selection's phase is ``sel.phase_at(state.step)``,
  a Python int formed on the host each step, in place of JAX's
  ``lax.switch`` over one traced body per phase; the estimator and the
  update read it from there.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Protocol, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.device import host_f32 as host_f32
from repro_torch.perturb import PerturbBackend, StreamRef, get_backend
from repro_torch.perturb.stream import Key, fold_in, prng_key, step_key
from repro_torch.tree_utils import PyTree

f32 = np.float32
ZOLossFn = Callable[[PyTree, Any], torch.Tensor]




# --------------------------------------------------------------------------- #
# Estimator protocol
# --------------------------------------------------------------------------- #
class ZOEstimate(NamedTuple):
    """One seed's worth of estimation, plus how to act on it.
    ``apply_update(coeff, decay_term)`` applies θ ← (1−decay)·θ − coeff·z
    from wherever the estimator left the tree; ``restore()`` returns the
    un-perturbed center parameters."""
    projected_grad: Any                    # f32 g, or the (B,) vector
    loss: np.float32                       # loss estimate for logging
    apply_update: Callable[[Any, Any], PyTree]
    restore: Callable[[], PyTree]
    est_state: Any
    aux: dict


class ZOEstimator(NamedTuple):
    """Factory-produced estimator: ``init(params, key) -> state`` and
    ``estimate(loss_fn, params, batch, key, state) -> ZOEstimate``
    (JAX's fields: ``n_seeds > 1`` interleaves n folded seeds; ``replayable``
    says a (seed, g, lr) ledger entry reproduces the update; ``batch_seeds >
    1`` is a batched-seed estimator whose g is a (B,) vector)."""
    init: Callable[[Optional[PyTree], Key], Any]
    estimate: Callable[..., ZOEstimate]
    n_seeds: int = 1
    eps: float = 1e-3
    dist: str = "gaussian"
    name: str = "spsa"
    replayable: bool = True
    backend: Optional[PerturbBackend] = None
    batch_seeds: int = 1
    selection: Any = None


# --------------------------------------------------------------------------- #
# Transform protocol
# --------------------------------------------------------------------------- #
class Updates(NamedTuple):
    """The value threaded through a transform chain, per seed: ``g`` the
    ledger scalar, ``coeff`` the η-scaled coefficient, ``lr`` the schedule's
    η, ``decay`` the decoupled η·λ, ``final_params`` the parameters an
    applier transform (``scale_by_zo_adam`` / ``trace``) has written, which
    replace the default rank-1 application."""
    g: Any
    coeff: Any = None
    lr: Any = None
    decay: Any = 0.0
    final_params: Optional[PyTree] = None


class TransformCtx(NamedTuple):
    """Read-only step context handed to every transform."""
    step: int
    base_key: Key
    key: Key
    seed_index: int
    n_seeds: int
    eps: float
    dist: str
    restore: Callable[[], PyTree]
    backend: Any = None


class ZOTransform(NamedTuple):
    """``init(params) -> state`` / ``update(updates, state, ctx)``; ``info``
    carries the static metadata the facade introspects (``lr_at``,
    ``weight_decay``, ``applier``)."""
    init: Callable[[Optional[PyTree]], Any]
    update: Callable[[Updates, Any, TransformCtx], tuple]
    info: dict


def identity() -> ZOTransform:
    """The do-nothing transform (coeff = g, no decay)."""
    return ZOTransform(lambda params: (), lambda u, state, ctx: (u, state), {})


def chain(*transforms: ZOTransform) -> ZOTransform:
    """Compose transforms left-to-right, optax-style."""
    if len(transforms) == 1:
        return transforms[0]

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(u, state, ctx):
        new_state = []
        for t, s in zip(transforms, state):
            u, s = t.update(u, s, ctx)
            new_state.append(s)
        return u, tuple(new_state)

    info: dict = {}
    for t in transforms:
        info.update(t.info)
    return ZOTransform(init, update, info)


# --------------------------------------------------------------------------- #
# Optimizer protocol + facade
# --------------------------------------------------------------------------- #
@runtime_checkable
class Optimizer(Protocol):
    """The uniform optimizer surface every consumer programs against — ZO
    compositions and backprop baselines alike (``ZOOptimizer``, the
    deprecated shims, ``train.adam.Adam``): the training loop, checkpoint
    recovery and the execution engine only call these three methods."""

    def init(self, params: Optional[PyTree], *, seed: int = 0) -> Any: ...

    def step_fn(self, loss_fn: ZOLossFn) -> Callable: ...

    def restore(self, state: Any, step: int) -> Any: ...


class ZOState(NamedTuple):
    """Uniform optimizer state: a step counter, the run seed's key, and the
    estimator/transform carries — all host values, checkpointable as a
    plain tree."""
    step: int
    base_key: Key
    est_state: Any
    tf_state: Any
    last_projected_grad: np.float32


class ZOOptimizer:
    """estimator × transform-chain behind the uniform protocol."""

    def __init__(self, estimator: ZOEstimator,
                 transform: Optional[ZOTransform] = None,
                 name: Optional[str] = None):
        self.estimator = estimator
        self.transform = transform if transform is not None else identity()
        self.name = name or estimator.name
        applier = self.transform.info.get("applier")
        if estimator.n_seeds > 1 and applier:
            raise ValueError(
                "stateful applier transforms (scale_by_zo_adam / trace) keep "
                "one ledger entry per step and cannot run under interleaved "
                "n-SPSA; use n_seeds=1")
        if estimator.batch_seeds > 1 and applier:
            raise ValueError(
                "applier transforms (scale_by_zo_adam / trace) reconstruct "
                "their update from one scalar per step and cannot consume a "
                "batched-seed estimator's per-seed g vector; use "
                "batch_seeds=1 or a scalar transform chain")
        if applier and self.transform.info.get("scalar_decay"):
            raise ValueError(
                "add_weight_decay sets the scalar decay slot, which applier "
                "transforms (scale_by_zo_adam / trace) bypass — pass "
                "weight_decay= to the applier transform instead")
        if estimator.selection is not None and applier:
            raise ValueError(
                "applier transforms (scale_by_zo_adam / trace) materialize "
                "their update over the FULL tree from the g-history, which "
                "would write unselected leaves; parameter selections "
                "(repro_torch.select) compose with rank-1 scalar chains only")

    # -- introspection ------------------------------------------------------ #
    @property
    def info(self) -> dict:
        return self.transform.info

    @property
    def backend(self) -> PerturbBackend:
        return get_backend(self.estimator.backend)

    @property
    def backend_name(self) -> str:
        """The backend's ``stream_id``, recorded in ledger/checkpoint
        metadata."""
        return self.backend.stream_id

    @property
    def batch_seeds(self) -> int:
        return int(self.estimator.batch_seeds)

    @property
    def selection(self):
        """The resolved ``Selection`` scoping this composition (``None`` =
        the full tree)."""
        return self.estimator.selection

    @property
    def selection_spec(self) -> str:
        """Canonical selection spec recorded in checkpoint/ledger metadata
        (``"full"`` when no selection is set)."""
        sel = self.selection
        return "full" if sel is None else sel.spec

    @property
    def selection_phase(self) -> int:
        """The selection's schedule phase offset (0 when unscheduled)."""
        sel = self.selection
        return 0 if sel is None else int(sel.phase_offset)

    def phase_at(self, step: int) -> int:
        """The schedule phase of step ``step`` (0 without a selection)."""
        sel = self.selection
        return 0 if sel is None else sel.phase_at(step)

    @property
    def weight_decay(self) -> float:
        return self.info.get("weight_decay", 0.0)

    def lr_at(self, step) -> np.float32:
        fn = self.info.get("lr_at")
        return fn(step) if fn is not None else f32(1.0)

    # -- protocol ----------------------------------------------------------- #
    def init(self, params: Optional[PyTree] = None, *, seed: int = 0) -> ZOState:
        base_key = prng_key(seed)
        return ZOState(step=0, base_key=base_key,
                       est_state=self.estimator.init(params, base_key),
                       tf_state=self.transform.init(params),
                       last_projected_grad=f32(0.0))

    def restore(self, state: ZOState, step: int) -> ZOState:
        """Realign the step counter (seed source and lr index) after ledger
        replay advanced the parameters past a tensor checkpoint."""
        return state._replace(step=int(step))

    def replay_update(self, params: PyTree, skey: Key, g, lr,
                      phase: int = 0) -> PyTree:
        """Apply one scalar-ledger entry in place: θ ← (1−η·λ)·θ − η·g·z(skey)
        with η·g and η·λ each one f32 product (a (B,) g replays the B folded
        rank-1 updates of a batched-seed step).  ``phase`` is the replayed
        step's schedule phase, derived from its step index as the live step
        derived it."""
        if self.info.get("applier"):
            raise ValueError(
                f"{self.name}: scalar-ledger replay cannot reproduce applier "
                "transforms (scale_by_zo_adam / trace); resume from a full "
                "state checkpoint instead of a ledger tail")
        if not self.estimator.replayable:
            raise ValueError(
                f"{self.name}: the {self.estimator.name!r} estimator updates "
                "along D·z (Definition 6), which a (seed, g, lr) ledger entry "
                "cannot reproduce; resume from a full state checkpoint")
        lr = f32(lr)
        decay = lr * f32(self.weight_decay)
        sel = self.selection
        if self.batch_seeds > 1:
            from repro_torch.zo.updates import apply_rank1_batch
            return apply_rank1_batch(params, skey, lr * np.asarray(g, f32),
                                     decay, dist=self.estimator.dist,
                                     backend=self.backend, selection=sel,
                                     phase=phase)
        return self.backend.apply_rank1(params, StreamRef(skey, sel, phase),
                                        lr * f32(g), decay,
                                        self.estimator.dist)

    def step_fn(self, loss_fn: ZOLossFn) -> Callable:
        """``step(params, state, batch) -> (params, state, metrics)``; the
        returned params are the given tree, updated in place."""
        est, tf = self.estimator, self.transform
        n = est.n_seeds
        backend = self.backend

        @torch.no_grad()
        def step(params: PyTree, state: ZOState, batch):
            skey0 = step_key(state.base_key, state.step)
            phase = self.phase_at(state.step)
            p = params
            est_state, tf_state = state.est_state, state.tf_state
            gs, losses = [], []
            aux: dict = {}
            lr_metric = None
            for j in range(n):
                skey = fold_in(skey0, j) if n > 1 else skey0
                e = est.estimate(loss_fn, p, batch, skey, est_state,
                                 phase=phase)
                est_state = e.est_state
                ctx = TransformCtx(step=state.step, base_key=state.base_key,
                                   key=skey, seed_index=j, n_seeds=n,
                                   eps=est.eps, dist=est.dist,
                                   restore=e.restore, backend=backend)
                u, tf_state = tf.update(Updates(g=e.projected_grad),
                                        tf_state, ctx)
                if u.final_params is not None:
                    p = u.final_params
                else:
                    coeff = u.coeff if u.coeff is not None else u.g
                    p = e.apply_update(coeff, u.decay)
                gs.append(u.g)
                losses.append(e.loss)
                aux.update(e.aux)
                lr_metric = u.lr
            g_mean = f32(np.mean(np.stack(gs)))
            new_state = ZOState(state.step + 1, state.base_key, est_state,
                                tf_state, g_mean)
            metrics = {"loss": f32(np.mean(np.stack(losses))),
                       "projected_grad": g_mean,
                       "lr": f32(1.0) if lr_metric is None else lr_metric,
                       **aux}
            if n > 1:
                # interleaved n-SPSA: one g per stream, the ledger's
                # (n_groups·batch_seeds,) record
                metrics["projected_grads"] = np.stack(gs).reshape(-1)
            elif np.ndim(gs[0]) > 0:
                # batched-seed estimator: one g per stream
                metrics["projected_grads"] = np.asarray(gs[0], f32)
            return p, new_state, metrics

        return step
