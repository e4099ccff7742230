"""MeZO-specific collective patterns — the port of
``repro.distributed.collectives``: thin policy over ``repro_torch.exec``.

Under data parallelism MeZO's entire inter-replica traffic per step is the
loss scalars, because every replica regenerates the same z from the seed.
JAX gets the loss reduction from GSPMD (``jit`` with the batch sharded over
'data'); the port spells it out: ``data_parallel_loss`` evaluates the loss's
sufficient statistics on this rank's rows of the global batch and
all-reduces them, one packed pair of f32 scalars per evaluation, over the
mesh's batch axes.  ``StepProgram``
wraps the loss with it when its plan carries a materialized mesh.

**Seed-parallel n-SPSA** (beyond the paper): the global batch is split into
n slices and seed g is evaluated only on slice g, so a step costs the
forwards of plain SPSA on the full batch while averaging n independent
rank-1 directions.  The step itself is ``repro_torch.exec.StepProgram`` on
the ``seed_parallel(n)`` plan; what remains here is the legacy surface.
Every perturbation runs through the optimizer's estimator and every
parameter write through the engine's shared write path (identical to ledger
replay).
"""
from __future__ import annotations

import math
import warnings
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.exec import StepProgram, apply_group_updates, group_key
from repro_torch.exec import plan as plan_mod
from repro_torch.perturb import get_backend, prng_key, step_key
from repro_torch.perturb.stream import Key
from repro_torch.tree_utils import PyTree, tree_clone, tree_leaves, tree_map
from repro_torch.zo.base import ZOState
from repro_torch.zo.presets import as_zo_optimizer

f32 = np.float32


# --------------------------------------------------------------------------- #
# Scalar collectives over mesh axes
# --------------------------------------------------------------------------- #
#: subgroups spanning several axes, per mesh (built once: every rank of the
#: mesh takes part in building them)
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def axes_group(mesh, axes):
    """The process group spanning this rank's line of ``mesh`` along
    ``axes`` (an axis name or a tuple of them).  Several axes take a
    subgroup built over every line at once, which every rank of the mesh
    must reach together (the first call for a given mesh and axes)."""
    from repro_torch.distributed.sharding import device_mesh_of
    dm = device_mesh_of(mesh)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return dm.get_group(axes[0])
    groups = _GROUPS.setdefault(dm, {})
    if axes not in groups:
        import torch.distributed as dist
        names = tuple(dm.mesh_dim_names)
        order = [names.index(a) for a in names if a not in axes] + \
            [names.index(a) for a in axes]
        lines = dm.mesh.permute(order).reshape(
            -1, math.prod(dm.mesh.shape[names.index(a)] for a in axes))
        groups[axes] = dist.new_subgroups_by_enumeration(
            [line.tolist() for line in lines])[0]
    return groups[axes]


def psum_scalar(x, axis_name, mesh) -> torch.Tensor:
    """Scalar all-reduce over ``mesh``'s ``axis_name`` axes — MeZO's only
    gradient communication: a 0-d f32 tensor on the group's device.  With
    no process group started it raises."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "psum_scalar needs a started process group "
            "(torch.distributed.init_process_group) and a mesh over it")
    from repro_torch.distributed.sharding import device_mesh_of
    dm = device_mesh_of(mesh)
    t = torch.as_tensor(x, dtype=torch.float32,
                        device=dm.device_type).reshape(()).clone()
    dist.all_reduce(t, group=axes_group(dm, axis_name))
    return t


def gather_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The all-gather of 1-D ``t`` over ``mesh``'s ``axes`` (this rank's
    line), concatenated in the line's rank order: ``torch.distributed``'s
    own collective over ``axes_group``, the path ``psum_scalar`` and the
    loss's reductions take.  Every rank of the line gives a ``t`` of the
    same size; the sphere's ‖z‖² gathers its shares' partial sums so."""
    import torch.distributed as dist
    group = axes_group(mesh, axes)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _rows(batch) -> int:
    for x in tree_leaves(batch):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            return int(x.shape[0])
    raise ValueError("data-parallel evaluation needs a batch with a leading "
                     "(batch) dimension")


def data_parallel_loss(loss_fn: Callable, mesh) -> Callable:
    """``loss_fn`` evaluated data-parallel over ``mesh``'s batch axes.

    The wrapped function takes the GLOBAL batch, as a JAX step does: this
    rank evaluates ``loss_fn.parts`` on its rows (the leading axis split
    over the batch axes, ``infer_batch_spec``'s layout) and all-reduces
    its first two entries, the loss's sufficient statistics ``[s, w]``
    (one 2-element f32 tensor); the loss is ``s / max(w, 1)`` of the sums.
    That is the whole batch's loss, as GSPMD's reduction gives it, for
    every loss whose ``parts`` add over row shards: the registry's masked
    token means (unequal ``loss_mask``s weigh as in the full batch), its
    row-mean F1 (``models.registry.Bundle.loss_fn``) and the PEFT losses.
    The moe family's cross entropy adds a third entry, its load-balancing
    term: a product of batch means, whose routing sums (2E + 1 floats a
    layer) are all-reduced inside the forward through the
    ``models.common.batch_reducer`` installed here, so every rank holds
    the whole batch's term, added after the division.  A loss without
    ``parts`` is refused over more than one rank; over one rank every loss
    is its own reduction and passes through unchanged.  Over a one-rank
    group the result is the local loss bit for bit where the loss is
    ``s / max(w, 1)`` of its own parts (the masked cross entropy and
    accuracy every registry batch takes)."""
    from repro_torch.distributed.sharding import batch_axes, device_mesh_of
    from repro_torch.exec.engine import slice_group
    from repro_torch.models.common import batch_reducer
    dm = device_mesh_of(mesh)
    axes = batch_axes(dm)
    if not axes:
        return loss_fn
    names = tuple(dm.mesh_dim_names)
    sizes = [int(dm.mesh.shape[names.index(a)]) for a in axes]
    n_shards = math.prod(sizes)
    parts = getattr(loss_fn, "parts", None)
    if parts is None:
        if n_shards == 1:
            return loss_fn
        raise ValueError(
            f"data-parallel evaluation over the {n_shards} ranks of the "
            f"batch axes {axes} reduces each rank's loss statistics, and "
            f"{getattr(loss_fn, '__qualname__', loss_fn)!r} carries no "
            "`parts(params, batch)` ([s, w] that add over row shards, the "
            "loss being s / max(w, 1), and optionally a third entry every "
            "rank holds alike, added after). Give the loss its parts, or "
            "run it without a mesh")
    coord = dm.get_coordinate()
    shard = 0
    for a, s in zip(axes, sizes):
        shard = shard * s + int(coord[names.index(a)])
    group = axes_group(dm, axes)

    def all_sum(t):
        import torch.distributed as dist
        t = t.to(torch.float32).clone()
        dist.all_reduce(t, group=group)
        return t

    def loss(params, batch):
        rows = _rows(batch)
        if rows % n_shards:
            raise ValueError(
                f"the global batch's {rows} rows do not split over the "
                f"{n_shards} ranks of the batch axes {axes}")
        with batch_reducer(all_sum):
            out = torch.as_tensor(parts(params, slice_group(
                batch, shard, n_shards)), dtype=torch.float32).reshape(-1)
        sw = all_sum(out[:2])
        mean = sw[0] / torch.clamp_min(sw[1], 1.0)
        return mean if out.numel() == 2 else mean + out[2]

    return loss


def mesh_loss(loss_fn: Callable, mesh) -> Callable:
    """``loss_fn`` over a plan's mesh, taking the GLOBAL batch.

    * θ as DTensors (tensor parallelism, leaves placed under
      ``param_shardings``): the batch is placed on the mesh — each rank's
      rows over the batch axes, as ``StepProgram.shardings`` gives them
      (``sharding.place``: cut from the rank's copy, nothing sent) — and
      the loss runs as one DTensor program under the activation resolver
      and ``implicit_replication`` (the model's plain constants mix in as
      replicated): DTensor inserts the reductions, as XLA does for JAX.
      The loss comes back a DTensor, read on the host as one value.
    * plain θ: ``data_parallel_loss`` — the rank's rows, scalars only on
      the wire (a loss it refuses is refused at the first call)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import (P, NamedSharding,
                                                  batch_axes, device_mesh_of,
                                                  make_activation_resolver,
                                                  place)
    from repro_torch.kernels._build import live_dtensor
    from repro_torch.models.common import shard_resolver
    dm = device_mesh_of(mesh)
    resolver = make_activation_resolver(dm)
    ba = batch_axes(dm)
    b_ax = ba if len(ba) > 1 else (ba[0] if ba else None)
    rows = math.prod(int(dm.mesh.shape[tuple(dm.mesh_dim_names).index(a)])
                     for a in ba)
    try:
        dp, refusal = data_parallel_loss(loss_fn, dm), None
    except ValueError as e:
        dp, refusal = None, e

    def sharding(x):
        split = (isinstance(x, torch.Tensor) and x.dim() >= 1
                 and x.shape[0] % rows == 0)
        return NamedSharding(dm, P(b_ax) if split else P())

    def loss(params, batch):
        if any(live_dtensor(t) for t in tree_leaves(params)):
            placed = place(batch, tree_map(sharding, batch))
            with shard_resolver(resolver), implicit_replication():
                return loss_fn(params, placed)
        if dp is None:
            raise refusal
        return dp(params, batch)

    return loss


# --------------------------------------------------------------------------- #
# Seed-parallel n-SPSA: the legacy surface over the engine
# --------------------------------------------------------------------------- #
class SeedParallelState(NamedTuple):
    """Deprecated pre-engine state (step, base_key).  The engine runs on the
    uniform ``ZOState``; this shape is still accepted by the step function
    built below (converted on the fly) so legacy callers keep working."""
    step: int
    base_key: Key


def seed_parallel_init(seed: int = 0) -> SeedParallelState:
    return SeedParallelState(0, prng_key(seed))


def seed_parallel_step_fn(loss_fn: Callable, optimizer, n_groups: int,
                          mesh=None):
    """``step(params, state, batch) -> (params, state, metrics)`` on the
    engine's seed-parallel plan (θ updated in place, as every port step).

    ``optimizer`` is a ``repro_torch.zo`` protocol conformer (or legacy
    config).  ``batch`` leaves must have a leading dim divisible by
    ``n_groups``; slice g is evaluated under seed group g.  Accepts both the
    engine's ``ZOState`` and the deprecated ``SeedParallelState``
    (scalar-chain optimizers only)."""
    opt = as_zo_optimizer(optimizer)
    prog = StepProgram(opt, plan_mod.seed_parallel(n_groups, mesh=mesh))
    engine_step = prog.step_fn(loss_fn)

    def step(params: PyTree, state, batch):
        if isinstance(state, SeedParallelState):
            est_state = opt.estimator.init(None, state.base_key)
            tf_state = opt.transform.init(None)
            if tree_leaves(est_state) or tree_leaves(tf_state):
                # the legacy (step, base_key) state has nowhere to carry
                # estimator/transform state across steps — re-initializing
                # it every call would silently bias stateful estimators
                # (one_point's residual, rescaled's D-tree)
                raise ValueError(
                    "the legacy SeedParallelState supports stateless "
                    "estimator/transform chains only; drive this optimizer "
                    "through repro_torch.exec.StepProgram with its ZOState "
                    "(prog.init(params, seed=...))")
            zstate = ZOState(step=state.step, base_key=state.base_key,
                             est_state=est_state, tf_state=tf_state,
                             last_projected_grad=f32(0.0))
            p, zs, metrics = engine_step(params, zstate, batch)
            return p, SeedParallelState(zs.step, zs.base_key), metrics
        return engine_step(params, state, batch)

    return step


def seed_parallel_grads(loss_fn: Callable, params: PyTree, batches: PyTree,
                        base_key: Key, step_idx: int, eps: float,
                        n_groups: int, dist: str = "gaussian",
                        backend=None) -> np.ndarray:
    """Pure estimator form (used by tests): group g evaluates seed g on
    ``batches[g]`` at the step's center parameters; returns the n projected
    gradients (f32).  Each group runs on a copy of ``params``, which keeps
    its bits.

    BEHAVIOR CHANGE (engine canonicalization): at ``n_groups == 1`` the
    stream key is the unfolded step key (== the local plan), where the
    pre-engine helper folded group 0 — warned below."""
    from repro_torch.zo import estimators
    if n_groups == 1:
        warnings.warn(
            "seed_parallel_grads(n_groups=1) now uses the engine's unfolded "
            "step key (aligned with the local plan); the pre-engine helper "
            "folded group 0, so results differ from pre-engine runs",
            UserWarning, stacklevel=2)
    est = estimators.spsa(eps=eps, dist=dist, backend=get_backend(backend))
    skey0 = step_key(base_key, step_idx)
    gs = []
    with torch.no_grad():
        for g in range(n_groups):
            bg = tree_map(lambda x: x[g], batches)
            e = est.estimate(loss_fn, tree_clone(params), bg,
                             group_key(skey0, g, n_groups), ())
            gs.append(f32(e.projected_grad))
    return np.stack(gs)


def apply_seed_parallel_update(params: PyTree, base_key: Key, step_idx: int,
                               grads, lr, n_groups: int,
                               weight_decay: float = 0.0,
                               dist: str = "gaussian",
                               backend=None) -> PyTree:
    """θ ← θ − (η/n) Σ_g g_g · z_g (identical on every replica), in place,
    via the engine's shared write path; decay applied once, on the first
    group — the same floats a ledger replay of this step performs.

    BEHAVIOR CHANGES (engine canonicalization, warned): the decay term is
    the transform chain's η·λ once per step (pre-engine: (η/n)·λ), and at
    ``n_groups == 1`` the stream key is the unfolded step key (pre-engine:
    folded group 0)."""
    be = get_backend(backend)
    if n_groups == 1:
        warnings.warn(
            "apply_seed_parallel_update(n_groups=1) now uses the engine's "
            "unfolded step key (aligned with the local plan); pre-engine "
            "single-group updates folded group 0 and are not reproducible "
            "through this helper", UserWarning, stacklevel=2)
    if weight_decay:
        warnings.warn(
            "apply_seed_parallel_update now applies the decoupled decay as "
            "η·λ once per step (the transform chain's add_weight_decay "
            "rule); the pre-engine helper applied (η/n)·λ — reconstructions "
            "of pre-engine decayed runs will differ", UserWarning,
            stacklevel=2)
    skey0 = step_key(base_key, step_idx)
    grads = np.asarray(grads, f32)
    # JAX's weakly typed Python scalars: (lr / n) and lr·λ are formed in
    # float64 and rounded once to f32
    coeffs = [f32(lr / n_groups) * grads[g] for g in range(n_groups)]
    return apply_group_updates(params, skey0, coeffs,
                               f32(lr * weight_decay), n_groups, 1, dist, be)
