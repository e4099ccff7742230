"""``PerturbBackend`` — the port of ``repro.perturb.base``: the interface
every z-generation strategy implements, the replay identity check and its
error type.

A backend writes parameters only through these methods and regenerates z
from a ``StreamRef`` inside them; z is never part of a signature.  Its
``stream_id`` is what ledgers and checkpoints record, and replay under a
different id refuses (``BackendMismatchError``) instead of silently
reconstructing different parameters."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.perturb.stream import StreamRef
from repro_torch.tree_utils import PyTree, tree_map, tree_map_with_index


class BackendMismatchError(RuntimeError):
    """A seed-replay artifact (ledger / checkpoint) was produced under one
    perturbation backend and is being replayed under another."""


def check_replay_backend(recorded: Optional[str], active: Optional[str],
                         what: str) -> None:
    """Raise ``BackendMismatchError`` if a recorded artifact's stream id does
    not match the active one (``None`` on either side skips the check)."""
    if recorded is None or active is None:
        return
    if recorded != active:
        if recorded.partition("+z")[0] == active.partition("+z")[0]:
            raise BackendMismatchError(
                f"{what} was recorded under z-stream {recorded!r} but this "
                f"build's {active.partition('+z')[0]!r} backend generates "
                f"{active!r}: the backend's z-generator arithmetic changed "
                "between versions, so replay would silently reconstruct "
                "different parameters.  Resume from a full tensor checkpoint "
                "(or re-run) instead of replaying this artifact.")
        raise BackendMismatchError(
            f"{what} was recorded under the {recorded!r} perturbation backend "
            f"but is being replayed under {active!r}; the backends generate "
            "different z streams for the same seed, so replay would silently "
            "reconstruct different parameters.  Re-create the optimizer with "
            f"backend={recorded!r} (e.g. zo.mezo(..., backend={recorded!r})).")


def per_stream_scales(scale, n_refs: int):
    """Normalize ``perturb_many``'s ``scale`` argument: ``None`` for a shared
    scalar (backends keep their shared-coefficient kernel for it), else the
    per-stream list.  A 1-D sequence/array must have one entry per ref."""
    if isinstance(scale, (tuple, list)):
        per = list(scale)
    elif np.ndim(scale) == 1:
        per = [scale[j] for j in range(len(scale))]
    else:
        return None
    if len(per) != n_refs:
        raise ValueError(
            f"per-stream scale has {len(per)} entries for {n_refs} refs")
    return per


def shard_view(p) -> tuple:
    """What a z kernel writes for leaf ``p``: a live DTensor's local shard
    and its ``ShardMap`` (``None`` when the leaf is replicated: the shard
    is the whole leaf), else ``p`` itself and ``None`` — a plain tensor,
    or a dry run's DTensor on ``meta``, whose shape rule charges its local
    shard."""
    from repro_torch.kernels import _build
    if not _build.live_dtensor(p):
        return p, None
    return p.to_local(), _build.shard_map(p)


def unsharded(p, what: str):
    """``p`` as a z kernel with no shard map yet may write it: a live
    DTensor's local tensor when the leaf is replicated (else ``p``); a
    sharded one raises, naming the queue that holds the work."""
    local, smap = shard_view(p)
    if smap is not None:
        raise NotImplementedError(
            f"{what} has no shard map yet, and this leaf is sharded "
            f"({tuple(p.shape)}, {p.placements}): the rows plans (K7–K10, "
            "and X1's bands and original bands) wait in ROADMAP Queue 2; "
            "whole leaves take the shard routes of every other z kernel")
    return local


def rewrap(p, local):
    """``local`` — a fresh shard written for leaf ``p`` — as ``p``'s kind:
    a DTensor with ``p``'s placements when ``p`` is a live DTensor, else
    ``local`` itself."""
    from repro_torch.kernels import _build
    if not _build.live_dtensor(p):
        return local
    from torch.distributed.tensor import DTensor
    if all(pl.is_replicate() for pl in p.placements):
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False)
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def rewrap_stacked(p, out):
    """``out`` — streams written from leaf ``p``'s shard, stacked on a new
    leading axis — as ``p``'s kind: for a live DTensor ``p`` the DTensor of
    the global ``(n, *p.shape)`` stack, each ``Shard(d)`` moved to
    ``Shard(d + 1)`` and ``Replicate`` kept (``_build.stacked_dtensor``),
    so ``out[j]`` is a DTensor with ``p``'s own placements; else ``out``."""
    from repro_torch.kernels import _build
    if not _build.live_dtensor(p):
        return out
    return _build.stacked_dtensor(p, out)


class NormShare(NamedTuple):
    """The sphere's ‖z‖² split over the ``parts`` ranks of the tensor-
    parallel axes: this rank measures share ``rank`` of the norm's work
    list, and ``gather`` all-gathers a 1-D tensor of partial sums over
    those ranks, in rank order (``collectives.gather_over``)."""
    rank: int
    parts: int
    gather: Callable


def norm_share(params: PyTree) -> Optional[NormShare]:
    """How the sphere's ‖z‖² is split: ``None`` — one process measures
    every leaf — unless θ's leaves are DTensors (live, or a dry run's on
    ``meta``) on a mesh whose tensor-parallel axes (``sharding.tp_axes``)
    hold more than one rank.  z depends on the seed and the global index
    only, never on θ, so the split need not follow θ's shards: each rank
    takes a contiguous share of the work and the shares' partial sums are
    gathered and folded in the one-process order on every rank."""
    from repro_torch.tree_utils import tree_leaves
    mesh = next((p.device_mesh for p in tree_leaves(params)
                 if hasattr(p, "placements")), None)
    if mesh is None:
        return None
    import torch.distributed as dist

    from repro_torch.distributed.collectives import axes_group, gather_over
    from repro_torch.distributed.sharding import axis_size, tp_axes
    axes = tuple(a for a in tp_axes(mesh) if a in mesh.mesh_dim_names)
    if not axes or axis_size(mesh, axes) == 1:
        return None
    group = axes_group(mesh, axes)
    return NormShare(dist.get_rank(group), dist.get_world_size(group),
                     lambda t: gather_over(t, mesh, axes))


class PerturbBackend:
    """Interface: the contract of ``repro.perturb`` — single-stream writes
    (``perturb``, ``fused_restore_update``, ``apply_rank1``), ``leaf_z``,
    and the multi-stream ``perturb_many`` / ``affine_many``.

    JAX's backends return new trees; a port backend writes the caller's
    leaves in place (the paper's in-place trick) and returns them.  The
    stacked result of ``perturb_many`` is new memory and leaves θ alone."""

    name: str = "?"
    dists: frozenset = frozenset()
    stream_version: int = 1

    @property
    def stream_id(self) -> str:
        return (self.name if self.stream_version == 1
                else f"{self.name}+z{self.stream_version}")

    def check_dist(self, dist: str) -> None:
        if dist not in self.dists:
            raise NotImplementedError(
                f"perturbation backend {self.name!r} does not implement "
                f"dist={dist!r} (supported: {sorted(self.dists)})")

    def perturb(self, params: PyTree, ref: StreamRef, scale,
                dist: str = "gaussian") -> PyTree:
        """θ + scale · z(ref)."""
        raise NotImplementedError

    def fused_restore_update(self, params_minus: PyTree, ref: StreamRef, eps,
                             lr_g, weight_decay=0.0,
                             dist: str = "gaussian") -> PyTree:
        """From θ − εz produce (1 − η·λ)·θ − η·g·z in one pass."""
        raise NotImplementedError

    def apply_rank1(self, params: PyTree, ref: StreamRef, coeff,
                    decay_term=0.0, dist: str = "gaussian",
                    d_tree: Optional[PyTree] = None) -> PyTree:
        """θ ← (1 − decay_term)·θ − coeff·z(ref): the primitive shared by
        live steps and ledger replay.  ``d_tree`` (one positive f32 scalar
        per leaf) rescales z leaf by leaf — Definition 6's D·z."""
        raise NotImplementedError

    def perturb_leaf(self, p: torch.Tensor, ref: StreamRef, leaf_index: int,
                     scale, dist: str = "gaussian") -> torch.Tensor:
        """p + scale·z(ref, leaf ``leaf_index``) on one leaf, in place, in
        one kernel pass — what rescaled SPSA's per-leaf perturbation writes
        (JAX forms it from ``leaf_z``; sphere takes the plain gaussian
        direction)."""
        raise NotImplementedError

    def leaf_z(self, ref: StreamRef, leaf_index: int, like: torch.Tensor,
               dist: str = "gaussian") -> torch.Tensor:
        """One leaf's z, materialized (shape/dtype of ``like``)."""
        raise NotImplementedError

    def perturb_many(self, params: PyTree, refs: Sequence[StreamRef], scale,
                     dist: str = "gaussian") -> PyTree:
        """θ + scale_j · z(ref_j) for each ref, stacked on a new leading axis
        (each leaf of the result has shape ``(len(refs), *leaf.shape)``);
        θ is left as it was.  ``scale`` is a shared scalar or one per ref.

        This default stacks ``perturb`` singles, each on a copy of the
        leaves the first ref's selection picks (an unselected leaf is never
        written, so it is shared, not copied) — bitwise the sequential path
        by construction; backends override it with a fused kernel under
        that contract."""
        self.check_dist(dist)
        if not refs:
            raise ValueError("perturb_many needs at least one StreamRef")
        per = per_stream_scales(scale, len(refs))
        mask = refs[0].selection_mask(params)

        def copy(i, p):
            picked = mask is None or mask[i]
            return p.clone() if picked and isinstance(p, torch.Tensor) else p

        cols = [self.perturb(tree_map_with_index(copy, params), r,
                             scale if per is None else per[j], dist)
                for j, r in enumerate(refs)]
        return tree_map(lambda *xs: torch.stack(xs), *cols)

    def affine_many(self, params: PyTree, refs: Sequence[StreamRef],
                    coeffs: Sequence, decay_terms: Sequence,
                    dist: str = "gaussian") -> PyTree:
        """The chained multi-stream rank-1 update, the one multi-seed write
        path (fzoo's update, the seed-group updates, batched replay):

            for j in stream order:
                θ ← (1 − decay_terms[j]) · θ − coeffs[j] · z(ref_j)

        This default IS the literal sequential ``apply_rank1`` fold;
        backends override it with a fused kernel that stays bitwise-equal
        to it."""
        self.check_dist(dist)
        _check_many(refs, coeffs, decay_terms)
        p = params
        for ref, coeff, decay in zip(refs, coeffs, decay_terms):
            p = self.apply_rank1(p, ref, coeff, decay, dist)
        return p


def _check_many(refs, coeffs, decay_terms) -> None:
    if not refs:
        raise ValueError("affine_many needs at least one StreamRef")
    if not (len(refs) == len(coeffs) == len(decay_terms)):
        raise ValueError(
            f"affine_many needs one coefficient and one decay term per "
            f"stream; got {len(refs)} refs, {len(coeffs)} coeffs, "
            f"{len(decay_terms)} decay terms")
