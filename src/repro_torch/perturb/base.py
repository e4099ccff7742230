"""``PerturbBackend`` — the port of ``repro.perturb.base``: the interface
every z-generation strategy implements, the replay identity check and its
error type.

A backend writes parameters only through these methods and regenerates z
from a ``StreamRef`` inside them; z is never part of a signature.  Its
``stream_id`` is what ledgers and checkpoints record, and replay under a
different id refuses (``BackendMismatchError``) instead of silently
reconstructing different parameters."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.perturb.stream import StreamRef
from repro_torch.tree_utils import PyTree, tree_clone, tree_map


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
                    decay_term=0.0, dist: str = "gaussian") -> PyTree:
        """θ ← (1 − decay_term)·θ − coeff·z(ref): the primitive shared by
        live steps and ledger replay."""
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

        This default stacks ``perturb`` singles, each on a copy of θ —
        bitwise the sequential path by construction; backends override it
        with a fused kernel under that contract."""
        self.check_dist(dist)
        if not refs:
            raise ValueError("perturb_many needs at least one StreamRef")
        per = per_stream_scales(scale, len(refs))
        cols = [self.perturb(tree_clone(params), r,
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
