"""``PerturbBackend`` — the port of ``repro.perturb.base``: the interface
every z-generation strategy implements, the replay identity check and its
error type.

A backend writes parameters only through these methods and regenerates z
from a ``StreamRef`` inside them; z is never part of a signature.  Its
``stream_id`` is what ledgers and checkpoints record, and replay under a
different id refuses (``BackendMismatchError``) instead of silently
reconstructing different parameters."""
from __future__ import annotations

from typing import Optional

from repro_torch.perturb.stream import StreamRef
from repro_torch.tree_utils import PyTree


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


class PerturbBackend:
    """Interface: the single-stream contract of ``repro.perturb``.  The
    multi-stream methods (``perturb_many``, ``affine_many``) and ``leaf_z``
    come with the multi-seed slice."""

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
                f"dist={dist!r} (supported: {sorted(self.dists)}); sphere "
                "needs the zo_sqnorm kernel, ported with the multi-seed slice")

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
