"""Ledger compaction: fold a long trajectory into one delta + a replayable
tail — the port of ``repro.serve.tenants.compact``.

A tenant who fine-tuned for 10k steps costs 10k replay folds per cold
materialization.  Compaction replays the first ``len − keep_tail`` records
once, stores the changed-leaf delta, and keeps the remaining records as a
tail ledger — every later materialization is one leaf-replacement apply
plus O(tail) folds.

The construction is bitwise by design: the prefix delta comes from a replay
through the same backend write path training used, applying it is pure leaf
replacement, and the tail is ``ledger.slice(upto)`` — records keep their
step indices, so the tail's seed folds are the full replay's.  Hence
``materialize(params0, compact(params0, led, opt), opt)`` equals
``replay(params0, led, opt)`` bit for bit.

The port's ``replay`` writes into its tree in place (JAX's returns a new
one), so every replay here runs on ``replay_copy``: the leaves the
composition may write are copied first, and ``params0`` — the shared base,
or a stored delta's buffers — keeps its bits.

Identity is hash-anchored: the record carries the full ledger's content
hash (its ``AdapterStore`` key) and the folded prefix's; ``materialize``
re-checks both when given the ledger it believes the record compacts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from repro_torch.core.trajectory import TrajectoryLedger, replay
from repro_torch.serve.tenants.store import (AdapterDelta,
                                             LedgerHashMismatchError)
from repro_torch.tree_utils import (PyTree, flatten_with_path, is_floating,
                                    tree_map_with_index)


def replay_copy(params0: PyTree, ledger: TrajectoryLedger, optimizer,
                to_idx: Optional[int] = None) -> PyTree:
    """``replay`` that leaves ``params0`` as it was (JAX's functional
    replay): each leaf the composition's selection can reach, at any of its
    phases, is copied before the replay writes it; every other leaf is
    shared with ``params0``."""
    sel = getattr(getattr(optimizer, "opt", optimizer), "selection", None)
    leaves = [leaf for _, leaf in flatten_with_path(params0)]
    if sel is None or sel.is_full():
        hit = [is_floating(leaf) for leaf in leaves]
    else:
        masks = [sel.leaf_mask(params0, ph) for ph in range(sel.n_phases)]
        hit = [any(m[i] for m in masks) for i in range(len(leaves))]
    fresh = tree_map_with_index(
        lambda i, leaf: leaf.clone() if hit[i] else leaf, params0)
    return replay(fresh, ledger, optimizer, to_idx=to_idx)


class CompactedAdapter(NamedTuple):
    """A folded ledger prefix + its replayable tail.

    ``full_hash`` keys the record to the complete ledger it compacts (the
    adapter's store key); ``prefix_hash`` = ``ledger.content_hash(upto)``
    pins exactly which records the delta folded."""
    full_hash: str
    prefix_hash: str
    upto: int
    delta: AdapterDelta          # changed leaves of replay(params0, led[:upto])
    tail: TrajectoryLedger       # led[upto:], original step indices

    @property
    def nbytes(self) -> int:
        """Stored footprint: delta buffers + serialized tail."""
        return self.delta.nbytes + self.tail.nbytes()


def compact(params0: PyTree, ledger: TrajectoryLedger, optimizer,
            keep_tail: int = 64) -> CompactedAdapter:
    """Fold ``ledger``'s first ``len − keep_tail`` records into a stored
    delta (one replay, paid once) and keep the last ``keep_tail`` as the
    replayable tail; ``keep_tail ≥ len`` is an empty fold, all tail."""
    if keep_tail < 0:
        raise ValueError(f"keep_tail must be >= 0, got {keep_tail}")
    upto = max(0, len(ledger) - int(keep_tail))
    mid = replay_copy(params0, ledger, optimizer, to_idx=upto)
    return CompactedAdapter(
        full_hash=ledger.content_hash(),
        prefix_hash=ledger.content_hash(upto),
        upto=upto,
        delta=AdapterDelta.diff(params0, mid),
        tail=ledger.slice(upto))


def materialize(params0: PyTree, compacted: CompactedAdapter, optimizer,
                ledger: Optional[TrajectoryLedger] = None) -> PyTree:
    """The tuned parameters from a compaction record in O(tail): apply the
    stored prefix delta, then replay the tail (onto copies, so the record's
    buffers keep their bits).  Pass the ``ledger`` the record is believed
    to compact for the hash cross-checks (refuses on mismatch)."""
    if ledger is not None:
        if ledger.content_hash() != compacted.full_hash:
            raise LedgerHashMismatchError(
                f"compaction record folds a ledger with content hash "
                f"{compacted.full_hash[:12]}… but was asked to materialize "
                f"one hashing to {ledger.content_hash()[:12]}…; the tenant "
                "was retrained — recompact instead of serving stale weights")
        if ledger.content_hash(compacted.upto) != compacted.prefix_hash:
            raise LedgerHashMismatchError(
                f"compaction record folded records [0, {compacted.upto}) "
                f"with hash {compacted.prefix_hash[:12]}… but the supplied "
                "ledger's prefix hashes differently; refusing to splice a "
                "delta onto a tail it does not precede")
    mid = compacted.delta.apply(params0)
    if len(compacted.tail) == 0:
        return mid
    return replay_copy(mid, compacted.tail, optimizer)
