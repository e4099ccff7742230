"""Content-addressed adapter storage: the ledger IS the fine-tune — the port
of ``repro.serve.tenants.store``.

A MeZO fine-tune is fully determined by its trajectory ledger — a few KB of
seeds + projected-grad scalars (paper §2.1) — so a store of per-tenant
fine-tunes is a store of ledger blobs.  ``AdapterStore`` keeps them
content-addressed: an adapter's key is ``(ledger.content_hash(), steps)``,
so two tenants whose ledgers would replay the identical delta share a key
(and every cache entry downstream).

``AdapterDelta`` is the materialized form: the leaves a replayed ledger
changed, by flattened leaf index (``repro_torch.tree_utils`` order, which is
``jax.tree_util.tree_flatten``'s, so an index names the same leaf in both
packages).  It is selection-sized — a ``peft(lora)`` fine-tune's serving
delta holds only the attention leaves the merge touches.  ``diff`` compares
leaves bit for bit where they lie (a qwen2-0.5b tree never leaves the
card); ``apply`` is pure leaf replacement, so a cached delta is bitwise the
fresh replay it was extracted from by construction.

``LedgerHashMismatchError`` joins the Backend/Plan/SelectionMismatchError
refusal family: a stored blob that no longer hashes to its key, or a
compaction record paired with another ledger, refuses loudly instead of
serving a different tenant's weights.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.trajectory import TrajectoryLedger
from repro_torch.tree_utils import (PyTree, flatten_with_path, is_floating,
                                    tree_unflatten)

AdapterKey = tuple  # (content_hash: str, n_records: int)

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class LedgerHashMismatchError(RuntimeError):
    """Two artifacts that must describe the same recorded trajectory (a
    stored blob and its content-hash key; a compaction record and the ledger
    prefix it folded) disagree.  Continuing would materialize — and serve —
    parameters the tenant's ledger does not describe, so refuse instead."""


def same_bits(a, b) -> bool:
    """``a`` and ``b`` hold the same shape, dtype and bytes — compared on
    their device (a NaN equals itself, −0 differs from +0)."""
    if a is b:
        return True
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        na, nb = np.asarray(a), np.asarray(b)
        return (na.shape == nb.shape and na.dtype == nb.dtype
                and na.tobytes() == nb.tobytes())
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        return False
    if a.dtype.is_floating_point or a.dtype.is_complex:
        view = _BITS[a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return bool(torch.equal(a, b))


class AdapterDelta(NamedTuple):
    """The changed-leaf subset of a materialized adapter.

    ``indices`` are flattened-leaf positions of the tree it was diffed
    against, ``values`` the leaf tensors there.  ``n_leaves`` /
    ``n_float_leaves`` record that tree's totals, so ``full_tree`` (every
    floating leaf changed — the engine then decodes the adapter grouped,
    not stacked) is decidable without the tree."""
    indices: tuple
    values: tuple
    n_leaves: int
    n_float_leaves: int

    @classmethod
    def diff(cls, base: PyTree, tuned: PyTree) -> "AdapterDelta":
        """The leaves of ``tuned`` that differ from ``base`` by even one
        bit.  Replay writes only the leaves it updates, so the diff recovers
        exactly the replayed support; a selected leaf that round-trips to
        its base value is safely dropped (applying the delta still gives
        ``tuned`` bitwise)."""
        b_flat, t_flat = flatten_with_path(base), flatten_with_path(tuned)
        if [p for p, _ in b_flat] != [p for p, _ in t_flat]:
            raise ValueError(
                "AdapterDelta.diff needs structurally identical trees; got "
                f"{[p for p, _ in b_flat]} vs {[p for p, _ in t_flat]}")
        idx, vals = [], []
        n_float = 0
        for i, ((_, b), (_, t)) in enumerate(zip(b_flat, t_flat)):
            n_float += is_floating(b)
            if not same_bits(b, t):
                idx.append(i)
                vals.append(t)
        return cls(tuple(idx), tuple(vals), len(b_flat), n_float)

    @property
    def nbytes(self) -> int:
        """Bytes the delta's buffers occupy — the unit the ``DeltaCache``
        budget is accounted in."""
        return sum(int(v.numel()) * v.element_size() for v in self.values)

    @property
    def full_tree(self) -> bool:
        """True when every floating leaf changed (a full fine-tune): stacking
        it per slot would duplicate the whole model, so the engine groups
        such adapters instead."""
        return len(self.indices) >= self.n_float_leaves

    def apply(self, base: PyTree) -> PyTree:
        """``base`` with the delta's leaves swapped in — pure structural
        replacement (no copies, no arithmetic): the tree references the
        stored buffers, so applying a cached delta costs no replay and no
        parameter-sized traffic.  Nothing may write into the result in
        place (the engine only reads it)."""
        leaves = [leaf for _, leaf in flatten_with_path(base)]
        for i, v in zip(self.indices, self.values):
            if leaves[i].shape != v.shape or leaves[i].dtype != v.dtype:
                raise ValueError(
                    f"delta leaf {i} has shape/dtype {tuple(v.shape)}/"
                    f"{v.dtype} but the base tree's leaf is "
                    f"{tuple(leaves[i].shape)}/{leaves[i].dtype}; this delta "
                    "was extracted against a different parameter tree")
            leaves[i] = v
        return tree_unflatten(base, leaves)


class AdapterStore:
    """Content-addressed store of tenant fine-tune artifacts.

    Tenants map to adapter keys; keys map to serialized ledger blobs (the
    MZOL wire format, byte for byte JAX's) and, optionally, a compaction
    record (``repro_torch.serve.tenants.compact``).  Tenants with identical
    ledgers share one blob and one key.  ``ledger()`` re-verifies the
    content hash on read, so a corrupted or mis-filed blob refuses
    (``LedgerHashMismatchError``)."""

    def __init__(self):
        self._blobs: dict = {}          # content_hash -> bytes
        self._tenants: dict = {}        # tenant -> AdapterKey
        self._compacted: dict = {}      # content_hash -> CompactedAdapter

    # -- writes ------------------------------------------------------------- #
    def put(self, tenant, ledger: TrajectoryLedger) -> AdapterKey:
        """Register ``tenant``'s fine-tune; returns its content-hash key."""
        chash = ledger.content_hash()
        key = (chash, len(ledger))
        self._blobs.setdefault(chash, ledger.to_bytes())
        self._tenants[tenant] = key
        return key

    def put_compacted(self, tenant, compacted) -> None:
        """Attach a compaction record to ``tenant``'s adapter (keyed on the
        same content hash, so equal ledgers share the compacted form)."""
        chash, _ = self.key(tenant)
        if compacted.full_hash != chash:
            raise LedgerHashMismatchError(
                f"compaction record was built from a ledger with content "
                f"hash {compacted.full_hash[:12]}… but tenant {tenant!r}'s "
                f"stored ledger hashes to {chash[:12]}…; attaching it would "
                "materialize a different tenant's parameters")
        self._compacted[chash] = compacted

    # -- reads -------------------------------------------------------------- #
    def tenants(self) -> list:
        return sorted(self._tenants)

    def key(self, tenant) -> AdapterKey:
        if tenant not in self._tenants:
            raise KeyError(f"unknown tenant {tenant!r}; registered: "
                           f"{self.tenants()[:8]}...")
        return self._tenants[tenant]

    def ledger(self, tenant) -> TrajectoryLedger:
        """Deserialize ``tenant``'s ledger, re-verifying its content hash —
        the read-side half of the refuse-on-mismatch contract."""
        chash, _ = self.key(tenant)
        led = TrajectoryLedger.from_bytes(self._blobs[chash])
        actual = led.content_hash()
        if actual != chash:
            raise LedgerHashMismatchError(
                f"stored blob for adapter {chash[:12]}… deserializes to a "
                f"ledger with content hash {actual[:12]}…; the artifact was "
                "corrupted or mis-filed — refusing to materialize from it")
        return led

    def compacted(self, tenant):
        """The tenant's compaction record, or ``None``."""
        chash, _ = self.key(tenant)
        return self._compacted.get(chash)

    def nbytes(self) -> int:
        """Total stored ledger bytes (a few KB per tenant, before any
        compaction records)."""
        return sum(len(b) for b in self._blobs.values())

    def __len__(self) -> int:
        return len(self._tenants)
