"""Byte-budgeted LRU cache of materialized adapter deltas — the port of
``repro.serve.tenants.cache`` (pure Python: its stats are JAX's for the
same sequence of ``get`` / ``put`` calls).

Materializing an adapter means replaying its ledger (O(steps) ``apply_rank1``
folds) or applying its compacted delta+tail; both are orders of magnitude
more expensive than a slot admission.  ``DeltaCache`` keeps the materialized
``AdapterDelta`` buffers of the hottest adapters resident so a warm adapter
swap costs *zero* replay folds — the cache hands back the exact buffers the
first materialization produced, and applying them is pure leaf replacement
(``AdapterDelta.apply``).

Keys are ``AdapterStore`` keys — ``(ledger content hash, n_records)`` — so
cache identity inherits the replay-determinism invariant: a hit can never
return stale weights for a retrained tenant, because retraining changes the
ledger and therefore the key.

Accounting is in bytes of delta buffers (``AdapterDelta.nbytes``), not entry
counts: a peft(lora) delta is ~3% of param bytes while a full-tune delta is
~100%, and a budget in entries would let a handful of full-tune tenants evict
thirty LoRA tenants' worth of reuse.  Eviction is LRU; an entry larger than
the whole budget is refused outright (``oversize``) rather than evicting
everything else for a single tenant.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from repro_torch.serve.tenants.store import AdapterDelta


class DeltaCache:
    """LRU over ``AdapterDelta`` values with a byte budget.

    ``get`` / ``put`` are the whole interface a runtime needs; ``stats``
    feeds the serving bench (hit rate is its headline number)."""

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._entries: OrderedDict = OrderedDict()   # key -> AdapterDelta
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.oversize = 0

    def get(self, key) -> Optional[AdapterDelta]:
        """The delta for ``key`` (refreshing its recency), or ``None``."""
        hit = self._entries.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key, delta: AdapterDelta) -> bool:
        """Insert ``delta``, evicting least-recently-used entries until the
        budget holds.  Returns False (and counts ``oversize``) when the delta
        alone exceeds the whole budget — caching it would evict every other
        tenant for one adapter's benefit."""
        nb = delta.nbytes
        if nb > self.budget_bytes:
            self.oversize += 1
            return False
        if key in self._entries:
            self.bytes -= self._entries.pop(key).nbytes
        self._entries[key] = delta
        self.bytes += nb
        while self.bytes > self.budget_bytes:
            _, evicted = self._entries.popitem(last=False)
            self.bytes -= evicted.nbytes
            self.evictions += 1
        return True

    def __contains__(self, key) -> bool:
        """Budget-planning peek — does NOT count as a hit/miss or refresh
        recency (use ``get`` on the serving path)."""
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "oversize": self.oversize,
                "entries": len(self._entries), "bytes": self.bytes,
                "budget_bytes": self.budget_bytes,
                "hit_rate": (self.hits / total) if total else 0.0}
