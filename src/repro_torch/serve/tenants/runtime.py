"""TenantRuntime: store + cache + compaction wired to a serving engine — the
port of ``repro.serve.tenants.runtime``.

The runtime owns the adapter lifecycle on a serving host:

    store.put(tenant, ledger)            # register the few-KB artifact
    runtime.delta(tenant)                # materialize (replay) or cache-hit
    engine.register_adapter(t, delta)    # hand the engine its leaf delta
    runtime.compact_tenant(tenant)       # fold a long ledger to O(tail)

Materialization is ledger replay through the run's recorded composition —
``composition_for_ledger`` rebuilds the exact optimizer (estimator family,
backend, selection, batch_seeds) from the MZOL header, so the runtime uses
the backend write path training used (X1 on ``xla``, K1 on ``pallas``) and
a cached delta is bitwise a fresh replay.

``records_replayed`` counts every ledger record the runtime folded; it does
not move on a cache hit — the warm path's cost is leaf replacement only.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.serve.tenants.cache import DeltaCache
from repro_torch.serve.tenants.compact import (CompactedAdapter, compact,
                                               materialize, replay_copy)
from repro_torch.serve.tenants.store import AdapterDelta, AdapterStore
from repro_torch.tree_utils import PyTree


def composition_for_ledger(led):
    """The ZO composition whose replay reproduces ``led``'s run, rebuilt from
    the header coordinates alone, as ``repro.serve.tenants`` does.

    The header's ``backend`` is the stream id (``"pallas+z2"``) while the
    factories take the registry name, so the ``+zN`` suffix is stripped for
    construction; ``check_replay_backend`` still compares full stream ids at
    replay time.  ``batch_seeds > 1`` → ``fzoo(batch_seeds=B)``, else
    ``mezo``; ``StepProgram.replay`` on the replay plan adopts the ledger's
    ``n_groups``.  A non-full selection is rebuilt from the MZOL5 header's
    spec and phase offset, so every record replays at its step's phase."""
    from repro_torch import zo
    sel = None
    if led.selection != "full" or led.sel_phase:
        from repro_torch.select import parse_selection
        sel = parse_selection(led.selection)._replace(
            phase_offset=int(led.sel_phase))
    backend = led.backend.partition("+z")[0]
    if led.batch_seeds > 1:
        return zo.fzoo(batch_seeds=led.batch_seeds, backend=backend,
                       selection=sel)
    return zo.mezo(backend=backend, selection=sel)


class TenantRuntime:
    """Materializes per-tenant serving deltas from stored ledgers.

    ``base_params`` is the frozen tree the serving engine runs (deltas are
    diffed against it).  ``params0_fn(ledger)`` rebuilds the tenant's
    training start tree — for peft(lora) runs the merged ``{"base", "lora"}``
    tree, the LoRA init seeded from the ledger's ``base_seed`` — and
    ``serve_map`` maps a tuned training tree to the serving tree (e.g.
    ``merge_lora``; identity for runs that train the serving tree).  The
    replays write into copies (``replay_copy``), so ``base_params`` is
    never written."""

    def __init__(self, base_params: PyTree, store: AdapterStore,
                 cache: Optional[DeltaCache] = None,
                 params0_fn: Optional[Callable] = None,
                 serve_map: Optional[Callable] = None,
                 optimizer_fn: Callable = composition_for_ledger):
        self.base_params = base_params
        self.store = store
        self.cache = cache
        self.params0_fn = params0_fn or (lambda led: base_params)
        self.serve_map = serve_map or (lambda tree: tree)
        self.optimizer_fn = optimizer_fn
        self.records_replayed = 0        # replay fold counter
        self.materializations = 0        # cold/compacted materializations

    # ------------------------------------------------------------------ #
    def delta(self, tenant) -> AdapterDelta:
        """The tenant's serving-tree delta: cache hit (zero folds) or
        materialization (compacted O(tail) if a record exists, else full
        ledger replay), diffed against ``base_params`` and cached."""
        key = self.store.key(tenant)
        if self.cache is not None:
            hit = self.cache.get(key)
            if hit is not None:
                return hit
        delta = AdapterDelta.diff(self.base_params,
                                  self.serve_map(self._materialize(tenant)))
        if self.cache is not None:
            self.cache.put(key, delta)
        return delta

    def _materialize(self, tenant) -> PyTree:
        led = self.store.ledger(tenant)
        opt = self.optimizer_fn(led)
        params0 = self.params0_fn(led)
        comp = self.store.compacted(tenant)
        self.materializations += 1
        if comp is not None:
            tuned = materialize(params0, comp, opt, ledger=led)
            self.records_replayed += len(comp.tail)
        else:
            tuned = replay_copy(params0, led, opt)
            self.records_replayed += len(led)
        return tuned

    def warmup(self, tenants=None) -> int:
        """Pre-materialize ``tenants`` (default: every registered tenant, in
        sorted order — under a tight budget the last warmed stay resident).
        Returns how many deltas were materialized or touched."""
        names = list(tenants) if tenants is not None else self.store.tenants()
        for t in names:
            self.delta(t)
        return len(names)

    def compact_tenant(self, tenant, keep_tail: int = 64) -> CompactedAdapter:
        """Fold the tenant's stored ledger (one prefix replay now, every
        later cold materialization O(tail)) and attach the record."""
        led = self.store.ledger(tenant)
        comp = compact(self.params0_fn(led), led, self.optimizer_fn(led),
                       keep_tail=keep_tail)
        self.records_replayed += comp.upto
        self.store.put_compacted(tenant, comp)
        return comp

    @property
    def stats(self) -> dict:
        out = {"records_replayed": self.records_replayed,
               "materializations": self.materializations,
               "tenants": len(self.store),
               "store_bytes": self.store.nbytes()}
        if self.cache is not None:
            out.update(self.cache.stats)
        return out
