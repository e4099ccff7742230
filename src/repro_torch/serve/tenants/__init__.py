"""Ledger-native multi-tenant adapter serving — the port of
``repro.serve.tenants``.

MeZO's storage property (paper §2.1) makes per-user fine-tunes a few KB of
seeds + scalars, cheap enough to store by the thousands; this package turns
that into a serving product:

    train → MZOL ledger → AdapterStore (content-hash keyed)
                       → compact()     (delta + replayable tail, O(tail))
                       → DeltaCache    (byte-budgeted LRU of materialized
                                        selection-sized deltas)
                       → ServeEngine   (stacked or grouped mixed-adapter
                                        decode)

Every materialization replays through the backend write path training used
(X1 on ``xla``, K1 on ``pallas``), so cached, compacted and freshly
replayed deltas are bitwise equal; identity mismatches refuse loudly
(``LedgerHashMismatchError``).
"""
from repro_torch.serve.tenants.cache import DeltaCache
from repro_torch.serve.tenants.compact import (CompactedAdapter, compact,
                                               materialize)
from repro_torch.serve.tenants.runtime import (TenantRuntime,
                                               composition_for_ledger)
from repro_torch.serve.tenants.store import (AdapterDelta, AdapterStore,
                                             LedgerHashMismatchError)
from repro_torch.serve.tenants.synth import (lora_runtime, make_lora_tenants,
                                             serve_load, synthetic_requests,
                                             template_requests, tenant_name)

__all__ = [
    "AdapterDelta", "AdapterStore", "CompactedAdapter", "DeltaCache",
    "LedgerHashMismatchError", "TenantRuntime", "compact",
    "composition_for_ledger", "lora_runtime", "make_lora_tenants",
    "materialize", "serve_load", "synthetic_requests", "template_requests",
    "tenant_name",
]
