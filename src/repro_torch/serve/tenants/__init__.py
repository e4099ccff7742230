"""Multi-tenant serving (ported with the tenants slice; so far the
ledger → composition rule)."""
from repro_torch.serve.tenants.runtime import composition_for_ledger

__all__ = ["composition_for_ledger"]
