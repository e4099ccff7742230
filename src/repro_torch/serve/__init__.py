"""Serving layer: the continuous-batching engine (``engine``) and the
ledger-native multi-tenant runtime (``tenants``), as ``repro.serve``."""
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
