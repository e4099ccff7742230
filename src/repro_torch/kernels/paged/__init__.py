"""K12 ``paged_gather``: KV block rows gathered by a block table.  JAX's
``paged_gather_ref`` (the XLA gather the kernel is held to) is the port's
plain version, ``paged_gather_plain``."""
from repro_torch.kernels.paged.gather import paged_gather, paged_gather_plain

paged_gather_ref = paged_gather_plain

__all__ = ["paged_gather", "paged_gather_plain", "paged_gather_ref"]
