"""The five examples of ``examples/``, ported: each runs as ``python -m
repro_torch.examples.<name>``, on the card by default (``--device cpu``
runs the plain kernels on the CPU), and prints JAX's lines."""
