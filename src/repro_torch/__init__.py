"""``repro_torch`` — the PyTorch / CUDA (Hopper) port of ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its module
names so each counterpart is easy to find (``repro.perturb.stream`` ↔
``repro_torch.perturb.stream`` …).  It imports ``torch`` and never ``jax``,
nor anything of ``repro``.

Conventions:

* parameters are nested dicts of tensors in the JAX layout (block leaves
  stacked over layers on axis 0), flattened in jax's order (sorted keys) by
  :mod:`repro_torch.tree_utils`;
* every entry point takes an explicit ``device``: ``None`` means the CUDA
  card, and raises when there is none — the CPU is used only when the caller
  asks for it (``device="cpu"``), as the tests do (:mod:`repro_torch.device`);
* model weights come from ``torch.Generator``; the z streams of the MeZO
  ledger (JAX's threefry ``xla`` stream through X1, or the counter-hash
  ``pallas+z2`` stream) and the step-indexed data are bitwise-equal to
  JAX's.

Each Pallas kernel (and X1, the kernel of the ``xla`` stream) has a
hand-written CUDA kernel under
``kernels/*/csrc/`` (built with nvcc at first use, bound through ctypes) and
a plain torch version in the same module, which only CPU tensors take.
"""
