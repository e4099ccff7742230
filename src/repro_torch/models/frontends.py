"""Modality frontend stubs — the port of ``repro.models.frontends``.

The ``[audio]`` and ``[vlm]`` archs specify the transformer backbone only;
these stubs stand in for their frontends with deterministic synthetic
embeddings: JAX's ``jax.random.normal(key, shape, dtype) · 0.02``, drawn
with the port's threefry normal (X1's ``z`` form: the CUDA kernel on the
card, its plain version on the CPU) in the threefry layout in force, and
scaled by 0.02 rounded to ``dtype`` as JAX's weak-typed product does.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels.threefry.kernel import zo_affine_threefry
from repro_torch.perturb.xla import in_dtype
from repro_torch.perturb.stream import Key

STUB_SCALE = 0.02


def stub_normal(key: Key, shape: tuple, dtype=torch.float32,
                device: DeviceSpec = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype) * 0.02``."""
    z = torch.empty(shape, dtype=dtype, device=resolve_device(device))
    zo_affine_threefry(None, key, "z", out=z)
    return z * torch.tensor(in_dtype(STUB_SCALE, dtype), dtype=dtype,
                            device=z.device)


def vision_stub_embeddings(key: Key, batch: int, seq: int, d_model: int,
                           dtype=torch.float32,
                           device: DeviceSpec = None) -> torch.Tensor:
    """Phi-3-vision: a CLIP-L/14 tower and projector would map image crops
    to patch embeddings spliced into the token stream; the stub emits the
    merged post-projector sequence (B, S, d)."""
    return stub_normal(key, (batch, seq, d_model), dtype, device)


def audio_stub_embeddings(key: Key, batch: int, frames: int, d_model: int,
                          dtype=torch.float32,
                          device: DeviceSpec = None) -> torch.Tensor:
    """Whisper: two conv1d layers over 128-bin log-mel spectrograms give
    frame embeddings at 50 Hz; the stub emits the post-conv frames
    (B, S_enc, d)."""
    return stub_normal(key, (batch, frames, d_model), dtype, device)
