"""Device resolution for the port's entry points.

The port's work is on the card: an entry point given ``device=None`` runs on
CUDA and raises when no card is present.  It never falls back to the CPU on
its own — the CPU is used only when the caller names it (the CPU tests pass
``device="cpu"``)."""
from __future__ import annotations

import contextlib
from typing import Union

import numpy as np
import torch

DeviceSpec = Union[None, str, torch.device]


def resolve_device(device: DeviceSpec = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run the plain torch versions on "
            "the CPU explicitly")
    return dev


#: the value every host read of a ``meta`` tensor answers while a dry run
#: traces (``placeholder_reads``)
PLACEHOLDER = np.float32(1.0)
_placeholders_open = False


@contextlib.contextmanager
def placeholder_reads():
    """While open, a host read of a ``meta`` tensor (or a DTensor on one) —
    which has no value — answers ``PLACEHOLDER``: a dry run traces the
    step's kernel calls and ops with every loss the same placeholder."""
    global _placeholders_open
    was_open, _placeholders_open = _placeholders_open, True
    try:
        yield
    finally:
        _placeholders_open = was_open


def _placeholder_for(x: torch.Tensor) -> bool:
    if x.device.type != "meta":
        return False
    if not _placeholders_open:
        raise RuntimeError("a meta tensor has no value to read on the host "
                           "outside a dry run (device.placeholder_reads)")
    return True


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A live DTensor's value as one plain tensor (a replicated loss: its
    local copy; a partial sum or a shard: reduced or gathered first)."""
    if hasattr(x, "placements"):
        return x.full_tensor()
    return x


def host_f32(x) -> np.float32:
    """A loss or scalar as a host f32 (one device sync for a tensor)."""
    if isinstance(x, torch.Tensor):
        if _placeholder_for(x):
            return PLACEHOLDER
        x = _whole(x.detach()).float().item()
    return np.float32(x)


def host_array(x: torch.Tensor, dtype=np.float32) -> np.ndarray:
    """A tensor's values as a host array of ``dtype`` (f32, or f64 for
    sums kept in f64; one device sync)."""
    if _placeholder_for(x):
        return np.full(tuple(x.shape), PLACEHOLDER, dtype)
    x = _whole(x.detach())
    x = x.double() if np.dtype(dtype) == np.float64 else x.float()
    return x.cpu().numpy()
