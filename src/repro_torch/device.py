"""Device resolution for the port's entry points.

The port's work is on the card: an entry point given ``device=None`` runs on
CUDA and raises when no card is present.  It never falls back to the CPU on
its own — the CPU is used only when the caller names it (the CPU tests pass
``device="cpu"``)."""
from __future__ import annotations

from typing import Union

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
