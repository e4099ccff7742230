"""Learning-rate schedules — the port of ``repro.core.schedules``, as host
f32 scalars (numpy): each op is one separately rounded f32 operation in
JAX's order, so a recorded η is the η the step used."""
from __future__ import annotations

import numpy as np

f32 = np.float32


def lr_at(name: str, base_lr: float, step, total_steps: int = 0,
          warmup_steps: int = 0) -> np.float32:
    step = f32(step)
    lr = f32(base_lr)
    if name == "constant":
        out = lr
    elif name in ("linear", "cosine"):
        t = np.clip(step / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
        if name == "linear":
            out = lr * (f32(1.0) - t)
        else:
            out = f32(0.5) * lr * (f32(1.0) + np.cos(f32(np.pi) * t))
    else:
        raise ValueError(f"unknown lr schedule {name!r}")
    if warmup_steps > 0:
        warm = np.clip((step + f32(1.0)) / f32(warmup_steps), f32(0.0),
                       f32(1.0))
        out = out * warm
    return f32(out)


def n_spsa_at(name: str, base_n: int, step, total_steps: int = 0) -> int:
    """Sample-count schedule for n-SPSA (paper App. A.2)."""
    if name == "constant":
        return base_n
    if name == "linear":
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return max(1, int(round(base_n * frac)))
    raise ValueError(f"unknown n schedule {name!r}")
