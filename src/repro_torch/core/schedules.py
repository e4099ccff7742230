"""Learning-rate schedules — the port of ``repro.core.schedules``, as host
f32 scalars (numpy): each op is one separately rounded f32 operation in
the order of JAX's jitted step, so a recorded η is the η the step used.

The step counts ``total_steps`` and ``warmup_steps`` are constants of the
jitted graph, and XLA rewrites a division by a constant into a product with
its f32 reciprocal (``t = step · f32(1/total)``); the port writes that
product, which differs from ``step / total`` in the last bit at some steps
(380 of the first 1 001 at ``total_steps`` 1 000).  XLA:CPU calls libm's
single-precision functions for ``jnp.cos`` and ``jnp.power``, and so does
the port (``libm_f32``): numpy's float32 ``cos`` and ``power`` round
otherwise."""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

f32 = np.float32


@functools.lru_cache(maxsize=None)
def libm_f32(name: str, n_args: int):
    """libm's single-precision function ``name`` (``cosf``, ``powf``) of
    ``n_args`` floats, returning a float."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_float] * n_args
    fn.restype = ctypes.c_float
    return fn


def cosf(x) -> np.float32:
    return f32(libm_f32("cosf", 1)(f32(x)))


def powf(x, y) -> np.float32:
    return f32(libm_f32("powf", 2)(f32(x), f32(y)))


def _reciprocal(n: int) -> np.float32:
    """XLA's constant 1/n, rounded to f32."""
    return f32(f32(1.0) / f32(n))


def lr_at(name: str, base_lr: float, step, total_steps: int = 0,
          warmup_steps: int = 0) -> np.float32:
    step = f32(step)
    lr = f32(base_lr)
    if name == "constant":
        out = lr
    elif name in ("linear", "cosine"):
        t = np.clip(step * _reciprocal(max(total_steps, 1)), f32(0.0),
                    f32(1.0))
        if name == "linear":
            out = lr * (f32(1.0) - t)
        else:
            out = f32(0.5) * lr * (f32(1.0) + cosf(f32(np.pi) * t))
    else:
        raise ValueError(f"unknown lr schedule {name!r}")
    if warmup_steps > 0:
        warm = np.clip((step + f32(1.0)) * _reciprocal(warmup_steps),
                       f32(0.0), f32(1.0))
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
