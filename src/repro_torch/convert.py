"""Parameter trees between the two frameworks, as numpy.

``params_from_jax`` takes a JAX parameter tree already turned into numpy
(``jax.tree.map(np.asarray, params)``) and returns the same nested dict of
torch tensors; ``params_to_jax`` goes back.  Values are copied bit for bit,
bfloat16 included (numpy holds it as ``ml_dtypes.bfloat16``, which torch
reads through a 16-bit integer view).  The port never imports JAX: this is
how parity tests give both sides the same weights.

A recurrent state crosses the same way: JAX's ``RWKVLayerState`` of numpy
arrays becomes the port's ``RWKVLayerState`` of tensors (named tuples are
matched by their fields), and ``params_to_jax`` returns the port's named
tuple of numpy arrays, which ``repro.models.rwkv6.RWKVLayerState(*t)``
takes back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ascontiguousarray makes a 0-d array 1-d: restore the shape
        bits = np.ascontiguousarray(a).view(np.int16).reshape(a.shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes           # numpy's bfloat16 (installed with JAX)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _named(fields: tuple):
    """The port's named tuple with these fields (the recurrent states)."""
    from repro_torch.models.rwkv6 import RWKVLayerState
    if fields == RWKVLayerState._fields:
        return RWKVLayerState
    raise TypeError(f"no port type for a named tuple with fields {fields}")


def params_from_jax(tree, device: DeviceSpec = "cpu"):
    """Nested dict/list/named tuple of numpy arrays -> the same structure
    of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return _named(tree._fields)(*(params_from_jax(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, dev) for v in tree)
    return _to_tensor(tree, dev)


def params_to_jax(tree):
    """Nested dict/list/named tuple of tensors -> the same structure of
    numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(params_to_jax(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_jax(v) for v in tree)
    return _to_numpy(tree)
