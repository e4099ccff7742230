"""Tensor checkpoint store — the port of ``repro.checkpoint.io``, in the same
file layout: an 8-byte little-endian index length, a msgpack index
(``{"leaves": [{path, dtype, shape, offset, nbytes}], "meta": {...}}``),
then the raw little-endian leaf buffers.  Leaves are stored unsharded with
their jax-style tree paths, so a params checkpoint written by either
package loads in the other; a ``DTensor`` leaf is stored whole (its
``full_tensor()``), so a tree placed on a mesh loads onto plain tensors.
Writes are atomic (tmp + rename).

The index is written with the package's own msgpack subset
(``msgpack_lite``, byte-identical to ``msgpack.packb`` for it): the machine
with the card has no ``msgpack``.  Leaves may be tensors (any device; they
come back on the device of the ``like`` leaf), numpy arrays or Python /
numpy scalars (optimizer state).
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.tree_utils import PyTree, flatten_with_path, tree_unflatten


def _to_numpy(x) -> tuple:
    if isinstance(x, torch.Tensor):
        if hasattr(x, "full_tensor"):
            # a DTensor: the whole leaf, gathered (JAX's device_get)
            x = x.full_tensor()
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _leaf_from(raw: bytes, dtype: str, shape, like):
    """One stored leaf, as the kind of leaf ``like`` is (a tensor on its
    device, a Python / numpy scalar, or a numpy array)."""
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).to(like.device)
    arr = np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    if isinstance(like, (bool, int, float, np.generic)):
        return type(like)(arr.item())
    return arr


def save_tree(path: str, tree: PyTree, extra_meta: dict | None = None) -> None:
    index = {"leaves": [], "meta": extra_meta or {}}
    blobs = []
    offset = 0
    for kp, leaf in flatten_with_path(tree):
        arr, dtype = _to_numpy(leaf)
        raw = arr.tobytes()
        index["leaves"].append({"path": kp, "dtype": dtype,
                                "shape": list(arr.shape), "offset": offset,
                                "nbytes": len(raw)})
        blobs.append(raw)
        offset += len(raw)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        head = msgpack_lite.packb(index)
        f.write(struct.pack("<q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


def load_tree(path: str, like: PyTree) -> tuple:
    """Restore into the structure of ``like`` (paths must match)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<q", f.read(8))
        index = msgpack_lite.unpackb(f.read(hlen))
        base = f.tell()
        by_path = {e["path"]: e for e in index["leaves"]}
        leaves = []
        for kp, leaf in flatten_with_path(like):
            e = by_path[kp]
            f.seek(base + e["offset"])
            leaves.append(_leaf_from(f.read(e["nbytes"]), e["dtype"],
                                     e["shape"], leaf))
    return tree_unflatten(like, leaves), index["meta"]


def load_meta(path: str) -> dict:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<q", f.read(8))
        return msgpack_lite.unpackb(f.read(hlen))["meta"]
