"""K12 ``paged_gather`` — block-table KV assembly for the paged serving
engine; the port of ``repro.kernels.paged.gather``.

    out[l, i·block:(i+1)·block, :] = x[l, table[i]·block : …, :]

``x`` is a pool tensor ``(L, NT, D)`` (``D = KV·hd`` folded), ``table`` the
``(n,)`` block ids.  A pure copy: the CUDA kernel (``csrc/paged_gather.cu``)
is bitwise-equal to the plain gather.  Block tables are host data (the
engine builds them from its refcounted pool), so the wrapper takes the table
on the host, checks every id against the pool, and ships it with the launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build


def _host_table(table, n_blocks: int) -> torch.Tensor:
    tab = torch.as_tensor(np.asarray(table, np.int32).reshape(-1))
    if tab.numel() and (int(tab.min()) < 0 or int(tab.max()) >= n_blocks):
        raise IndexError(f"paged_gather: block id outside [0, {n_blocks})")
    return tab


def paged_gather_plain(x: torch.Tensor, table: torch.Tensor,
                       block: int) -> torch.Tensor:
    """One advanced-indexing take over expanded token rows (any device)."""
    rows = (table.to(torch.int64)[:, None] * block
            + torch.arange(block, device=table.device)[None, :]).reshape(-1)
    return x[:, rows.to(x.device)]


def _lib():
    lib = _build.load("paged_gather")
    if not getattr(lib, "_typed", False):
        lib.paged_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_void_p]
        lib.paged_gather.restype = ctypes.c_int
        lib._typed = True
    return lib


def paged_gather(x: torch.Tensor, table, block: int) -> torch.Tensor:
    """Gather block rows of ``x (L, NT, D)`` by the host ``table (n,)``;
    returns ``(L, n·block, D)``.  CPU tensors take the plain version, CUDA
    tensors launch K12."""
    if x.dim() != 3 or x.shape[1] % block:
        raise ValueError(f"paged_gather: x must be (L, n_blocks*{block}, D), "
                         f"got {tuple(x.shape)}")
    L, NT, D = x.shape
    tab = _host_table(table, NT // block)
    if x.device.type == "cpu":
        return paged_gather_plain(x, tab, block)
    if x.device.type != "cuda":
        raise RuntimeError(f"paged_gather: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("paged_gather: the CUDA kernel takes a contiguous pool")
    n = int(tab.numel())
    out = torch.empty((L, n * block, D), dtype=x.dtype, device=x.device)
    if n == 0 or L == 0:
        return out
    dtab = tab.to(x.device, non_blocking=True)
    lib = _lib()
    err = lib.paged_gather(_build.ptr(x), _build.ptr(dtab), _build.ptr(out),
                           L, NT, n, block, D * x.element_size(),
                           _build.stream_of(x))
    _build.check(lib, err, "paged_gather")
    _build.count("paged_gather")
    return out
