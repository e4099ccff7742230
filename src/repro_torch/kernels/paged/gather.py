"""K12 ``paged_gather`` — block-table KV assembly for the paged serving
engine; the port of ``repro.kernels.paged.gather``.

    out[l, i·block:(i+1)·block, :] = x[l, table[i]·block : …, :]

``x`` is a pool tensor ``(L, NT, D)`` (``D = KV·hd`` folded), ``table`` the
``(n,)`` block ids.  A pure copy: the CUDA kernel (``csrc/paged_gather.cu``)
is bitwise-equal to the plain gather.  The table is host data (the engine
builds block tables from its refcounted pool) or, as JAX's kernel takes a
device array, an int32 tensor already on the pool's device.  A host table is
checked against the pool and uploaded through a reusable pinned staging
buffer, so the copy is truly asynchronous; ``upload_table`` does that once
for a caller that gathers several pools by one table.  A device table is
trusted as JAX trusts it: the kernel clamps each id into the pool, as JAX's
``dynamic_slice`` clamps its start.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import _build

#: CTAs per SM of K12's grid-stride launch
CTAS_PER_SM = 4


def _host_table(table, n_blocks: int) -> np.ndarray:
    tab = np.asarray(table, np.int32).reshape(-1)
    if tab.size and (int(tab.min()) < 0 or int(tab.max()) >= n_blocks):
        raise IndexError(f"paged_gather: block id outside [0, {n_blocks})")
    return tab


class _Staging:
    """A pinned host buffer and the event of the last copy that read it, so
    the buffer is rewritten only after that copy is done."""

    def __init__(self):
        self.buf = torch.empty(0, dtype=torch.int32)
        self.event = torch.cuda.Event()

    def upload(self, tab: np.ndarray, device: torch.device) -> torch.Tensor:
        n = tab.size
        self.event.synchronize()           # returns at once if never recorded
        if self.buf.numel() < n:
            self.buf = torch.empty(max(n, 2 * self.buf.numel()),
                                   dtype=torch.int32, pin_memory=True)
        host = self.buf[:n]
        host.numpy()[:] = tab
        dev = torch.empty(n, dtype=torch.int32, device=device)
        dev.copy_(host, non_blocking=True)
        self.event.record(torch.cuda.current_stream(device))
        return dev


_STAGING: Dict[torch.device, _Staging] = {}
_SMS: Dict[torch.device, int] = {}


def upload_table(table, n_blocks: int, device) -> torch.Tensor:
    """The host ``table`` checked against ``n_blocks`` and placed on
    ``device`` as int32: through the pinned staging buffer on a CUDA
    device, as is on the CPU."""
    tab = _host_table(table, n_blocks)
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(tab).to(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _STAGING.setdefault(device, _Staging()).upload(tab, device)


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
                                     ctypes.c_int, ctypes.c_void_p]
        lib.paged_gather.restype = ctypes.c_int
        lib._typed = True
    return lib


def _grid(device: torch.device) -> int:
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return CTAS_PER_SM * sms


def paged_gather(x: torch.Tensor, table, block: int) -> torch.Tensor:
    """Gather block rows of ``x (L, NT, D)`` by ``table (n,)`` — host ids
    (checked) or an int32 tensor on x's device; returns ``(L, n·block, D)``.
    CPU tensors take the plain version, CUDA tensors launch K12."""
    if x.dim() != 3 or x.shape[1] % block:
        raise ValueError(f"paged_gather: x must be (L, n_blocks*{block}, D), "
                         f"got {tuple(x.shape)}")
    L, NT, D = x.shape
    on_device = isinstance(table, torch.Tensor) and table.device.type != "cpu"
    if x.device.type == "cpu":
        if on_device:
            raise ValueError("paged_gather: a CPU pool takes a host table")
        return paged_gather_plain(
            x, torch.from_numpy(_host_table(table, NT // block)), block)
    if x.device.type != "cuda":
        raise RuntimeError(f"paged_gather: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("paged_gather: the CUDA kernel takes a contiguous pool")
    if on_device and (table.device != x.device or table.dtype != torch.int32
                      or table.dim() != 1):
        raise ValueError(f"paged_gather: a device table must be a 1-D int32 "
                         f"tensor on {x.device}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    tab = table if on_device else upload_table(table, NT // block, x.device)
    n = int(tab.numel())
    out = torch.empty((L, n * block, D), dtype=x.dtype, device=x.device)
    if n == 0 or L == 0:
        return out
    lib = _lib()
    err = lib.paged_gather(x.data_ptr(), tab.data_ptr(), out.data_ptr(),
                           L, NT, n, block, D * x.element_size(),
                           _grid(x.device), _build.stream_of(x))
    _build.check(lib, err, "paged_gather")
    _build.count("paged_gather")
    return out
