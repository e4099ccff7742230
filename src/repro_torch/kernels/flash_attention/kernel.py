"""K2 ``flash_attention`` — causal / sliding-window GQA forward attention;
the port of ``repro.kernels.flash_attention`` (``kernel.py`` + ``ops.py`` +
``ref.py``).

The wrapper takes the model layout ``q (B,S,H,hd)``, ``k/v (B,S,KV,hd)``
and returns ``(B,S,H,hd)`` in q's dtype, like ``ops.flash_attention``.  A CPU
tensor takes the plain version (dense masked softmax in f32, the
``attention_ref`` semantics); a CUDA tensor launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises.  The two agree within rounding: the
kernel sums in another order (online softmax), so the tests state a
tolerance, not bitwise equality.

Like JAX's kernel, the wrapper takes f32, bf16 and f16 at any head dim and
any strides.  ``plan`` decides, from shapes, strides and addresses alone,
which device function runs and whether the inputs are copied first:

* bf16 / f16 with hd <= 256 run on the tensor cores (``mma.sync`` tiles fed
  by 16-byte ``cp.async`` copies), at the next instance of 16, 32, 64, 96,
  128, 192, 256 at or above hd.  That needs 16-byte-aligned q, k and v
  with (b, s, h) strides that are multiples of 8 elements, unit stride on
  hd and hd a multiple of 8; inputs that are not so are copied into fresh
  contiguous tensors (zero-padded to a multiple of 8 columns) and run the
  same kernel, counted under the route's ``+copy`` name;
* f32 at any hd, and bf16 / f16 past 256, run the scalar kernel, which walks
  hd in slices; only a non-unit hd stride is copied first.

Each launch is counted under its route and once more under its head dim
(``flash_attention/hd128``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.analysis import costs
from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
#: the largest head dim of the mma.sync kernel's instances (16, 32, 64, 96,
#: 128, 192, 256: ``dispatch_mma`` in the .cu)
MMA_MAX_HEAD_DIM = 256
_MMA, _SCALAR = 0, 1


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Dense masked softmax attention in f32 (any device)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.to(torch.float32).reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32)) * (hd ** -0.5)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s rows can be copied as 16-byte chunks: a 16-byte-
    aligned base and the stride of every longer-than-one axis but the last
    a multiple of 16 bytes."""
    if t.data_ptr() % 16:
        return False
    es = t.element_size()
    for st, n in zip(t.stride()[:-1], t.shape[:-1]):
        if n > 1 and (st * es) % 16:
            return False
    return True


class Plan(NamedTuple):
    """How one call runs on the card: the device function (``kernel``:
    "mma" or "scalar"; the .cu picks its instance from the head dim),
    whether q, k and v are copied first and to how many columns
    (``pad_to``, the head dim the kernel reads), and the route name its
    launch is counted under."""
    kernel: str
    copy: bool
    pad_to: int
    route: str


def _unit_hd(t: torch.Tensor) -> bool:
    return t.shape[3] == 1 or t.stride(3) == 1


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The route of a call with these q, k, v (one dtype of ``_DTYPES``)."""
    hd, dt = q.shape[3], q.dtype
    unit = all(_unit_hd(t) for t in (q, k, v))
    if dt == torch.float32 or hd > MMA_MAX_HEAD_DIM:
        route = f"{_NAMES[dt]}_scalar" + ("" if unit else "+copy")
        return Plan("scalar", not unit, hd, route)
    fits = unit and hd % 8 == 0 and all(aligned16(t) for t in (q, k, v))
    route = f"{_NAMES[dt]}_mma" + ("" if fits else "+copy")
    return Plan("mma", not fits, -(-hd // 8) * 8, route)


def _copied(t: torch.Tensor, pad_to: int) -> torch.Tensor:
    """A fresh contiguous copy of ``t`` (so 16-byte aligned), its last axis
    zero-padded to ``pad_to`` columns."""
    hd = t.shape[3]
    if pad_to > hd:
        return torch.nn.functional.pad(t, (0, pad_to - hd))
    return t.clone(memory_format=torch.contiguous_format)


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        lib._typed = True
    return lib


def _local_heads(q, k, v, causal: bool, window: int):
    """K2 on the rank's heads of DTensor q, k, v (tensor parallelism):
    each rank launches on its local tensors — K2 on the card, the plain
    version on the CPU — and the result takes q's placements.  Attention
    is separable by head and by batch row, so this holds where the three
    are placed alike on one mesh, on the batch (dim 0) or the head dim
    (2) only, and each rank's q heads are the groups of its KV heads
    (H_local / KV_local = H / KV, q's first head g times k's)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def refuse(why: str):
        raise ValueError(
            "flash_attention on DTensors launches on each rank's heads; "
            f"{why} (q {tuple(q.shape)} {getattr(q, 'placements', None)}, "
            f"k {tuple(k.shape)} {getattr(k, 'placements', None)}, "
            f"v {getattr(v, 'placements', None)})")

    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        refuse("q, k and v must all be DTensors")
    mesh = q.device_mesh
    if k.device_mesh != mesh or v.device_mesh != mesh:
        refuse("q, k and v lie on different meshes")
    if not (tuple(q.placements) == tuple(k.placements)
            == tuple(v.placements)):
        refuse("q, k and v are placed differently")
    if any(not (p.is_replicate() or (p.is_shard() and p.dim in (0, 2)))
           for p in q.placements):
        refuse("only the batch and head dims may be sharded, and nothing "
               "may be a partial sum")
    ql, qo = compute_local_shape_and_global_offset(q.shape, mesh,
                                                   q.placements)
    kl, ko = compute_local_shape_and_global_offset(k.shape, mesh,
                                                   k.placements)
    g = q.shape[2] // k.shape[2]
    if ql[2] != g * kl[2] or qo[2] != g * ko[2] or ql[0] != kl[0] \
            or qo[0] != ko[0]:
        refuse(f"a rank's q heads are not the groups of its KV heads "
               f"(q heads {qo[2]}+{ql[2]}, KV heads {ko[2]}+{kl[2]}, "
               f"group {g})")
    o = _attend(q.to_local(), k.to_local(), v.to_local(), causal, window,
                ("local_heads",))
    return DTensor.from_local(o, mesh, q.placements, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H,hd).  Forward only, on
    every device: JAX's Pallas kernel has no backward either, so
    ``attention_impl="pallas_flash"`` refuses autograd in both packages.
    Live DTensors (tensor parallelism) launch on each rank's heads
    (``_local_heads``), or raise naming their placements; a DTensor's
    pointer never reaches the kernel."""
    if any(_build.live_dtensor(t) for t in (q, k, v)):
        return _local_heads(q, k, v, causal, window)
    return _attend(q, k, v, causal, window, ())


def _attend(q, k, v, causal: bool, window: int, routes: tuple):
    """``flash_attention`` on plain (or ``meta``) tensors; a launch is
    counted under its route, its head dim and ``routes``."""
    _build.refuse_autograd(
        "flash_attention (K2, attention_impl='pallas_flash')", (q, k, v),
        "attention_impl='xla' or 'chunked', which differentiate in both "
        "packages")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or ks != v.shape or ks[:2] != qs[:2] or ks[3] != qs[3] \
            or qs[2] % ks[2]:
        raise ValueError(f"flash_attention: q {tuple(qs)} with k "
                         f"{tuple(ks)} / v {tuple(v.shape)} is not "
                         "(B,S,H,hd) against (B,S,KV,hd) with KV | H")
    dev = q.device
    if costs.active():
        B, S, H, hd = _build.local(q).shape
        costs.charge("flash_attention", costs.flash_attention(
            B, S, H, _build.local(k).shape[2], hd, q.element_size(),
            causal, window))
    if _build.on_meta(q):
        return torch.empty_like(q)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {dev}")
    B, S, H, hd = qs
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash_attention: the kernel takes float32, "
                        f"bfloat16 or float16 q/k/v of one dtype, got {dt}/"
                        f"{k.dtype}/{v.dtype}")
    o = torch.empty(qs, dtype=dt, device=dev)
    if q.numel() == 0:
        return o
    p = plan(q, k, v)
    if p.copy:
        q, k, v = (_copied(t, p.pad_to) for t in (q, k, v))
    qst, kst, vst = q.stride(), k.stride(), v.stride()
    lib = _lib()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[dt],
        _MMA if p.kernel == "mma" else _SCALAR, B, S, H, ks[2], p.pad_to, hd,
        qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1],
        vst[2], hd ** -0.5, int(bool(causal)), int(window),
        _build.stream_of(q))
    _build.check(lib, err, "flash_attention")
    _build.count("flash_attention", p.route, f"hd{hd}", *routes)
    return o
