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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


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


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H,hd)."""
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)} is not "
                         "(B,S,H,hd) against (B,S,KV,hd) with KV | H")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    B, S, H, hd = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16 q/k/v of one dtype, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS:
        raise NotImplementedError(f"flash_attention: head_dim {hd} (the "
                                  f"kernel is built for {_HEAD_DIMS})")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be the unit-stride "
                         "axis")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    err = lib.flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
        _DTYPES[q.dtype], B, S, H, k.shape[2], hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        hd ** -0.5, int(bool(causal)), int(window), _build.stream_of(q))
    _build.check(lib, err, "flash_attention")
    _build.count("flash_attention")
    return o


def attended_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """Unmasked (q, k) pairs of one (batch, head): the work K2 must do."""
    total = 0
    for qi in range(S):
        lo = max(0, qi - window + 1) if window > 0 else 0
        hi = qi if causal else S - 1
        total += max(0, hi - lo + 1)
    return total
