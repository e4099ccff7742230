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

bf16 runs on the tensor cores (``mma.sync`` tiles fed by 16-byte
``cp.async`` copies), so its q, k and v must lie on 16-byte-aligned bases
with (b, s, h) strides that are multiples of 8 elements; the wrapper raises
otherwise.  f32 runs the scalar kernel and takes any strides.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the device function each dtype launches (``_build.route_counts``)
_ROUTES = {torch.float32: "f32_scalar", torch.bfloat16: "bf16_mma"}
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
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or ks != v.shape or ks[:2] != qs[:2] or ks[3] != qs[3] \
            or qs[2] % ks[2]:
        raise ValueError(f"flash_attention: q {tuple(qs)} with k "
                         f"{tuple(ks)} / v {tuple(v.shape)} is not "
                         "(B,S,H,hd) against (B,S,KV,hd) with KV | H")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {dev}")
    B, S, H, hd = qs
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16 q/k/v of one dtype, got {dt}/"
                        f"{k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS:
        raise NotImplementedError(f"flash_attention: head_dim {hd} (the "
                                  f"kernel is built for {_HEAD_DIMS})")
    qst, kst, vst = q.stride(), k.stride(), v.stride()
    if qst[3] != 1 or kst[3] != 1 or vst[3] != 1:
        raise ValueError("flash_attention: head_dim must be the unit-stride "
                         "axis")
    if dt == torch.bfloat16 and not (aligned16(q) and aligned16(k)
                                     and aligned16(v)):
        raise ValueError("flash_attention: the bf16 kernel needs 16-byte-"
                         "aligned q/k/v with (b, s, h) strides that are "
                         "multiples of 8 elements")
    o = torch.empty(qs, dtype=dt, device=dev)
    lib = _lib()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[dt],
        B, S, H, ks[2], hd, qst[0], qst[1], qst[2], kst[0], kst[1], kst[2],
        vst[0], vst[1], vst[2], hd ** -0.5, int(bool(causal)), int(window),
        _build.stream_of(q))
    _build.check(lib, err, "flash_attention")
    _build.count("flash_attention", _ROUTES[dt])
    return o


def attended_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """Unmasked (q, k) pairs of one (batch, head): the work K2 must do."""
    total = 0
    for qi in range(S):
        lo = max(0, qi - window + 1) if window > 0 else 0
        hi = qi if causal else S - 1
        total += max(0, hi - lo + 1)
    return total
