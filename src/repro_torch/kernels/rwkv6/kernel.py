"""K11 ``wkv6_chunked`` — the chunked WKV6 recurrence (RWKV-6 "Finch"); the
port of ``repro.kernels.rwkv6.kernel``.

Per (b·h), with chunks of C tokens and lc the inclusive cumsum of the log
decays within a chunk: the strict-past term (r̃ k̃ᵀ masked) v with r̃ =
r·e^{max(lc−lw, −50)}, k̃ = k·e^{min(−lc, 50)}, the bonus (Σ r·u·k) v, the
carried state r̃ S, and S ← e^{lc_last}ᵀ ⊙ S + k̂ᵀ v with k̂ =
k·e^{max(lc_last−lc, −50)}.  The exponents stay within f32 for C ≤ 16 under
the model's [−8, 1] logit clamp (≤ 43.5), so C ≤ 16 is the envelope.

``wkv6_chunked`` takes JAX's kernel layout, r/k/v/lw (BH, S, hd), u
(BH, 1, hd), s0 (BH, hd, hd), and returns (y (BH, S, hd), s_final (BH, hd,
hd)), both f32.  A CPU tensor takes ``wkv6_chunked_plain``, a transcription
of ``_wkv_kernel``'s per-chunk arithmetic with a sequential loop over
chunks; a CUDA tensor launches ``csrc/wkv6.cu`` or raises.  The two agree
within rounding (the kernel sums in its own order), not bit for bit.
``launch`` is the kernel's entry for the model's (B, S, H, hd) layout,
read through strides (``ops.wkv6``).  Like JAX's kernel it takes any head
dim (instances of 16 … 256 channels, the next one up zero-padded, and
slices of 256 past that; past about hd 1 800 the state slice no longer
fits a block's shared memory on an H100 and stays in global memory).  At hd
64 — rwkv6-3b's heads — a tiled kernel takes the launch instead,
one CTA per (b, h); ``plan`` names the route and the launch is counted
under it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

CLIP = 50.0
MAX_CHUNK = 16
#: the head dim of the tiled route (``tile::HD`` in csrc/wkv6.cu)
TILE_HD = 64


def wkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                       *, chunk: int = 16):
    """The chunked recurrence in plain torch (any device), f32."""
    BH, S, hd = r.shape
    if S % chunk:
        raise ValueError(f"wkv6_chunked: S={S} is not a multiple of chunk "
                         f"{chunk}")
    f32 = torch.float32
    r, k, v, lw = (t.to(f32) for t in (r, k, v, lw))
    uu = u.to(f32).reshape(BH, 1, hd)
    state = s0.to(f32)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, wc = (t[:, c0:c0 + chunk] for t in (r, k, v, lw))
        lc = torch.cumsum(wc, dim=1)                       # inclusive
        r_t = rc * torch.exp(torch.clamp_min(lc - wc, -CLIP))
        k_t = kc * torch.exp(torch.clamp_max(-lc, CLIP))
        A = torch.where(tri, r_t @ k_t.transpose(1, 2), 0.0)
        bonus = torch.sum(rc * uu * kc, dim=2, keepdim=True)
        ys.append(A @ vc + bonus * vc + r_t @ state)
        last = lc[:, -1:]                                  # (BH, 1, hd)
        k_hat = kc * torch.exp(torch.clamp_min(last - lc, -CLIP))
        state = (torch.exp(last).transpose(1, 2) * state
                 + k_hat.transpose(1, 2) @ vc)
    y = torch.cat(ys, dim=1) if ys else torch.zeros_like(r)
    return y, state


def _lib():
    lib = _build.load("wkv6")
    if not getattr(lib, "_typed", False):
        lib.wkv6_chunked.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 21
            + [ctypes.c_int, ctypes.c_void_p])
        lib.wkv6_chunked.restype = ctypes.c_int
        lib._typed = True
    return lib


def plan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor) -> str:
    """K11's route for (B, S, H, hd) inputs: ``tile`` (one CTA per (b, h))
    at hd 64 with every row of r, k, v, lw on 16 bytes, else ``scalar``
    (16 value columns per CTA, any head dim and layout)."""
    hd = r.shape[3]
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st % 4 == 0 for st in t.stride()[:3])
                  for t in (r, k, v, lw))
    return "tile" if hd == TILE_HD and aligned else "scalar"


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lw: torch.Tensor, u: torch.Tensor, u_strides: tuple,
           s0: torch.Tensor, chunk: int):
    """K11 on the card for r/k/v/lw (B, S, H, hd) at any (b, s, h) strides
    with unit stride on hd; ``u`` read at element strides ``u_strides =
    (per b, per h)``; s0 (B, H, hd, hd) with row-major hd × hd matrices.
    Returns y (B, S, H, hd) and s_final (B, H, hd, hd), f32 contiguous.
    The launch is counted under its route (``plan``).  Forward only: its
    outputs carry no ``grad_fn``; ``ops.wkv6`` wraps it in an autograd
    Function whose backward differentiates the plain chunk form."""
    ts = (r, k, v, lw, u, s0)
    B, S, H, hd = r.shape
    if any(t.device.type != "cuda" or t.device != r.device for t in ts):
        raise RuntimeError("wkv6_chunked: every input must be on one CUDA "
                           "device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("wkv6_chunked: the kernel takes float32 inputs, got "
                        + "/".join(str(t.dtype) for t in ts))
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"wkv6_chunked: chunk {chunk} must be in [1, "
                         f"{MAX_CHUNK}] (the f32 envelope) and divide S={S}")
    if any(t.shape != r.shape for t in (k, v, lw)) or \
            s0.shape != (B, H, hd, hd):
        raise ValueError(f"wkv6_chunked: r/k/v/lw {tuple(r.shape)} / s0 "
                         f"{tuple(s0.shape)} are not (B,S,H,hd) / (B,H,hd,hd)")
    if any(t.stride(3) != 1 for t in (r, k, v, lw)) or u.stride(-1) != 1 \
            or s0.stride(3) != 1 or s0.stride(2) != hd:
        raise ValueError("wkv6_chunked: hd must be the unit-stride axis and "
                         "s0's hd x hd matrices row-major")
    route = plan(r, k, v, lw)
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    lib = _lib()
    strides = [st for t in (r, k, v, lw, y) for st in
               (t.stride(0), t.stride(1), t.stride(2))]
    err = lib.wkv6_chunked(
        _build.ptr(r), _build.ptr(k), _build.ptr(v), _build.ptr(lw),
        _build.ptr(u), _build.ptr(s0), _build.ptr(y), _build.ptr(s_out),
        B, H, S, hd, chunk, *strides, int(u_strides[0]), int(u_strides[1]),
        s0.stride(0), s0.stride(1), s_out.stride(0), s_out.stride(1),
        int(route == "tile"), _build.stream_of(r))
    _build.check(lib, err, "wkv6_chunked")
    _build.count("wkv6_chunked", route)
    return y, s_out


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                 chunk: int = 16):
    """r/k/v/lw (BH, S, hd) f32, u (BH, 1, hd), s0 (BH, hd, hd)
    -> (y (BH, S, hd), s_final (BH, hd, hd))."""
    if r.dim() != 3 or u.shape != (r.shape[0], 1, r.shape[2]):
        raise ValueError(f"wkv6_chunked: r {tuple(r.shape)} / u "
                         f"{tuple(u.shape)} are not (BH,S,hd) / (BH,1,hd)")
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, lw, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise RuntimeError(f"wkv6_chunked: no kernel for device {r.device}")
    from repro_torch.kernels.rwkv6.ops import ChunkedWKV
    return ChunkedWKV.apply(functools.partial(_launch_folded, chunk=chunk),
                            functools.partial(wkv6_chunked_plain,
                                              chunk=chunk),
                            r, k, v, lw, u, s0)


def _launch_folded(r, k, v, lw, u, s0, *, chunk: int):
    """K11 on JAX's (BH, S, hd) layout, as (B = BH, S, H = 1, hd)."""
    y, s_out = launch(r[:, :, None], k[:, :, None], v[:, :, None],
                      lw[:, :, None], u, (u.stride(0), 0), s0[:, None], chunk)
    return y[:, :, 0], s_out[:, 0]
