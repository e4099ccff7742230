"""``wkv6`` on the model's (B, S, H, hd) tensors — the port of
``repro.kernels.rwkv6.ops``.

On the card K11 reads the model's layout through its strides (no folding
transposes) and writes y in it; on the CPU ``wkv6_plain`` folds the inputs
to (B·H, S, hd) for the plain version, as JAX's wrapper folds them."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import kernel as _k


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
               chunk: int = 16):
    """The plain K11 on the model's layout (any device), f32."""
    B, S, H, hd = r.shape

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, hd).to(torch.float32)

    u_b = u[None].expand(B, H, hd).reshape(B * H, 1, hd).to(torch.float32)
    y, s_final = _k.wkv6_chunked_plain(
        fold(r), fold(k), fold(v), fold(lw), u_b,
        s0.reshape(B * H, hd, hd).to(torch.float32), chunk=chunk)
    return (y.reshape(B, H, S, hd).transpose(1, 2),
            s_final.reshape(B, H, hd, hd))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor, *, chunk: int = 16):
    """r/k/v/lw (B,S,H,hd); u (H,hd); s0 (B,H,hd,hd)
    -> (y (B,S,H,hd), s_final (B,H,hd,hd)), f32."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, lw, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise RuntimeError(f"wkv6: no kernel for device {r.device}")
    f32 = torch.float32
    u = u.to(f32)
    return _k.launch(*(t.to(f32) for t in (r, k, v, lw)), u, (0, u.stride(0)),
                     s0.to(f32).contiguous(), chunk)
