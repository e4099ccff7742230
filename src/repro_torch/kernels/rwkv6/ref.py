"""The exact per-token WKV6 recurrence — the port of
``repro.kernels.rwkv6.ref``: K11's oracle, and the core of the model's
``fused_recurrent`` scan mode."""
from __future__ import annotations

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r/k/v/lw (BH, S, hd), u (BH, 1, hd), s0 (BH, hd, hd)
    -> (y (BH, S, hd), s_final), both f32.  Per token t:

        y_t = r_t · (S + u ⊙ k_t v_tᵀ),   S ← exp(lw_t) ⊙ S + k_t v_tᵀ
    """
    f32 = torch.float32
    r, k, v = r.to(f32), k.to(f32), v.to(f32)
    w = torch.exp(lw.to(f32))
    uu = u[:, 0].to(f32)[..., :, None]                   # (BH, hd, 1)
    state = s0.to(f32)
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]         # (BH, hd, hd)
        ys.append(torch.einsum("bi,bij->bj", r[:, t], state + uu * kv))
        state = w[:, t, :, None] * state + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros_like(r))
    return y, state
