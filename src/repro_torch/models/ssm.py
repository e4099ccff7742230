"""Selective SSM heads (Hymba's parallel-mamba side) in the SSD chunked
form — the port of ``repro.models.ssm``.

Recurrence per head (a scalar decay per head, mamba-2 style):

    h_t = exp(−Δ_t·a) · h_{t−1} + Δ_t · (x_t ⊗ B_t)        h ∈ R^{hd×N}
    y_t = h_t · C_t + D ⊙ x_t

``ssm_scan``'s ``chunk`` mode evaluates it in chunks of C tokens with
einsums (the matmul form):

  within-chunk:  M[t,s] = exp(lc_t − lc_s)·Δ_s·(C_t·B_s)  (s ≤ t);  y = M@x
  carry-in:      y_t   += exp(lc_t) · C_t @ h_inᵀ
  chunk state:   h_out  = exp(lc_C)·h_in + Σ_s exp(lc_C − lc_s)·Δ_s·(x_s⊗B_s)

JAX carries the chunk states across chunks with a log-depth
``associative_scan``; here a loop over the ``nc`` chunk states does it, so
the f32 results differ from JAX's in low bits (a tolerance, not bitwise).
``fused_recurrent`` is the exact per-token recurrence (``ssm_scan_ref``),
and a single token (S == 1) is one recurrence step in either mode
(``ssm_decode_step``).  Everything after the input projections is f32; the
output is cast to the model dtype before ``out_proj``.  No Pallas kernel
is involved: the JAX module has none.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, reshape, shard_hint

SCAN_MODES = ("chunk", "fused_recurrent")


def ssm_params(cfg, gen: torch.Generator, dtype, layers: int) -> dict:
    """SSM leaves stacked over ``layers`` on axis 0 (N(0, 1/fan_in)
    projections, ``a_log`` zeros so a = 1, ``d_skip`` ones)."""
    d = cfg.d_model
    SH, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
    inner = SH * hd
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (layers, d, 2 * inner), dtype, fan_in=d),
        "dt_proj": dense_init(gen, (layers, d, SH), dtype, fan_in=d),
        "b_proj": dense_init(gen, (layers, d, SH * N), dtype, fan_in=d),
        "c_proj": dense_init(gen, (layers, d, SH * N), dtype, fan_in=d),
        "a_log": torch.zeros((layers, SH), dtype=dtype, device=dev),
        "d_skip": torch.ones((layers, SH, hd), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (layers, inner, d), dtype, fan_in=inner),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(cfg, p: dict, u: torch.Tensor):
    """The shared input projections of u (B,S,d): x (B,S,SH,hd), the gate z
    (model dtype), dt (B,S,SH), B and C (B,S,SH,N), a (SH,) — all f32 but
    z."""
    B, S, _ = u.shape
    SH, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
    xz = u @ p["in_proj"]
    x, z = xz.split(SH * hd, dim=-1)
    x = reshape(x, B, S, SH, hd).to(torch.float32)
    dt = _softplus((u @ p["dt_proj"]).to(torch.float32))
    bmat = reshape(u @ p["b_proj"], B, S, SH, N).to(torch.float32)
    cmat = reshape(u @ p["c_proj"], B, S, SH, N).to(torch.float32)
    a = torch.exp(p["a_log"].to(torch.float32))
    return x, z, dt, bmat, cmat, a


def _finish(cfg, p: dict, u: torch.Tensor, y, x, z) -> torch.Tensor:
    B, S = u.shape[:2]
    y = y + p["d_skip"].to(torch.float32)[None, None] * x
    y = (reshape(y, B, S, cfg.ssm_heads * cfg.hd)
         * F.silu(z.to(torch.float32))).to(u.dtype)
    return y @ p["out_proj"]


def _zero_state(cfg, B: int, device) -> torch.Tensor:
    return torch.zeros((B, cfg.ssm_heads, cfg.hd, cfg.ssm_state),
                       dtype=torch.float32, device=device)


def ssm_scan(cfg, p: dict, u: torch.Tensor,
             state: Optional[torch.Tensor] = None, chunk: int = 0,
             mode: Optional[str] = None):
    """u (B,S,d) -> (y (B,S,d), final state (B,SH,hd,N) f32).  ``mode``
    (default ``cfg.scan_mode``) is ``chunk`` (the SSD form) or
    ``fused_recurrent`` (``ssm_scan_ref``)."""
    B, S, _ = u.shape
    SH, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
    chunk = chunk or cfg.scan_chunk
    mode = mode or cfg.scan_mode
    if mode not in SCAN_MODES:
        raise ValueError(f"unknown scan mode {mode!r}; available: {SCAN_MODES}")
    if S == 1:
        if state is None:
            state = _zero_state(cfg, B, u.device)
        return ssm_decode_step(cfg, p, u, state)
    if mode == "fused_recurrent":
        return ssm_scan_ref(cfg, p, u, state)
    x, z, dt, bmat, cmat, a = _project(cfg, p, u)
    if state is None:
        state = _zero_state(cfg, B, u.device)

    C = min(chunk, S)
    S_real = S
    if S % C:
        # pad to a chunk multiple with identity tokens: dt = 0 gives decay
        # 1 and drive 0, so the state passes through; their y rows are cut
        pad = C - S % C
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // C
    ldec = (-dt * a[None, None, :]).reshape(B, nc, C, SH)
    lc = torch.cumsum(ldec, dim=2)                       # inclusive in-chunk
    # chunk axis == sequence: 'model' under context parallelism
    xc = shard_hint(x.reshape(B, nc, C, SH, hd), "act_ssd")
    dtc = dt.reshape(B, nc, C, SH)
    bc = shard_hint(bmat.reshape(B, nc, C, SH, N), "act_ssd")
    cc = shard_hint(cmat.reshape(B, nc, C, SH, N), "act_ssd")

    # chunk-local states: Σ_s exp(lc_C − lc_s)·Δ_s·(x_s ⊗ B_s)
    wE = torch.exp(lc[:, :, -1:, :] - lc)
    b_hat = bc * (wE * dtc)[..., None]
    h_loc = torch.einsum("bnchd,bnchk->bnhdk", xc, b_hat)
    dec_chunk = torch.exp(lc[:, :, -1, :])               # (B,nc,SH)

    # the state entering each chunk, carried chunk by chunk
    h = state
    h_in = []
    for i in range(nc):
        h_in.append(h)
        h = dec_chunk[:, i, :, None, None] * h + h_loc[:, i]
    h_in = torch.stack(h_in, dim=1)                      # (B,nc,SH,hd,N)
    final_state = h

    # within-chunk matmul; the exponent is masked BEFORE exp (for s > t,
    # lc_t − lc_s is positive and exp could overflow to inf, and inf · 0
    # from a mask applied afterwards is NaN)
    ldiff = lc[:, :, :, None, :] - lc[:, :, None, :, :]  # (B,nc,t,s,SH)
    tri = torch.ones((C, C), dtype=torch.bool, device=u.device).tril()
    gate = torch.exp(torch.where(tri[None, None, :, :, None], ldiff,
                                 torch.tensor(float("-inf"),
                                              device=u.device)))
    scores = torch.einsum("bnthk,bnshk->bntsh", cc, bc)
    M = scores * gate * dtc[:, :, None, :, :]
    y = torch.einsum("bntsh,bnshd->bnthd", M, xc)

    # carry-in: exp(lc_t)·C_t @ h_inᵀ
    c_tilde = cc * torch.exp(lc)[..., None]
    y = y + torch.einsum("bnchk,bnhdk->bnchd", c_tilde, h_in)

    y = y.reshape(B, S, SH, hd)[:, :S_real]
    return _finish(cfg, p, u, y, x[:, :S_real], z), final_state


def ssm_scan_ref(cfg, p: dict, u: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """The exact per-token recurrence (``fused_recurrent``)."""
    B, S, _ = u.shape
    x, z, dt, bmat, cmat, a = _project(cfg, p, u)
    h = _zero_state(cfg, B, u.device) if state is None else state
    ys = []
    for t in range(S):
        decay = torch.exp(-dt[:, t] * a[None, :])[..., None, None]
        drive = (dt[:, t][..., None, None] * x[:, t][..., None]
                 * bmat[:, t][..., None, :])
        h = decay * h + drive
        ys.append(torch.einsum("bhdn,bhn->bhd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1)
    return _finish(cfg, p, u, y, x, z), h


def ssm_decode_step(cfg, p: dict, u: torch.Tensor, state: torch.Tensor):
    """u (B,1,d): one recurrence step from ``state``; (y, new state)."""
    x, z, dt, bmat, cmat, a = _project(cfg, p, u)
    decay = torch.exp(-dt[:, 0] * a[None, :])[..., None, None]
    drive = (dt[:, 0][..., None, None] * x[:, 0][..., None]
             * bmat[:, 0][..., None, :])
    h = decay * state + drive
    y = torch.einsum("bhdn,bhn->bhd", h, cmat[:, 0])[:, None]
    return _finish(cfg, p, u, y, x, z), h


def init_ssm_state(cfg, batch: int, layers: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """Stacked-over-layers SSM state, f32 zeros of (L, B, SH, hd, N)."""
    L = layers if layers is not None else cfg.n_layers
    return torch.zeros((L, batch, cfg.ssm_heads, cfg.hd, cfg.ssm_state),
                       dtype=torch.float32, device=device)
