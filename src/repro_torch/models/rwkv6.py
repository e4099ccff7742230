"""RWKV6 "Finch" (arXiv:2404.05892), family ``ssm`` — the port of
``repro.models.rwkv6``.

Per layer: TimeMix (the WKV6 linear recurrence) + ChannelMix.  Per head,
key index i, value index j:

    S_t[i,j] = w_t[i] · S_{t−1}[i,j] + k_t[i] · v_t[j]
    y_t[j]   = Σ_i r_t[i] · (S_{t−1}[i,j] + u[i] · k_t[i] · v_t[j])

with the data-dependent decay w_t = exp(−exp(clip(w0 + lora_w(x_w), −8, 1))).
Two scan modes, as in JAX: ``"chunk"`` runs the chunked factorization
through ``kernels.rwkv6.ops.wkv6`` (K11 on the card), ``"fused_recurrent"``
the exact per-token recurrence (``kernels.rwkv6.ref.wkv6_ref``).  A
one-token step with a carried state is ``time_mix_decode`` in both modes.

Params keep the JAX layout, layer leaves stacked on axis 0, so the flatten
order (and every leaf's z seed) is JAX's.  The layer loop is Python; the
returned state is stacked over layers like JAX's scan output.  dtypes follow
JAX's promotion: r/k/v/decay are f32, the f32 y·g product meets the param-
dtype ``wo`` as an f32 product (TF32 is left off), and the block output is
cast back to the residual's dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models.common import dense_init, embed_init, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_views

LORA_R = 64
SCAN_MODES = ("chunk", "fused_recurrent")


class RWKVLayerState(NamedTuple):
    shift_tm: torch.Tensor    # (B, d) last token for TimeMix token-shift
    shift_cm: torch.Tensor    # (B, d) last token for ChannelMix token-shift
    wkv: torch.Tensor         # (B, H, hd, hd) recurrence state (f32)


def rwkv_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                      layers: int) -> dict:
    """One layer's leaves, stacked over ``layers`` on axis 0."""
    d, H, hd, L = cfg.d_model, cfg.n_heads, cfg.hd, layers
    inner = H * hd
    dev = gen.device

    def full(shape, value):
        return torch.full((L, *shape), value, dtype=dtype, device=dev)

    def proj(d_in, d_out):
        return dense_init(gen, (L, d_in, d_out), dtype, fan_in=d_in)

    return {
        "tm": {
            "norm_scale": full((d,), 0.0),
            "mu_r": full((d,), 0.5),
            "mu_k": full((d,), 0.5),
            "mu_v": full((d,), 0.5),
            "mu_g": full((d,), 0.5),
            "mu_w": full((d,), 0.5),
            "wr": proj(d, inner),
            "wk": proj(d, inner),
            "wv": proj(d, inner),
            "wg": proj(d, inner),
            "wo": proj(inner, d),
            "w0": full((H, hd), -1.0),             # base decay logit
            "w_lora_a": proj(d, LORA_R),
            "w_lora_b": full((LORA_R, inner), 0.0),
            "u": full((H, hd), 0.0),               # first-token bonus
            "ln_out_scale": full((inner,), 0.0),
        },
        "cm": {
            "norm_scale": full((d,), 0.0),
            "mu_k": full((d,), 0.5),
            "mu_r": full((d,), 0.5),
            "wk": proj(d, cfg.d_ff),
            "wv": proj(cfg.d_ff, d),
            "wr": proj(d, d),
        },
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """xx_t = x_{t-1}; position 0 takes ``last`` (carried state) or zeros."""
    B, S, d = x.shape
    first = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
             if last is None else last[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1, :]], dim=1)


def _tm_projections(cfg: ModelConfig, p: dict, x: torch.Tensor, state):
    """Shared TimeMix input path: token shift, lerps, projections, decay."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    xn = rmsnorm(x, p["norm_scale"])
    xx = _token_shift(xn, state.shift_tm if state is not None else None)

    def lerp(mu):
        return xn + (xx - xn) * mu.to(xn.dtype)

    r = (lerp(p["mu_r"]) @ p["wr"]).reshape(B, S, H, hd).to(f32)
    k = (lerp(p["mu_k"]) @ p["wk"]).reshape(B, S, H, hd).to(f32)
    v = (lerp(p["mu_v"]) @ p["wv"]).reshape(B, S, H, hd).to(f32)
    g = F.silu(lerp(p["mu_g"]) @ p["wg"])                          # (B,S,H*hd)
    w_logit = (lerp(p["mu_w"]) @ p["w_lora_a"]) @ p["w_lora_b"]
    w_logit = w_logit.reshape(B, S, H, hd) + p["w0"].to(w_logit.dtype)
    # log decay −exp(logit) < 0, logit clamped to [−8, 1]: the chunked
    # factorization's exponents stay ≤ 43.5 at C ≤ 16
    logw = -torch.exp(torch.clamp(w_logit.to(f32), -8.0, 1.0))
    u = p["u"].to(f32)
    wkv0 = (state.wkv if state is not None
            else torch.zeros((B, H, hd, hd), dtype=f32, device=x.device))
    return xn, r, k, v, g, logw, u, wkv0


def _tm_output(cfg: ModelConfig, p: dict, x, xn, y, g):
    B, S = x.shape[:2]
    y = y.reshape(B, S, cfg.n_heads * cfg.hd)
    y = rmsnorm(y, p["ln_out_scale"])                              # f32
    out = (y * g.to(y.dtype)) @ p["wo"].to(y.dtype)                # JAX: f32
    return out.to(x.dtype), xn[:, -1, :]


def _resolve_mode(cfg: ModelConfig, mode: Optional[str]) -> str:
    """``mode=None`` falls back to ``cfg.scan_mode``; unknown modes refuse."""
    m = mode or cfg.scan_mode
    if m not in SCAN_MODES:
        raise ValueError(f"unknown scan mode {m!r}; available: {SCAN_MODES}")
    return m


def time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
             state: Optional[RWKVLayerState], mode: Optional[str] = None):
    """WKV6 in chunked form: K11 (``ops.wkv6``) with C = min(scan_chunk, S),
    the sequence padded to a multiple of C with identity tokens (log w = 0,
    r = k = v = 0: the state passes through), padded rows sliced off."""
    B, S, _ = x.shape
    if S == 1 and state is not None:
        return time_mix_decode(cfg, p, x, state)   # one step: modes coincide
    if _resolve_mode(cfg, mode) == "fused_recurrent":
        return time_mix_ref(cfg, p, x, state)
    xn, r, k, v, g, logw, u, wkv0 = _tm_projections(cfg, p, x, state)
    C = min(cfg.scan_chunk, S)
    if S % C:
        pad = (0, 0, 0, 0, 0, C - S % C)
        r, k, v, logw = (F.pad(t, pad) for t in (r, k, v, logw))
    y, wkv_final = wkv_ops.wkv6(r, k, v, logw, u, wkv0, chunk=C)
    out, shift = _tm_output(cfg, p, x, xn, y[:, :S], g)
    return out, (shift, wkv_final)


def time_mix_ref(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 state: Optional[RWKVLayerState]):
    """The exact per-token recurrence (``wkv6_ref``) — the oracle."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    xn, r, k, v, g, logw, u, wkv0 = _tm_projections(cfg, p, x, state)

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, hd)

    y, wkv_final = wkv6_ref(fold(r), fold(k), fold(v), fold(logw),
                            u[None].expand(B, H, hd).reshape(B * H, 1, hd),
                            wkv0.reshape(B * H, hd, hd))
    y = y.reshape(B, H, S, hd).transpose(1, 2)
    out, shift = _tm_output(cfg, p, x, xn, y, g)
    return out, (shift, wkv_final.reshape(B, H, hd, hd))


def time_mix_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    state: RWKVLayerState):
    """Single-token step: one rank-1 state update (O(1) per token)."""
    xn, r, k, v, g, logw, u, wkv0 = _tm_projections(cfg, p, x, state)
    r1, k1, v1 = r[:, 0], k[:, 0], v[:, 0]
    w1 = torch.exp(logw[:, 0])
    kv = k1[..., :, None] * v1[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", r1, wkv0 + u[None, :, :, None] * kv)
    wkv_new = w1[..., :, None] * wkv0 + kv
    out, shift = _tm_output(cfg, p, x, xn, y[:, None], g)
    return out, (shift, wkv_new)


def channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                state: Optional[RWKVLayerState]):
    xn = rmsnorm(x, p["norm_scale"])
    xx = _token_shift(xn, state.shift_cm if state is not None else None)
    xk = xn + (xx - xn) * p["mu_k"].to(xn.dtype)
    xr = xn + (xx - xn) * p["mu_r"].to(xn.dtype)
    k = F.relu(xk @ p["wk"])
    kv = (k * k) @ p["wv"]                                         # relu²
    out = torch.sigmoid(xr @ p["wr"]) * kv
    return out.to(x.dtype), xn[:, -1, :]


def rwkv_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
               state: Optional[RWKVLayerState] = None,
               mode: Optional[str] = None):
    tm_out, (shift_tm, wkv) = time_mix(cfg, p["tm"], x, state, mode=mode)
    x = x + tm_out
    cm_out, shift_cm = channel_mix(cfg, p["cm"], x, state)
    x = x + cm_out
    return x, RWKVLayerState(shift_tm, shift_cm, wkv)


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    device=None) -> RWKVLayerState:
    """Stacked-over-layers recurrent state, zeros."""
    L, d, H, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd
    dt = cfg.param_dtype
    return RWKVLayerState(
        shift_tm=torch.zeros((L, batch, d), dtype=dt, device=device),
        shift_cm=torch.zeros((L, batch, d), dtype=dt, device=device),
        wkv=torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                        device=device),
    )


# --------------------------------------------------------------------------- #
# Full model (family = "ssm")
# --------------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random params on ``gen.device`` (N(0, 1/fan_in) projections, N(0,
    0.02²) embedding, JAX's constant leaves: decay logit −1, lerps 0.5, the
    bonus and the decay LoRA's B at zero)."""
    dtype = cfg.param_dtype
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    return {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "ln_in_scale": zeros,
        "layers": rwkv_layer_params(cfg, gen, dtype, cfg.n_layers),
        "ln_f_scale": zeros.clone(),
        "head": dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype),
    }


def forward(cfg: ModelConfig, params: dict, *, tokens: torch.Tensor,
            state: Optional[RWKVLayerState] = None,
            mode: Optional[str] = None):
    """tokens (B,S) -> (logits (B,S,V), new_state).  ``state`` is the
    stacked-over-layers recurrent state; pass it for decode (S may be 1),
    None for training from scratch.  ``mode`` overrides ``cfg.scan_mode``."""
    mode = _resolve_mode(cfg, mode)
    x = params["embed"][tokens.long()]
    x = rmsnorm(x, params["ln_in_scale"])
    outs = []
    layers = layer_views(params["layers"], cfg.n_layers)
    for i, p in enumerate(layers):
        st = (None if state is None else
              RWKVLayerState(state.shift_tm[i], state.shift_cm[i],
                             state.wkv[i]))
        x, ns = rwkv_block(cfg, p, x, st, mode=mode)
        outs.append(ns)
    new_state = RWKVLayerState(*(torch.stack(a) for a in zip(*outs)))
    x = rmsnorm(x, params["ln_f_scale"])
    return x @ params["head"], new_state
