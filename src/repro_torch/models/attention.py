"""Attention: GQA / MHA, causal + sliding-window + cross — the port of
``repro.models.attention`` with its three impls:

* ``xla``          — einsum attention (materializes the score matrix);
* ``chunked``      — online softmax over KV blocks (the flash algorithm in
                     plain torch), block-skipping under ``arange_layout``;
* ``pallas_flash`` — the K2 CUDA kernel (``kernels/flash_attention``), with
                     the JAX routing rule unchanged: only causal attention
                     with no ``kv_len`` and Sq == Sk goes to the kernel,
                     everything else to ``chunked``.

KV caches are dicts ``{"k": (B,cap,KV,hd), "v": …, "pos": …}`` per layer,
stacked over layers by the model.  Unlike the JAX version, cache writes go
IN PLACE into the tensors the caller passed (the returned cache holds the
same tensors) — one cache-sized buffer instead of a fresh copy per layer.
A sliding-window model's cache is a ring of ``min(max_len, window)`` rows:
position p lives in row p % cap, and ``pos`` holds each row's absolute
position (−1 while empty).  Cross-attention (Whisper's decoder) is
non-causal against encoder K/V computed once per sequence
(``precompute_cross_kv``), so it never reaches K2.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models.common import (apply_rope, dense_init, reshape,
                                       rope_cos_sin, shard_hint)

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def attention_params(cfg, gen: torch.Generator, dtype, layers: int,
                     cross: bool = False) -> dict:
    """Attention leaves stacked over ``layers`` on axis 0 (a ``cross``
    attention takes no qkv bias, as in JAX)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, (layers, d, H * hd), dtype, fan_in=d),
        "wk": dense_init(gen, (layers, d, KV * hd), dtype, fan_in=d),
        "wv": dense_init(gen, (layers, d, KV * hd), dtype, fan_in=d),
        "wo": dense_init(gen, (layers, H * hd, d), dtype, fan_in=H * hd),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((layers, width), dtype=dtype,
                                  device=gen.device)
    return p


def project_qkv(cfg, p: dict, xq: torch.Tensor, xkv: torch.Tensor):
    """xq (B,Sq,d) -> q (B,Sq,H,hd);  xkv (B,Skv,d) -> k,v (B,Skv,KV,hd)."""
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    B, Sq = xq.shape[:2]
    Skv = xkv.shape[1]
    return (reshape(q, B, Sq, H, hd), reshape(k, B, Skv, KV, hd),
            reshape(v, B, Skv, KV, hd))


# --------------------------------------------------------------------------- #
# Core attend (shared mask logic)
# --------------------------------------------------------------------------- #
def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int, kv_len) -> torch.Tensor:
    """Boolean mask; k_pos == −1 marks invalid slots, −2 always-attendable
    prefix slots.  (Q,K) when both sides are shared, (B,Q,K) otherwise."""
    if q_pos.dim() == 1 and k_pos.dim() == 1:
        qp, kp = q_pos[:, None], k_pos[None, :]
    else:
        qp = (q_pos if q_pos.dim() == 2 else q_pos[None])[:, :, None]
        kp = (k_pos if k_pos.dim() == 2 else k_pos[None])[:, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    if kv_len is not None:
        m = m & (kp < kv_len)
    return m | (kp == -2)


def _bcast_mask(m: torch.Tensor) -> torch.Tensor:
    """(Q,K) or (B,Q,K) -> broadcastable over (B, KV, G, Q, K)."""
    return m[None, None, None] if m.dim() == 2 else m[:, None, None]


def attend_xla(q, k, v, *, q_pos, k_pos, causal=True, window=0, kv_len=None,
               scale=None):
    """q (B,Q,H,hd), k/v (B,K,KV,hd) -> (B,Q,H,hd).  GQA via head grouping."""
    B, Q, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qg = reshape(q, B, Q, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32) * scale
    scores = torch.where(_bcast_mask(_mask(q_pos, k_pos, causal, window,
                                           kv_len)), scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return reshape(out, B, Q, H, hd)


def attend_chunked(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                   kv_len=None, scale=None, chunk=1024, q_chunk=0,
                   arange_layout=False, _q_span=None):
    """Online-softmax attention tiled over KV (and optionally Q) blocks.

    ``arange_layout=True`` asserts q_pos == k_pos == arange(S): causal
    Q-blocks then skip KV blocks wholly in their future, and SWA blocks
    wholly beyond the window — the flash kernel's block sparsity."""
    B, Q, H, hd = q.shape
    if q_chunk and Q > q_chunk:
        outs = []
        for qs in range(0, Q, q_chunk):
            qe = min(qs + q_chunk, Q)
            outs.append(attend_chunked(
                q[:, qs:qe], k, v, q_pos=q_pos[qs:qe], k_pos=k_pos,
                causal=causal, window=window, kv_len=kv_len, scale=scale,
                chunk=chunk, q_chunk=0, arange_layout=arange_layout,
                _q_span=(qs, qe) if arange_layout else None))
        return torch.cat(outs, dim=1)
    if arange_layout and _q_span is None:
        _q_span = (0, Q)

    S = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    chunk = min(chunk, S)
    n_chunks = (S + chunk - 1) // chunk
    pad = n_chunks * chunk - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    qg = reshape(q, B, Q, KV, G, hd).to(torch.float32) * scale

    dev = q.device
    m_prev = torch.full((B, KV, G, Q), NEG_INF, dtype=torch.float32, device=dev)
    l_prev = torch.zeros((B, KV, G, Q), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Q, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        if _q_span is not None:
            k_lo, k_hi = c * chunk, min((c + 1) * chunk, S) - 1
            if causal and k_lo > _q_span[1] - 1:
                continue            # block entirely in the future
            if window > 0 and k_hi <= _q_span[0] - window:
                continue            # block entirely beyond the SWA window
        kc = k[:, c * chunk:(c + 1) * chunk]
        vc = v[:, c * chunk:(c + 1) * chunk]
        kpc = k_pos[..., c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kc.to(torch.float32))
        s = torch.where(_bcast_mask(_mask(q_pos, kpc, causal, window,
                                          kv_len)), s, NEG_INF)
        m_cur = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        corr = torch.exp(m_prev - m_cur)
        l_prev = l_prev * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p, vc.to(torch.float32))
        m_prev = m_cur
    out = acc / torch.clamp_min(l_prev, 1e-30)[..., None]
    return reshape(out.permute(0, 3, 1, 2, 4), B, Q, H, hd).to(q.dtype)


def attend(cfg, q, k, v, *, arange_layout=False, **kw):
    impl = cfg.attention_impl
    if impl == "chunked":
        return attend_chunked(q, k, v, chunk=cfg.attention_chunk,
                              q_chunk=cfg.attention_q_chunk,
                              arange_layout=arange_layout, **kw)
    if impl == "pallas_flash":
        # the JAX routing rule: only causal self-attention without kv_len
        # and with Sq == Sk goes to the kernel; the rest to chunked
        if kw.get("causal", True) and kw.get("kv_len") is None \
                and q.shape[1] == k.shape[1]:
            return flash_attention(q, k, v, causal=True,
                                   window=kw.get("window", 0))
        return attend_chunked(q, k, v, chunk=cfg.attention_chunk,
                              arange_layout=arange_layout, **kw)
    return attend_xla(q, k, v, **kw)


# --------------------------------------------------------------------------- #
# Caches and the block-level entry point
# --------------------------------------------------------------------------- #
def init_cache(cfg, batch: int, max_len: int, dtype, device,
               layers: Optional[int] = None, per_slot: bool = False) -> dict:
    """Stacked-over-layers KV cache with a slot-position array (−1 empty);
    SWA models keep a ring of ``min(max_len, sliding_window)`` rows.
    ``pos`` is shared by the batch, (L, cap), or with ``per_slot`` one row
    per batch slot, (L, B, cap): the serving engine's dense slab, whose
    slots decode at their own positions.  (The paged engine assembles
    per-slot caches from its pool.)"""
    L = layers if layers is not None else cfg.n_layers
    KV, hd = cfg.kv_heads, cfg.hd
    cap = max_len if cfg.sliding_window == 0 else min(max_len,
                                                      cfg.sliding_window)
    shape = (L, batch, cap, KV, hd)
    pos_shape = (L, batch, cap) if per_slot else (L, cap)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full(pos_shape, -1, dtype=torch.int32, device=device)}


def self_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                   cache: Optional[dict] = None, cache_pos=None):
    """Causal (optionally sliding-window) self attention; the three cache
    branches of the JAX version:

    * training: ``cache`` is None;
    * prefill into a fresh cache: ``cache_pos`` is None, K/V written at the
      ring slots of positions [0, S);
    * decode / chunk prefill: ``cache_pos`` is a (B,) tensor of per-row
      write positions (each row writes its S new rows at ``cache_pos[b]``
      and attends with its own ``positions[b]`` and ``pos`` row), or a
      python int / 0-d tensor shared by the batch (``positions`` (S,)).

    Returns (out (B,S,d), cache | None); cache writes are in place."""
    B, S, _ = x.shape
    q, k, v = project_qkv(cfg, p, x, x)
    if cfg.use_rope:
        cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = shard_hint(q, "act_heads")
    k = shard_hint(k, "act_kv_heads")

    new_cache = None
    if cache is not None and cache_pos is not None:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        cap = ck.shape[1]
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
            # per-row writes: row b's S new rows land at cache_pos[b] + j
            rows = (cache_pos.to(torch.int64)[:, None]
                    + torch.arange(S, device=x.device)[None]) % cap
            bidx = torch.arange(B, device=x.device)[:, None]
            ck[bidx, rows] = k
            cv[bidx, rows] = v
            pos_rows = positions if positions.dim() == 2 else positions[None]
            cpos[bidx, rows] = pos_rows.to(torch.int32).expand(B, S)
        else:
            start = int(cache_pos) % cap
            ck[:, start:start + S] = k
            cv[:, start:start + S] = v
            cpos[start:start + S] = positions.to(torch.int32)
        new_cache = cache
        out = attend(cfg, q, ck, cv, q_pos=positions, k_pos=cpos,
                     causal=cfg.causal, window=cfg.sliding_window)
    else:
        out = attend(cfg, q, k, v, q_pos=positions, k_pos=positions,
                     causal=cfg.causal, window=cfg.sliding_window,
                     arange_layout=True)
        if cache is not None:
            # prefill into a fresh cache: keep the last ``cap`` tokens, rolled
            # into their ring slots (position p lives at p % cap)
            cap = cache["k"].shape[1]
            keep = min(S, cap)
            shift = S % cap if S > cap else 0
            cache["k"][:, :keep] = _roll(k[:, S - keep:], shift, 1)
            cache["v"][:, :keep] = _roll(v[:, S - keep:], shift, 1)
            cache["pos"][:keep] = _roll(
                positions[S - keep:].to(torch.int32), shift, 0)
            new_cache = cache

    out = reshape(out, B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"], new_cache


def _roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dim)`` for 0 ≤ shift < size, by two slices:
    the same bits, and a DTensor shards it where a torch has no sharding
    rule for ``aten.roll`` (2.11)."""
    if shift == 0:
        return x
    n = x.shape[dim]
    return torch.cat((x.narrow(dim, n - shift, shift),
                      x.narrow(dim, 0, n - shift)), dim)


def cross_attention(cfg, p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor) -> torch.Tensor:
    """Decoder → encoder attention (Whisper): x (B,S,d) against the
    precomputed enc_k / enc_v (B,Senc,KV,hd), non-causal, no window."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = reshape(x @ p["wq"], B, S, H, hd)
    S_enc = enc_k.shape[1]
    out = attend(cfg, q, enc_k, enc_v,
                 q_pos=torch.arange(S, dtype=torch.int32, device=x.device),
                 k_pos=torch.arange(S_enc, dtype=torch.int32,
                                    device=x.device),
                 causal=False, window=0)
    return reshape(out, B, S, H * hd) @ p["wo"]


def precompute_cross_kv(cfg, p: dict, enc_out: torch.Tensor):
    """(k, v), each (B,Senc,KV,hd), of the encoder states under one
    layer's cross-attention projections."""
    B, S, _ = enc_out.shape
    KV, hd = cfg.kv_heads, cfg.hd
    k = reshape(enc_out @ p["wk"], B, S, KV, hd)
    v = reshape(enc_out @ p["wv"], B, S, KV, hd)
    return k, v
