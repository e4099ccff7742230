"""Encoder-decoder transformer (the Whisper-large-v3 backbone) — the port
of ``repro.models.encdec``.

The conv audio frontend is a stub (``models/frontends.py``): the model
takes precomputed frame embeddings (B, S_enc, d).  The encoder is a
non-causal transformer over them with sinusoidal positions; the decoder is
a causal LM whose cross-attention K/V are computed once per sequence
(``precompute_cross_kv``).  Params keep the JAX layout, block leaves
stacked over layers on axis 0:

    {"enc": {"layers": {"ln1", "attn", "ln2", "mlp"}, "ln_f"},
     "dec": {"embed": (V,d), "layers": {"ln1", "attn", "ln_x", "xattn",
                                        "ln2", "mlp"}, "ln_f", "head"}}

Under ``pallas_flash`` only the decoder's causal self-attention of a whole
sequence (teacher forcing) reaches K2; the encoder's and the
cross-attention are non-causal, and a decode step attends against its
cache, so they take the chunked path, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       norm_params, shard_hint, sinusoidal_at,
                                       sinusoidal_embedding)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn, ffn_params
from repro_torch.models.transformer import embed_tokens, layer_views


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random params on ``gen.device`` (N(0, 1/fan_in) projections, N(0,
    0.02²) embedding, zero biases, unit layernorm scales)."""
    dtype, dev, d = cfg.param_dtype, gen.device, cfg.d_model
    Le, L = cfg.encoder_layers, cfg.n_layers
    enc_layers = {
        "ln1": norm_params(cfg, d, dtype, dev, layers=Le),
        "attn": attn_lib.attention_params(cfg, gen, dtype, Le),
        "ln2": norm_params(cfg, d, dtype, dev, layers=Le),
        "mlp": ffn_params(cfg, gen, dtype, Le),
    }
    dec_layers = {
        "ln1": norm_params(cfg, d, dtype, dev, layers=L),
        "attn": attn_lib.attention_params(cfg, gen, dtype, L),
        "ln_x": norm_params(cfg, d, dtype, dev, layers=L),
        "xattn": attn_lib.attention_params(cfg, gen, dtype, L, cross=True),
        "ln2": norm_params(cfg, d, dtype, dev, layers=L),
        "mlp": ffn_params(cfg, gen, dtype, L),
    }
    return {
        "enc": {"layers": enc_layers, "ln_f": norm_params(cfg, d, dtype, dev)},
        "dec": {"embed": embed_init(gen, (cfg.padded_vocab, d), dtype),
                "layers": dec_layers,
                "ln_f": norm_params(cfg, d, dtype, dev),
                "head": dense_init(gen, (d, cfg.padded_vocab), dtype)},
    }


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, d) precomputed embeddings -> encoder states."""
    B, S, d = frames.shape
    x = frames.to(cfg.param_dtype) + sinusoidal_embedding(
        S, d, cfg.param_dtype, frames.device)
    x = shard_hint(x, "act_btd")
    positions = torch.arange(S, dtype=torch.int32, device=frames.device)
    for lp in layer_views(params["enc"]["layers"], cfg.encoder_layers):
        h = apply_norm(cfg, x, lp["ln1"])
        q, k, v = attn_lib.project_qkv(cfg, lp["attn"], h, h)
        out = attn_lib.attend(cfg, q, k, v, q_pos=positions,
                              k_pos=positions, causal=False, window=0)
        x = x + out.reshape(B, S, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        x = x + ffn(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln2"]))
        x = shard_hint(x, "act_btd")
    return apply_norm(cfg, x, params["enc"]["ln_f"])


class DecodeResult(NamedTuple):
    logits: torch.Tensor
    cache: Optional[dict]


def precompute_cross_kv(cfg: ModelConfig, params: dict,
                        enc_out: torch.Tensor) -> dict:
    """Stacked (L, B, S_enc, KV, hd) cross K/V from encoder states."""
    ks, vs = [], []
    for lp in layer_views(params["dec"]["layers"], cfg.n_layers):
        k, v = attn_lib.precompute_cross_kv(cfg, lp["xattn"], enc_out)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           cross_kv: dict, positions: Optional[torch.Tensor] = None,
           cache: Optional[dict] = None, cache_pos=None) -> DecodeResult:
    """Decoder forward: teacher forcing when ``cache`` is None, else
    incremental (the cache written in place at ``cache_pos``).
    ``cross_kv`` from :func:`precompute_cross_kv`."""
    dec = params["dec"]
    x = embed_tokens(cfg, dec, tokens)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if not cfg.use_rope:
        x = x + sinusoidal_at(positions, cfg.d_model, x.dtype)[None]
    x = shard_hint(x, "act_btd")
    for i, lp in enumerate(layer_views(dec["layers"], cfg.n_layers)):
        cache_l = (None if cache is None else
                   {"k": cache["k"][i], "v": cache["v"][i],
                    "pos": cache["pos"][i]})
        attn_out, _ = attn_lib.self_attention(
            cfg, lp["attn"], apply_norm(cfg, x, lp["ln1"]), positions,
            cache_l, cache_pos)
        x = x + attn_out
        x = x + attn_lib.cross_attention(
            cfg, lp["xattn"], apply_norm(cfg, x, lp["ln_x"]),
            cross_kv["k"][i], cross_kv["v"][i])
        x = x + ffn(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln2"]))
        x = shard_hint(x, "act_btd")
    x = apply_norm(cfg, x, dec["ln_f"])
    return DecodeResult(shard_hint(x @ dec["head"], "act_vocab"), cache)


def forward_train(cfg: ModelConfig, params: dict, frames: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing forward: encode the frames, decode the tokens;
    logits (B, S, padded_vocab)."""
    enc_out = encode(cfg, params, frames)
    cross_kv = precompute_cross_kv(cfg, params, enc_out)
    return decode(cfg, params, tokens, cross_kv).logits
