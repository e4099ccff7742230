"""Decoder-only transformer, dense and moe families — the port of
``repro.models.transformer``.

Params keep the JAX layout, block leaves stacked over layers on axis 0:

    {"embed": (V, d),
     "layers": {"ln1": …, "attn": …, ("mlp" | "moe"): …, "ln2": …},
     "ln_f": …, ["head": (d, V)]}

so the leaf order (and hence every z stream's leaf seed) is the JAX one.
The moe family's FFN is ``models/moe.py``; its per-layer load-balancing
losses are summed over the layers and enter ``lm_loss`` as
``aux_coef · aux``.  The layer loop is a Python loop over the stacked
leaves (``jax.lax.scan`` has no counterpart to need); a cache, when given,
is written in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       norm_params, sinusoidal_at)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn, ffn_params
from repro_torch.models.moe import moe_ffn, moe_params

#: the load-balancing loss's weight in ``lm_loss`` (JAX's default)
AUX_COEF = 0.01


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe") or (
            cfg.family == "dense") != (not cfg.n_experts):
        raise NotImplementedError(
            f"family {cfg.family!r} (n_experts={cfg.n_experts}) has no "
            "transformer forward in the port: dense and moe run here, ssm "
            "in models/rwkv6.py, and hybrid and encdec come with the "
            "other-families slice")


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random params on ``gen.device`` (N(0, 1/fan_in) projections and
    router, N(0, 0.02²) embedding, zero biases and norm offsets)."""
    _check_family(cfg)
    dtype, dev, L = cfg.param_dtype, gen.device, cfg.n_layers
    layers = {
        "ln1": norm_params(cfg, cfg.d_model, dtype, dev, layers=L),
        "attn": attn_lib.attention_params(cfg, gen, dtype, L),
        "ln2": norm_params(cfg, cfg.d_model, dtype, dev, layers=L),
    }
    if cfg.n_experts:
        layers["moe"] = moe_params(cfg, gen, dtype, L)
    else:
        layers["mlp"] = ffn_params(cfg, gen, dtype, L)
    params = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "layers": layers,
        "ln_f": norm_params(cfg, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                    dtype)
    return params


def layer_views(tree: dict, n_layers: int) -> list:
    """Each layer's view of the stacked leaves (no copy), one ``unbind`` per
    leaf: under autograd its backward stacks the layers' gradients into one
    leaf-sized tensor, where indexing ``v[i]`` per layer would build a
    zero-filled leaf-sized gradient for every layer."""
    per_leaf = {k: layer_views(v, n_layers) if isinstance(v, dict)
                else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n_layers)]


# --------------------------------------------------------------------------- #
# One block, full forward
# --------------------------------------------------------------------------- #
def block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, cache,
          cache_pos):
    """One decoder block on layer ``p``'s leaves: (x_out, cache, aux) —
    aux the moe layer's load-balancing loss (None for dense)."""
    h = apply_norm(cfg, x, p["ln1"])
    attn_out, new_cache = attn_lib.self_attention(cfg, p["attn"], h,
                                                  positions, cache, cache_pos)
    x = x + attn_out
    h2 = apply_norm(cfg, x, p["ln2"])
    if cfg.n_experts:
        mo, aux = moe_ffn(cfg, p["moe"], h2)
        return x + mo, new_cache, aux
    return x + ffn(cfg, p["mlp"], h2), new_cache, None


def embed_tokens(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens`` scaled by sqrt(d) in the param dtype."""
    x = params["embed"][tokens.long()]
    scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                    dtype=torch.float32)).to(x.dtype)
    return x * scale.to(x.device)


class ForwardResult(NamedTuple):
    logits: torch.Tensor
    cache: Optional[dict]
    #: the moe layers' load-balancing losses summed (f32); None for dense
    aux_loss: Optional[torch.Tensor] = None


def forward(cfg: ModelConfig, params: dict, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, cache_pos=None) -> ForwardResult:
    """tokens (B,S) int or embeds (B,S,d); ``cache`` stacked over layers
    (leading L axis) and updated in place."""
    _check_family(cfg)
    if embeds is None:
        x = embed_tokens(cfg, params, tokens)
    else:
        x = embeds.to(cfg.param_dtype)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if not cfg.use_rope:
        x = x + sinusoidal_at(positions, cfg.d_model, x.dtype)[None]

    layers = layer_views(params["layers"], cfg.n_layers)
    aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                 if cfg.n_experts else None)
    for i, p in enumerate(layers):
        cache_l = (None if cache is None else
                   {"k": cache["k"][i], "v": cache["v"][i],
                    "pos": cache["pos"][i]})
        x, _, aux = block(cfg, p, x, positions, cache_l, cache_pos)
        if aux is not None:
            aux_total = aux_total + aux

    x = apply_norm(cfg, x, params["ln_f"])
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    return ForwardResult(x @ head, cache, aux_total)


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #
def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None,
            aux_loss: Optional[torch.Tensor] = None,
            aux_coef: float = AUX_COEF) -> torch.Tensor:
    """Teacher-forcing cross entropy with padded-vocab masking, f32
    logsumexp; plus ``aux_coef · aux_loss`` when a moe forward gives one
    (JAX adds the term always, 0 for dense: x + 0 keeps x's bits)."""
    lg = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        lg = lg.clone()
        lg[..., cfg.vocab_size:] = -1e30
    if cfg.logit_softcap > 0:
        lg = cfg.logit_softcap * torch.tanh(lg / cfg.logit_softcap)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = logz - gold
    if loss_mask is not None:
        m = loss_mask.to(torch.float32)
        loss = torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    else:
        loss = torch.mean(nll)
    if aux_loss is None:
        return loss
    return loss + torch.tensor(aux_coef, dtype=torch.float32) * aux_loss


def train_loss_fn(cfg: ModelConfig):
    """(params, batch) -> scalar loss — the function MeZO's two forward
    passes evaluate."""
    def loss_fn(params, batch):
        r = forward(cfg, params, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"))
        return lm_loss(cfg, r.logits, batch["labels"], batch.get("loss_mask"),
                       r.aux_loss)
    return loss_fn

