"""Decoder-only transformer, dense, moe and hybrid families — the port of
``repro.models.transformer``.

Params keep the JAX layout, block leaves stacked over layers on axis 0:

    {"embed": (V, d),
     "layers": {"ln1": …, "attn": …, ("mlp" | "moe"): …,
                ["ln_ssm": …, "ssm": …, "mix": …], "ln2": …},
     "ln_f": …, ["head": (d, V)]}

so the leaf order (and hence every z stream's leaf seed) is the JAX one
(sorted keys: attn, ln1, ln2, ln_ssm, mix, mlp, ssm).  The moe family's
FFN is ``models/moe.py``; its per-layer load-balancing losses are summed
over the layers and enter ``lm_loss`` as ``aux_coef · aux``.  The hybrid
family (Hymba) runs SSM heads (``models/ssm.py``) beside the attention in
every block, ``x + mix[0]·attn_out + mix[1]·ssm_out``; its stacked SSM
state goes in and comes back through ``forward``'s ``ssm_state``.  The
layer loop is a Python loop over the stacked leaves (``jax.lax.scan`` has
no counterpart to need); a KV cache, when given, is written in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       norm_params, settle, shard_hint,
                                       sinusoidal_at)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn, ffn_params
from repro_torch.models.moe import moe_ffn, moe_params
from repro_torch.models.ssm import ssm_params, ssm_scan

#: the load-balancing loss's weight in ``lm_loss`` (JAX's default)
AUX_COEF = 0.01


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "hybrid") or (
            cfg.family == "moe") != bool(cfg.n_experts):
        raise NotImplementedError(
            f"family {cfg.family!r} (n_experts={cfg.n_experts}) has no "
            "transformer forward: dense, moe and hybrid run here, ssm in "
            "models/rwkv6.py and encdec in models/encdec.py")


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random params on ``gen.device`` (N(0, 1/fan_in) projections and
    router, N(0, 0.02²) embedding, zero biases and norm offsets; hybrid
    adds ``ln_ssm``, the SSM leaves and ``mix`` = 0.5, 0.5 per layer)."""
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
    if cfg.family == "hybrid":
        layers["ln_ssm"] = norm_params(cfg, cfg.d_model, dtype, dev, layers=L)
        layers["ssm"] = ssm_params(cfg, gen, dtype, L)
        layers["mix"] = torch.full((L, 2), 0.5, dtype=dtype, device=dev)
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
          cache_pos, ssm_state=None):
    """One decoder block on layer ``p``'s leaves: (x_out, cache, ssm
    state, aux) — the state the hybrid SSM side's final one (None for the
    other families), aux the moe layer's load-balancing loss (None for
    dense and hybrid)."""
    h = apply_norm(cfg, x, p["ln1"])
    attn_out, new_cache = attn_lib.self_attention(cfg, p["attn"], h,
                                                  positions, cache, cache_pos)
    new_state = None
    if cfg.family == "hybrid":
        hs = apply_norm(cfg, x, p["ln_ssm"])
        ssm_out, new_state = ssm_scan(cfg, p["ssm"], hs, ssm_state)
        mix = p["mix"].to(attn_out.dtype)
        x = x + mix[0] * attn_out + mix[1] * ssm_out
    else:
        x = x + attn_out
    h2 = apply_norm(cfg, x, p["ln2"])
    aux = None
    if cfg.n_experts:
        mo, aux = moe_ffn(cfg, p["moe"], h2)
        x = x + mo
    else:
        x = x + ffn(cfg, p["mlp"], h2)
    return shard_hint(x, "act_btd"), new_cache, new_state, aux


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
    #: the hybrid family's stacked SSM state after the sequence (None
    #: unless an ``ssm_state`` was given)
    ssm_state: Optional[torch.Tensor] = None
    #: the moe layers' load-balancing losses summed (f32); None otherwise
    aux_loss: Optional[torch.Tensor] = None


def forward(cfg: ModelConfig, params: dict, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, cache_pos=None,
            ssm_state: Optional[torch.Tensor] = None) -> ForwardResult:
    """tokens (B,S) int or embeds (B,S,d); ``cache`` stacked over layers
    (leading L axis) and updated in place; ``ssm_state`` (hybrid) stacked
    over layers, (L,B,SH,hd,N) f32, and the new one returned (a hybrid
    forward without it starts every layer from zeros and returns none)."""
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
    x = shard_hint(x, "act_btd")

    layers = layer_views(params["layers"], cfg.n_layers)
    aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                 if cfg.n_experts else None)
    use_ssm = cfg.family == "hybrid" and ssm_state is not None
    new_states = []
    for i, p in enumerate(layers):
        cache_l = (None if cache is None else
                   {"k": cache["k"][i], "v": cache["v"][i],
                    "pos": cache["pos"][i]})
        x, _, st, aux = block(cfg, p, x, positions, cache_l, cache_pos,
                              ssm_state[i] if use_ssm else None)
        if use_ssm:
            new_states.append(st)
        if aux is not None:
            aux_total = aux_total + aux

    x = apply_norm(cfg, x, params["ln_f"])
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    return ForwardResult(shard_hint(x @ head, "act_vocab"), cache,
                         torch.stack(new_states) if use_ssm else None,
                         aux_total)


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #
def _token_nll(cfg: ModelConfig, logits: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy with padded-vocab masking, f32 logsumexp."""
    lg = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        lg = lg.clone()
        lg[..., cfg.vocab_size:] = -1e30
    if cfg.logit_softcap > 0:
        lg = cfg.logit_softcap * torch.tanh(lg / cfg.logit_softcap)
    logz = torch.logsumexp(lg, dim=-1)
    # the gather on (tokens, vocab) rows: the form DTensor shards when the
    # vocab is sharded (a masked local gather, then a sum over the shards)
    idx = labels.to(torch.int64)
    gold = settle(torch.gather(lg.reshape(-1, lg.shape[-1]), 1,
                               idx.reshape(-1, 1))).reshape(idx.shape)
    return logz - gold


def lm_loss_parts(cfg: ModelConfig, logits: torch.Tensor,
                  labels: torch.Tensor,
                  loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token mean's sufficient statistics, ``[Σ nll·mask, Σ mask]`` as
    one f32 (2,) tensor (every token weighs 1 without a mask).  They add
    across row shards of a batch, and ``mean_of_parts`` of their sum is the
    whole batch's masked mean: the data-parallel reduction all-reduces
    them."""
    nll = _token_nll(cfg, logits, labels)
    if loss_mask is None:
        return torch.stack([torch.sum(nll), torch.tensor(
            float(nll.numel()), dtype=torch.float32, device=nll.device)])
    m = loss_mask.to(torch.float32)
    return torch.stack([torch.sum(nll * m), torch.sum(m)])


def mean_of_parts(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] / max(parts[1], 1)``: a weighted mean from its
    sufficient statistics."""
    return parts[0] / torch.clamp_min(parts[1], 1.0)


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None,
            aux_loss: Optional[torch.Tensor] = None,
            aux_coef: float = AUX_COEF) -> torch.Tensor:
    """Teacher-forcing cross entropy with padded-vocab masking, f32
    logsumexp; plus ``aux_coef · aux_loss`` when a moe forward gives one
    (JAX adds the term always, 0 for dense: x + 0 keeps x's bits).  A
    masked loss is ``mean_of_parts(lm_loss_parts(...))``, bit for bit."""
    if loss_mask is not None:
        loss = mean_of_parts(lm_loss_parts(cfg, logits, labels, loss_mask))
    else:
        loss = torch.mean(_token_nll(cfg, logits, labels))
    if aux_loss is None:
        return loss
    return loss + torch.tensor(aux_coef, dtype=torch.float32) * aux_loss


def loss_parts(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
               loss_mask: Optional[torch.Tensor] = None,
               aux_loss: Optional[torch.Tensor] = None,
               aux_coef: float = AUX_COEF) -> torch.Tensor:
    """``lm_loss``'s statistics for the data-parallel reduction:
    ``lm_loss_parts`` ``[s, w]``, and with a moe forward's ``aux_loss`` a
    third entry ``aux_coef · aux_loss`` — a term each rank holds alike once
    the load-balancing sums are reduced across ranks
    (``common.batch_reducer``), added to ``s / max(w, 1)`` of the summed
    pair."""
    parts = lm_loss_parts(cfg, logits, labels, loss_mask)
    if aux_loss is None:
        return parts
    return torch.cat([parts, (torch.tensor(aux_coef, dtype=torch.float32)
                              * aux_loss).reshape(1)])


def train_loss_fn(cfg: ModelConfig):
    """(params, batch) -> scalar loss — the function MeZO's two forward
    passes evaluate.  It carries ``parts(params, batch)``, ``loss_parts``
    of the same forward, which the data-parallel reduction sums across
    ranks (the moe family's with its load-balancing term)."""
    def loss_fn(params, batch):
        r = forward(cfg, params, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"))
        return lm_loss(cfg, r.logits, batch["labels"], batch.get("loss_mask"),
                       r.aux_loss)

    def parts(params, batch):
        r = forward(cfg, params, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"))
        return loss_parts(cfg, r.logits, batch["labels"],
                          batch.get("loss_mask"), r.aux_loss)

    loss_fn.parts = parts
    return loss_fn
