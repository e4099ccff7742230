"""Parameter-efficient fine-tuning: LoRA and prefix tuning — the port of
``repro.models.peft`` (paper §3 / App. E.5), for the transformer families
(dense, moe, hybrid).

MeZO composes with PEFT by construction: the optimizer perturbs whatever
tree it is given.  ``peft_params`` merges the frozen base and the PEFT tree
into ONE parameter tree, ``peft_loss_fn`` is its loss, and a
``repro_torch.select.peft(mode)`` selection scopes the optimizer to the PEFT
subtree — the base leaves get no launch, no write and no decay.  The
deprecated tree-swap entry points ``lora_loss_fn`` / ``prefix_loss_fn`` are
bitwise-equal shims over that loss.

LoRA (Hu et al. 2022):    W_eff = W + (α/r)·A·B on the attention q and v
                          projections (the paper's r = 8, α = 16).
Prefix (Li & Liang 2021): m virtual K/V pairs per layer, prepended at
                          attention time; initialized from real token
                          activations (the paper's stability trick, Tab. 17).

The initializers draw from a ``torch.Generator`` (JAX's threefry draws are
not reproduced: parity tests carry JAX's trees across with
``repro_torch.convert``), except ``init_lora`` given a threefry key, which
draws JAX's A bit for bit (the tenants' LoRA init, seeded by a ledger).  One reference quirk is kept bit for bit:
``init_lora``'s 0-d floating ``_scale`` leaf lies under ``['lora']``, so a
``peft("lora")`` selection perturbs and updates it like A and B.

The prefix forward attends with more keys than queries, so the
``pallas_flash`` attention routes it to the chunked path, as JAX does.  On
the hybrid family its SSM side sees no prefix and starts from a zero
state, as in JAX.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer
from repro_torch.models.common import (apply_norm, apply_rope, dense_init,
                                       dense_init_key, rope_cos_sin,
                                       shard_hint)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import ssm_scan
from repro_torch.perturb.stream import fold_in
from repro_torch.select import PEFT_MODES

PREFIX_POS = -2  # sentinel k_pos: always attendable (see attention._mask)


# --------------------------------------------------------------------------- #
# LoRA
# --------------------------------------------------------------------------- #
def init_lora(cfg: ModelConfig, gen, rank: int = 8, alpha: float = 16.0,
              targets: tuple = ("wq", "wv"), device: DeviceSpec = None) -> dict:
    """LoRA trees for the stacked attention projections; B is zero, so the
    delta starts at exactly zero.  A is N(0, 1/L) (``dense_init``'s fan-in
    is the leading axis, as in JAX).

    ``gen`` is a ``torch.Generator`` (A drawn from it, on its device) or a
    threefry key (``perturb.stream.prng_key``): then target i's A is JAX's
    ``dense_init(fold_in(key, i), …)`` bit for bit (``dense_init_key``), on
    ``device`` (the card unless the caller names one) — so a tenant ledger's
    ``base_seed`` rebuilds the adapter JAX trained."""
    from_key = not isinstance(gen, torch.Generator)
    dev = resolve_device(device) if from_key else gen.device
    dtype = cfg.param_dtype
    L, d, H, KV, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                       cfg.hd)
    outs = {"wq": H * hd, "wk": KV * hd, "wv": KV * hd, "wo": d}
    tree = {}
    for i, t in enumerate(targets):
        shape = (L, d if t != "wo" else H * hd, rank)
        tree[t] = {
            "a": (dense_init_key(fold_in(gen, i), shape, dtype, dev)
                  if from_key else dense_init(gen, shape, dtype)),
            "b": torch.zeros((L, rank, outs[t]), dtype=dtype, device=dev),
        }
    tree["_scale"] = torch.tensor(alpha / rank, dtype=dtype, device=dev)
    return tree


def merge_lora(base_params: dict, lora: dict) -> dict:
    """``base_params`` with W := W + (α/r)·A·B on the targeted stacked
    attention leaves (rank-r products, formed inside the loss so a
    perturbation of A / B flows through exactly); the base leaves are not
    written."""
    scale = lora["_scale"]
    attn = dict(base_params["layers"]["attn"])
    for t, ab in lora.items():
        if t.startswith("_"):
            continue
        w = base_params["layers"]["attn"][t]
        delta = torch.einsum("ldr,lro->ldo", ab["a"], ab["b"]) * scale
        attn[t] = w + delta.to(w.dtype)
    layers = dict(base_params["layers"])
    layers["attn"] = attn
    out = dict(base_params)
    out["layers"] = layers
    return out


def lora_loss_fn(cfg: ModelConfig, base_params: dict) -> Callable:
    """DEPRECATED tree-swap entry point: ``peft_loss_fn(cfg, "lora")`` over
    ``peft_params(base, lora, "lora")`` with ``select.peft("lora")`` is the
    unified path, and this shim wraps exactly that loss."""
    unified = peft_loss_fn(cfg, "lora")

    def loss(lora_params, batch):
        return unified({"base": base_params, "lora": lora_params}, batch)

    def parts(lora_params, batch):
        return unified.parts({"base": base_params, "lora": lora_params},
                             batch)

    loss.parts = parts
    return loss


# --------------------------------------------------------------------------- #
# Prefix tuning
# --------------------------------------------------------------------------- #
def init_prefix(cfg: ModelConfig, gen: torch.Generator, m: int = 5) -> dict:
    """Random-init prefixes (the ablation baseline): N(0, 0.02²)."""
    shape = (cfg.n_layers, m, cfg.kv_heads, cfg.hd)

    def draw():
        z = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return z.to(cfg.param_dtype) * 0.02

    return {"pk": draw(), "pv": draw()}


def prefix_from_tokens(cfg: ModelConfig, params: dict,
                       tokens: torch.Tensor) -> dict:
    """Per-layer K/V of ``tokens`` (1, m) under the frozen LM: each layer's
    projections of its normed input (K before RoPE, as JAX harvests it),
    the activations advanced through the real block."""
    with torch.no_grad():
        x = transformer.embed_tokens(cfg, params, tokens)
        m = tokens.shape[1]
        positions = torch.arange(m, dtype=torch.int32, device=x.device)
        ks, vs = [], []
        for lp in transformer.layer_views(params["layers"], cfg.n_layers):
            h = apply_norm(cfg, x, lp["ln1"])
            _, k, v = attn_lib.project_qkv(cfg, lp["attn"], h, h)
            ks.append(k[0])
            vs.append(v[0])
            x = transformer.block(cfg, lp, x, positions, None, None)[0]
        return {"pk": torch.stack(ks).to(cfg.param_dtype),
                "pv": torch.stack(vs).to(cfg.param_dtype)}


def init_prefix_from_tokens(cfg: ModelConfig, params: dict,
                            gen: torch.Generator, m: int = 5) -> dict:
    """The paper's real-activation init (App. E.5, Table 17): sample m
    vocabulary tokens, run the frozen LM, and harvest their per-layer K/V."""
    toks = torch.randint(0, cfg.vocab_size, (1, m), generator=gen,
                         device=gen.device)
    return prefix_from_tokens(cfg, params, toks)


def _forward_with_prefix(cfg: ModelConfig, params: dict, prefix: dict,
                         batch):
    """(logits, aux) of a forward pass in which each layer's attention
    sees [prefix K/V ; K/V], the prefix at the always-attendable position
    −2; aux the moe layers' summed load-balancing loss (None for dense
    and hybrid)."""
    transformer._check_family(cfg)
    tokens, embeds = batch.get("tokens"), batch.get("embeds")
    if embeds is None:
        x = transformer.embed_tokens(cfg, params, tokens)
    else:
        x = embeds.to(cfg.param_dtype)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    m = prefix["pk"].shape[1]
    k_pos = torch.cat([torch.full((m,), PREFIX_POS, dtype=torch.int32,
                                  device=x.device), positions])
    if cfg.use_rope:
        cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if cfg.n_experts else None)
    for i, lp in enumerate(transformer.layer_views(params["layers"],
                                                   cfg.n_layers)):
        h = apply_norm(cfg, x, lp["ln1"])
        q, k, v = attn_lib.project_qkv(cfg, lp["attn"], h, h)
        if cfg.use_rope:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        pk = prefix["pk"][i][None].expand((B,) + prefix["pk"].shape[1:])
        pv = prefix["pv"][i][None].expand((B,) + prefix["pv"].shape[1:])
        k_all = torch.cat([pk.to(k.dtype), k], dim=1)
        v_all = torch.cat([pv.to(v.dtype), v], dim=1)
        out = attn_lib.attend(cfg, q, k_all, v_all, q_pos=positions,
                              k_pos=k_pos, causal=True,
                              window=cfg.sliding_window)
        out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        if cfg.family == "hybrid":
            ssm_out, _ = ssm_scan(cfg, lp["ssm"],
                                  apply_norm(cfg, x, lp["ln_ssm"]), None)
            mix = lp["mix"].to(out.dtype)
            x = x + mix[0] * out + mix[1] * ssm_out
        else:
            x = x + out
        h2 = apply_norm(cfg, x, lp["ln2"])
        if cfg.n_experts:
            mo, aux_l = moe_ffn(cfg, lp["moe"], h2)
            x, aux = x + mo, aux + aux_l
        else:
            x = x + ffn(cfg, lp["mlp"], h2)
        x = shard_hint(x, "act_btd")
    x = apply_norm(cfg, x, params["ln_f"])
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    return x @ head, aux


def prefix_loss_fn(cfg: ModelConfig, base_params: dict) -> Callable:
    """DEPRECATED tree-swap entry point: a bitwise-equal shim over
    ``peft_loss_fn(cfg, "prefix")`` on ``peft_params(base, prefix,
    "prefix")``."""
    unified = peft_loss_fn(cfg, "prefix")

    def loss(prefix_params, batch):
        return unified({"base": base_params, "prefix": prefix_params}, batch)

    def parts(prefix_params, batch):
        return unified.parts({"base": base_params, "prefix": prefix_params},
                             batch)

    loss.parts = parts
    return loss


# --------------------------------------------------------------------------- #
# The unified merged-tree path
# --------------------------------------------------------------------------- #
def peft_params(base_params: dict, peft_tree: dict, mode: str) -> dict:
    """The ONE tree the unified loss consumes: ``{"base": base, mode:
    peft_tree}``; a ``select.peft(mode)`` selection scopes the optimizer to
    the ``mode`` subtree."""
    if mode not in PEFT_MODES:
        raise ValueError(f"unknown peft mode {mode!r}; available: {PEFT_MODES}")
    return {"base": base_params, mode: peft_tree}


def peft_loss_fn(cfg: ModelConfig, mode: str) -> Callable:
    """``loss(merged, batch)`` over a ``peft_params`` merged tree, with the
    ``parts(merged, batch)`` of the loss it wraps (``transformer.
    loss_parts``: what the data-parallel reduction sums across ranks)."""
    if mode == "lora":
        base_loss = transformer.train_loss_fn(cfg)

        def loss(merged, batch):
            return base_loss(merge_lora(merged["base"], merged["lora"]),
                             batch)

        def parts(merged, batch):
            return base_loss.parts(merge_lora(merged["base"],
                                              merged["lora"]), batch)
    elif mode == "prefix":
        def loss(merged, batch):
            logits, aux = _forward_with_prefix(cfg, merged["base"],
                                               merged["prefix"], batch)
            return transformer.lm_loss(cfg, logits, batch["labels"],
                                       batch.get("loss_mask"), aux)

        def parts(merged, batch):
            logits, aux = _forward_with_prefix(cfg, merged["base"],
                                               merged["prefix"], batch)
            return transformer.loss_parts(cfg, logits, batch["labels"],
                                          batch.get("loss_mask"), aux)
    else:
        raise ValueError(f"unknown peft mode {mode!r}; available: {PEFT_MODES}")
    loss.parts = parts
    return loss


def peft_selection(mode: str):
    """The ``repro_torch.select`` selection matching a ``peft_params``
    merged tree (perturb only the ``mode`` subtree)."""
    from repro_torch.select import peft as _peft_selection
    return _peft_selection(mode)
