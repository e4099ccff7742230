"""Mixture-of-Experts FFN with GShard-style capacity-based top-k dispatch —
the port of ``repro.models.moe``.

Tokens are cut into groups of M = min(``moe_group_size``, S) consecutive
tokens; each token's router softmax (f32) picks its top-k experts (ties to
the lower index, as ``jax.lax.top_k``), the k gates are renormalised, and
each (token, choice) takes the next free slot of its expert's capacity
buffer, slots handed out in (k, token) order within the group.  Choices
past the capacity C (``_capacity``) are dropped, and the Switch-style
load-balancing loss is returned beside the output.

JAX builds one-hot dispatch and combine tensors and contracts them with
einsums.  A dispatch slot holds exactly one token, so the port gathers the
token into it (the same values); the combine sums each token's kept
choices, weighted by its gate cast to the activation dtype, in ascending
expert order (the order of the einsum's contraction).  The expert products
are batched matmuls, one per expert group of the grouped layout, so the
experts are never concatenated into one (E, …) temporary.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import activation, dense_init, shard_hint


def expert_group_count(cfg) -> int:
    """Expert-wise selection groups of ``cfg`` (≥ 1): G > 1 splits the
    expert tensors into G leaves ``eg{j}`` of E/G experts each (the grouped
    layout ``select.moe_experts(G)`` cycles over); 0 or 1 keeps the single
    leaves ``w1`` / ``w2`` / ``w3`` of all E experts."""
    G = int(cfg.expert_groups or 0)
    if G <= 1:
        return 1
    if cfg.n_experts % G:
        raise ValueError(
            f"expert_groups={G} does not divide n_experts={cfg.n_experts}; "
            "expert-wise selection needs equal-sized groups")
    return G


def _expert_leaves(cfg, gen: torch.Generator, dtype, layers: int,
                   n_exp: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(gen, (layers, n_exp, d, ff), dtype, fan_in=d),
         "w2": dense_init(gen, (layers, n_exp, ff, d), dtype, fan_in=ff)}
    if cfg.gated_ffn:
        p["w3"] = dense_init(gen, (layers, n_exp, d, ff), dtype, fan_in=d)
    return p


def moe_params(cfg, gen: torch.Generator, dtype, layers: int) -> dict:
    """The ``moe`` subtree, leaves stacked over ``layers`` on axis 0:
    ``router`` (L, d, E) and the experts, single-leaf or grouped."""
    d, E = cfg.d_model, cfg.n_experts
    G = expert_group_count(cfg)
    p = {"router": dense_init(gen, (layers, d, E), dtype, fan_in=d)}
    if G == 1:
        p.update(_expert_leaves(cfg, gen, dtype, layers, E))
    else:
        for j in range(G):
            p[f"eg{j}"] = _expert_leaves(cfg, gen, dtype, layers, E // G)
    return p


def _expert_groups(cfg, p: dict) -> list:
    """One layer's experts as [(w1, w2, w3-or-None)] per group, in expert
    order: one entry for the single-leaf layout, G for the grouped one."""
    if "w1" in p:
        return [(p["w1"], p["w2"], p.get("w3"))]
    return [(g["w1"], g["w2"], g.get("w3"))
            for g in (p[f"eg{j}"] for j in range(expert_group_count(cfg)))]


def _capacity(cfg, group_tokens: int) -> int:
    """JAX's capacity: int() truncation, rounded up to 8, at least 8."""
    c = int(cfg.top_k * group_tokens / cfg.n_experts * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


class Routing(NamedTuple):
    """The router's decisions for x reshaped to (G, M, d)."""
    probs: torch.Tensor       # (G, M, E) f32 softmax
    gate_vals: torch.Tensor   # (G, M, K) renormalised, 0 where dropped
    gate_idx: torch.Tensor    # (G, M, K) int64 expert of each choice
    pos: torch.Tensor         # (G, M, K) int64 slot in the expert's buffer
    keep: torch.Tensor        # (G, M, K) bool: pos < C
    capacity: int


def route(cfg, router: torch.Tensor, xg: torch.Tensor) -> Routing:
    """Router softmax in f32, top-k (ties to the lower index), the gates
    renormalised, and each choice's capacity slot in (k, token) order."""
    E, K = cfg.n_experts, cfg.top_k
    G, M, _ = xg.shape
    C = _capacity(cfg, M)
    logits = (xg @ router).to(torch.float32)
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[..., :K]
    gate_idx = order.indices[..., :K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    # choices in (k, token) order; an expert's earlier choices count its slot
    onehot = torch.nn.functional.one_hot(gate_idx.transpose(1, 2).reshape(
        G, K * M), E)                                         # (G, K*M, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = (before * onehot).sum(dim=-1).reshape(G, K, M).transpose(1, 2)
    keep = pos < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return Routing(probs, gate_vals, gate_idx, pos, keep, C)


def aux_loss(cfg, r: Routing) -> torch.Tensor:
    """Switch load-balancing loss: E · Σ_e mean router prob · fraction of
    choices routed to e (dropped choices counted, as in JAX)."""
    E = cfg.n_experts
    me = r.probs.mean(dim=(0, 1))
    routed = torch.nn.functional.one_hot(r.gate_idx, E).to(
        torch.float32).sum(dim=2)
    ce = routed.mean(dim=(0, 1))
    return E * torch.sum(me * ce)


def moe_ffn(cfg, p: dict, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), aux loss f32 scalar) on one layer's
    ``moe`` leaves."""
    B, S, d = x.shape
    E = cfg.n_experts
    M = min(cfg.moe_group_size, S)
    if (B * S) % M:
        raise ValueError(f"tokens {B * S} not divisible by group {M}")
    G = (B * S) // M
    xg = x.reshape(G, M, d)
    r = route(cfg, p["router"], xg)
    C = r.capacity
    # dispatch: slot (e, g, c) of the (E, G·C, d) buffer holds its token
    g_ix = torch.arange(G, device=x.device)[:, None, None].expand_as(r.pos)
    slot = r.gate_idx * (G * C) + g_ix * C + r.pos              # (G, M, K)
    tok = (g_ix * M + torch.arange(M, device=x.device)[None, :, None]
           ).expand_as(r.pos)
    # dropped choices go to a spare trash row past the buffer, thrown away
    # after the copy: a static shape, so the serving engine's stacked decode
    # can vmap it
    kept_slot = torch.where(r.keep, slot, E * G * C).reshape(-1)
    expert_in = torch.zeros(E * G * C + 1, d, dtype=x.dtype, device=x.device)
    expert_in = expert_in.index_copy(0, kept_slot,
                                     x.reshape(G * M, d)[tok.reshape(-1)])
    # JAX's (E, G, C, d) dispatch layout is the hint's shape
    expert_in = shard_hint(expert_in[:-1].reshape(E, G, C, d),
                           "act_experts").reshape(E, G * C, d)
    outs, e0 = [], 0
    for w1, w2, w3 in _expert_groups(cfg, p):
        xin = expert_in[e0:e0 + w1.shape[0]]
        h = torch.matmul(xin, w1)
        if w3 is not None:
            h = activation(cfg.activation, h) * torch.matmul(xin, w3)
        else:
            h = activation(cfg.activation, h)
        outs.append(torch.matmul(h, w2))
        e0 += w1.shape[0]
    expert_out = (outs[0] if len(outs) == 1 else torch.cat(outs)).reshape(
        E * G * C, d)
    # combine: Σ over kept choices in ascending expert order of
    # gate (cast to x's dtype) · expert output, accumulated in f32
    by_e = torch.argsort(r.gate_idx, dim=-1)
    srt = torch.gather(slot, -1, by_e)
    w = torch.gather(r.gate_vals, -1, by_e).to(x.dtype).to(torch.float32)
    kept = torch.gather(r.keep, -1, by_e)
    vals = expert_out[torch.where(kept, srt, 0)].to(torch.float32)
    vals = vals * (w * kept.to(torch.float32))[..., None]   # (G, M, K, d)
    out = vals[:, :, 0]
    for k in range(1, cfg.top_k):
        out = out + vals[:, :, k]
    return out.to(x.dtype).reshape(B, S, d), aux_loss(cfg, r)
