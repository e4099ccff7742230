"""Analytic MODEL_FLOPS (the 'useful' compute) per architecture × cell —
the port of ``repro.analysis.flops``, integer for integer.

Dense LM training: 6·N·D (N = params minus embedding table, D = tokens)
— the standard Chinchilla accounting (fwd 2ND + bwd 4ND).  MeZO performs
*two forwards + a rank-1 update* instead of fwd+bwd, so its useful compute is
4·N·D + Θ(N) ≈ 4·N·D; we report both so the MODEL_FLOPS/HLO_FLOPS ratio is
meaningful for either optimizer.  MoE uses N_active.  Decode: D = new tokens
(B·1), plus attention reads of the cache accounted separately.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, ShapeCell


def backbone_params(cfg: ModelConfig, active: bool = False) -> int:
    """Matmul-participating params (excludes the embedding gather, includes
    the vocab head since logits are a matmul)."""
    n = cfg.n_active_params() if active else cfg.n_params()
    # embedding gather is not a matmul; head is.
    return n - cfg.padded_vocab * cfg.d_model * (1 if not cfg.tie_embeddings else 0)


def attention_flops(cfg: ModelConfig, batch: int, q_len: int, kv_len: int) -> int:
    """2 · (QK^T + PV) matmul flops over all layers/heads."""
    if cfg.family == "ssm":
        # WKV recurrence: per token per head: 3·hd·hd mults (state update + out)
        H, hd = cfg.n_heads, cfg.hd
        return 2 * 3 * cfg.n_layers * batch * q_len * H * hd * hd
    eff_kv = kv_len if cfg.sliding_window == 0 else min(kv_len, cfg.sliding_window)
    fl = 2 * 2 * cfg.n_layers * batch * q_len * eff_kv * cfg.n_heads * cfg.hd
    if cfg.family == "hybrid":
        SH, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
        fl += 2 * 3 * cfg.n_layers * batch * q_len * SH * hd * N
    if cfg.family == "encdec":
        # cross attention: q_len x enc_len (enc_len ~ kv_len for train/prefill)
        fl += 2 * 2 * cfg.n_layers * batch * q_len * kv_len * cfg.n_heads * cfg.hd
    return fl


def model_flops(cfg: ModelConfig, cell: ShapeCell, optimizer: str = "mezo") -> dict:
    """Returns {'model_flops', 'model_flops_6nd', 'tokens'} for the cell."""
    B, S = cell.global_batch, cell.seq_len
    N = backbone_params(cfg, active=True)
    if cell.kind == "train":
        tokens = B * S
        fwd = 2 * N * tokens + attention_flops(cfg, B, S, S)
        if optimizer == "mezo":
            useful = 2 * fwd            # two forward passes, O(N) update
        else:
            useful = 3 * fwd            # fwd + ~2x bwd
        six_nd = 6 * N * tokens
    elif cell.kind == "prefill":
        tokens = B * S
        useful = 2 * N * tokens + attention_flops(cfg, B, S, S)
        six_nd = 2 * N * tokens
    else:  # decode: one token against a seq_len cache
        tokens = B
        useful = 2 * N * tokens + attention_flops(cfg, B, 1, S)
        six_nd = 2 * N * tokens
    return {"model_flops": int(useful), "model_flops_6nd": int(six_nd),
            "tokens": int(tokens), "backbone_params_active": int(N),
            "total_params": int(cfg.n_params())}
