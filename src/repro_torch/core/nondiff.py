"""Non-differentiable objectives for MeZO (paper §3.3, Table 3) — the port
of ``repro.core.nondiff``.

ZO needs only function values, so the "loss" may be any scalar metric.
These objectives are built from argmax and comparisons: zero gradient
almost everywhere, so backprop cannot optimize them and MeZO can.  Every
function returns a minimization objective (the negated metric) as an f32
0-d tensor.  ``token_f1`` computes JAX's per-pair function over a batch
dimension written out where JAX uses ``vmap``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def negative_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """−accuracy of argmax predictions.  logits (..., C), labels (...)."""
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32)
        return -torch.sum(correct * m) / torch.clamp_min(torch.sum(m), 1.0)
    return -(torch.sum(correct) * _inv(correct.numel(), correct.device))


def negative_accuracy_parts(logits: torch.Tensor, labels: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``[−Σ correct·mask, Σ mask]`` (f32, shape (2,)): sums over row
    shards add, and the first over the second (at least 1) is
    ``negative_accuracy`` of the whole batch."""
    correct = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    m = (torch.ones_like(correct) if mask is None
         else mask.to(torch.float32))
    return torch.stack([-torch.sum(correct * m), torch.sum(m)])


def token_f1(pred_ids: torch.Tensor, gold_ids: torch.Tensor,
             pad_id: int = 0) -> torch.Tensor:
    """Bag-of-tokens F1 between predicted and gold id sequences (the SQuAD
    metric at the token level, sort-free), averaged over the batch.

    pred_ids (B, T), gold_ids (B, Tg) int, ``pad_id`` padding.  The exact
    multiset overlap Σ_v min(c_p(v), c_g(v)) without a vocabulary: a
    prediction matches when its occurrence index among equal predictions
    is below its count in gold."""
    f1 = _f1_rows(pred_ids, gold_ids, pad_id)
    s = f1[0]
    for x in f1[1:]:
        s = s + x
    return s * _inv(f1.numel(), f1.device)


def _f1_rows(pred_ids: torch.Tensor, gold_ids: torch.Tensor,
             pad_id: int) -> torch.Tensor:
    """``token_f1`` of each row, shape (B,)."""
    p, g = pred_ids, gold_ids
    pm = p != pad_id
    gm = g != pad_id
    eq = (p[:, :, None] == g[:, None, :]) & pm[:, :, None] & gm[:, None, :]
    p_eq_p = (p[:, :, None] == p[:, None, :]) & pm[:, :, None] & pm[:, None, :]
    rank_p = torch.sum(torch.tril(p_eq_p, -1), dim=2)    # occurrence index
    gold_count = torch.sum(eq, dim=2)                     # count in gold
    matched = (rank_p < gold_count) & pm
    overlap = torch.sum(matched.to(torch.float32), dim=1)
    n_p = torch.sum(pm.to(torch.float32), dim=1)
    n_g = torch.sum(gm.to(torch.float32), dim=1)
    prec = overlap / torch.clamp_min(n_p, 1.0)
    rec = overlap / torch.clamp_min(n_g, 1.0)
    return torch.where(overlap > 0,
                       2 * prec * rec / torch.clamp_min(prec + rec, 1e-9),
                       torch.zeros_like(overlap))


def _inv(n: int, device) -> torch.Tensor:
    """f32 1/n.  XLA:CPU computes ``jnp.mean`` as the sum times 1/n, and
    sums up to 32 elements left to right — the batch mean above, so the
    scores have JAX's bits where ``torch.mean`` (sum / n, summed in
    another order) can differ by an ulp."""
    return 1.0 / torch.tensor(float(n), dtype=torch.float32, device=device)


def negative_f1(pred_ids: torch.Tensor, gold_ids: torch.Tensor,
                pad_id: int = 0) -> torch.Tensor:
    return -token_f1(pred_ids, gold_ids, pad_id)


def negative_f1_parts(pred_ids: torch.Tensor, gold_ids: torch.Tensor,
                      pad_id: int = 0) -> torch.Tensor:
    """``[−Σ_rows token_f1, rows]`` (f32, shape (2,)): sums over row
    shards add, and the first over the second is ``negative_f1`` of the
    whole batch (a uniform mean over rows)."""
    f1 = _f1_rows(pred_ids, gold_ids, pad_id)
    return torch.stack([-torch.sum(f1), torch.tensor(
        float(f1.numel()), dtype=torch.float32, device=f1.device)])


def make_accuracy_objective(apply_fn: Callable,
                            label_positions=None) -> Callable:
    """Wrap a model ``apply_fn(params, batch) -> logits`` into a −accuracy
    objective over ``batch['labels']``."""
    def objective(params, batch):
        logits = apply_fn(params, batch)
        mask = batch.get("loss_mask") if isinstance(batch, dict) else None
        return negative_accuracy(logits, batch["labels"], mask)
    return objective


def make_f1_objective(greedy_decode_fn: Callable, pad_id: int = 0) -> Callable:
    """Wrap a greedy decoder ``(params, batch) -> pred_ids`` into −F1
    against ``batch['gold_ids']`` (the paper's SQuAD-F1 setup, App. E.6)."""
    def objective(params, batch):
        pred = greedy_decode_fn(params, batch)
        return negative_f1(pred, batch["gold_ids"], pad_id)
    return objective
