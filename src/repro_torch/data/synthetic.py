"""Synthetic task generators — the port of ``repro.data.synthetic``:
the step-indexed LM stream ``lm_batch``, prompt-based classification
(``PromptClassification``) and span extraction (``SpanExtraction``), each
JAX's batch bit for bit, drawn on the host and moved to ``device``.

``lm_batch(seed, step, ...)`` is a pure function of (seed, step): a restart
at step k regenerates the same batch with no iterator state to checkpoint.
It is JAX's batch bit for bit: the base tokens are
``jax.random.randint(fold_in(PRNGKey(seed), step), (batch, seq), 0, vocab)``
in the threefry layout in force (``randint``), and every other
token is then ``(prev·1103515245 + 12345) mod vocab`` in wrapping int32
arithmetic with a floor mod, as jnp computes it (``plant_structure``).  The
tokens are drawn on the host CPU (a batch is small) and moved to
``device``.  The two task classes draw with ``split`` / ``randint`` /
``bernoulli``, JAX's functions under the same layout (``split`` is
``perturb.stream.split``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.threefry.kernel import random_bits
from repro_torch.perturb.stream import fold_in, partitionable, prng_key
from repro_torch.perturb.stream import split as split

_MASK = 0xFFFFFFFF


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's-complement wraparound."""
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def _bits32(key, n: int) -> torch.Tensor:
    """``_random_bits(key, 32, (n,))`` in the threefry layout in force."""
    return random_bits(key, torch.arange(n, dtype=torch.int64), n, 32,
                       partitionable())


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: two
    32-bit draws from the keys of ``split(key)``, combined as
    ``(hi % span) · ((2¹⁶ % span)² % span) + lo % span`` in wrapping uint32
    arithmetic, mod span; an int64 tensor of int32 values.  Both the split
    and the draws follow the threefry layout in force."""
    n = 1
    for d in shape:
        n *= int(d)
    k_hi, k_lo = split(key)
    hi = _bits32(k_hi, n)
    lo = _bits32(k_lo, n)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    off = (off & _MASK) % span
    return _wrap_int32(off + minval).reshape(tuple(shape))


def uniform(key, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32 on [0, 1): the top 23 of
    32 threefry bits as the mantissa of a float in [1, 2), minus 1."""
    n = 1
    for d in shape:
        n *= int(d)
    f = ((_bits32(key, n) >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32)
    return (f - 1.0).reshape(tuple(shape))


def bernoulli(key, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform < p in f32."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


def plant_structure(base: torch.Tensor, vocab: int) -> torch.Tensor:
    """(batch, seq) int base tokens → tokens whose odd positions are a
    function of their predecessor (int32 result)."""
    b = base.to(torch.int64)
    shifted = torch.remainder(_wrap_int32(b * 1103515245 + 12345), vocab)
    alt = (torch.arange(b.shape[1], device=b.device) % 2 == 1)[None, :]
    return torch.where(alt, torch.roll(shifted, 1, dims=1), b).to(torch.int32)


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device="cpu") -> dict:
    """Deterministic (seed, step) -> {"tokens", "labels", "loss_mask"}."""
    base = randint(fold_in(prng_key(seed), step), (batch, seq), 0, vocab)
    tokens = plant_structure(base, vocab)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(batch, seq, dtype=torch.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens.to(device), "labels": labels.to(device),
            "loss_mask": mask.to(device)}


# --------------------------------------------------------------------------- #
# Prompt-based classification (paper App. A: MeZO needs the prompt)
# --------------------------------------------------------------------------- #
def _to(batch: dict, device) -> dict:
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


@dataclasses.dataclass
class PromptClassification:
    """k-way classification rendered as an LM prompt (JAX's task and
    batches, bit for bit).

    Example layout (token ids), seq_len = body + 3:
        [body tokens … class-dependent distribution …] [SEP] [label_word] [0]
    The loss mask covers only the label-word target (position
    ``body_len``, whose next token is the label word); with
    ``prompt=False`` the label word is a bare class id token with no
    template.  A ``causal=False`` model sees the label word itself at
    ``body_len + 1``: JAX's task, kept as it is.
    """
    vocab: int = 256
    n_classes: int = 2
    body_len: int = 29
    seed: int = 0
    prompt: bool = True

    @property
    def seq_len(self) -> int:
        return self.body_len + 3

    def label_word(self, cls) -> torch.Tensor:
        return 10 + 7 * torch.as_tensor(cls)

    def sample(self, key, n: int, device="cpu") -> dict:
        kc, kb, kn = split(key, 3)
        cls = randint(kc, (n,), 0, self.n_classes)
        lo = 100 + cls * 60
        body = lo[:, None] + randint(kb, (n, self.body_len), 0, 50)
        noise = randint(kn, (n, self.body_len), 0, self.vocab)
        keep = bernoulli(kb, 0.8, (n, self.body_len))   # kb again, as JAX
        body = torch.where(keep, body, noise)
        sep = torch.full((n, 1), 5, dtype=torch.int64)
        lab = (self.label_word(cls) if self.prompt else cls + 1)[:, None]
        pad = torch.zeros((n, 1), dtype=torch.int64)
        tokens = torch.cat([body, sep, lab, pad], dim=1).to(torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.zeros((n, self.seq_len), dtype=torch.float32)
        mask[:, self.body_len] = 1.0
        return _to({"tokens": tokens, "labels": labels, "loss_mask": mask,
                    "cls": cls.to(torch.int32)}, device)

    def batch_for_step(self, step: int, batch: int, device="cpu") -> dict:
        return self.sample(fold_in(prng_key(self.seed), step), batch, device)

    def eval_accuracy(self, cfg, forward_logits, params, key, n: int = 256,
                      device="cpu") -> float:
        """Accuracy of argmax over the class label words at the label
        slot."""
        batch = self.sample(key, n, device)
        logits = forward_logits(params, batch)        # (n, S, V)
        return self._accuracy(logits[:, self.body_len, :], batch["cls"])

    def icl_batch(self, key, n: int, k_shots: int, device="cpu") -> dict:
        """In-context episodes: k labelled demonstrations before the test
        example, whose label word the model predicts with no update."""
        ks = split(key, k_shots + 1)
        demo = [self.sample(ks[j], n)["tokens"][:, :self.body_len + 2]
                for j in range(k_shots)]
        test = self.sample(ks[-1], n)
        ctx = torch.cat(demo + [test["tokens"][:, :self.body_len + 1]],
                        dim=1)
        slot = k_shots * (self.body_len + 2) + self.body_len
        return _to({"tokens": ctx, "cls": test["cls"], "slot": slot}, device)

    def eval_icl(self, cfg, forward_logits, params, key, k_shots: int = 4,
                 n: int = 256, device="cpu") -> float:
        batch = self.icl_batch(key, n, k_shots, device)
        logits = forward_logits(params, batch)
        return self._accuracy(logits[:, batch["slot"], :], batch["cls"])

    def _accuracy(self, slot_logits: torch.Tensor, cls: torch.Tensor) -> float:
        words = self.label_word(torch.arange(self.n_classes)).to(
            slot_logits.device)
        pred = torch.argmax(slot_logits[:, words], dim=-1)
        return float(torch.mean((pred == cls.to(pred.device)).to(
            torch.float32)))


# --------------------------------------------------------------------------- #
# Synthetic span extraction (SQuAD-F1 proxy, paper Table 3)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class SpanExtraction:
    """Copy task: the answer is a span of the context marked by delimiters;
    gold output = the span tokens (JAX's task and batches, bit for bit)."""
    vocab: int = 256
    ctx_len: int = 24
    span_len: int = 4
    seed: int = 0

    @property
    def seq_len(self) -> int:
        return self.ctx_len + 2 + self.span_len

    def sample(self, key, n: int, device="cpu") -> dict:
        kc, kp = split(key)
        ctx = randint(kc, (n, self.ctx_len), 32, self.vocab)
        start = randint(kp, (n,), 1, self.ctx_len - self.span_len - 1)
        idx = torch.arange(self.ctx_len)[None]
        st = start[:, None]
        in_span = (idx >= st) & (idx < st + self.span_len)
        gold = torch.gather(ctx, 1, st + torch.arange(self.span_len)[None])
        marked = torch.where((idx == st - 1) | (idx == st + self.span_len),
                             torch.full_like(ctx, 7), ctx)
        sep = torch.full((n, 2), 9, dtype=torch.int64)
        tokens = torch.cat([marked, sep, gold], dim=1).to(torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.zeros((n, self.seq_len), dtype=torch.float32)
        mask[:, self.ctx_len + 1:-1] = 1.0
        return _to({"tokens": tokens, "labels": labels, "loss_mask": mask,
                    "gold_ids": gold.to(torch.int32),
                    "answer_start": self.ctx_len + 2, "in_span": in_span},
                   device)

    def batch_for_step(self, step: int, batch: int, device="cpu") -> dict:
        return self.sample(fold_in(prng_key(self.seed), step), batch, device)
