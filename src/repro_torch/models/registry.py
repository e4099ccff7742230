"""Architecture registry — the port of ``repro.models.registry`` for the
ported families, dense, moe and ssm: ``Bundle`` gives ``init`` /
``loss_fn`` / ``train_logits_fn`` / ``prefill_fn`` / ``chunk_prefill_fn`` /
``decode_fn`` with the JAX signatures (``vmap`` becomes a batch dimension
written out).

  ``dense``  decoder-only transformer — models/transformer.py
  ``moe``    the transformer whose FFN is a GShard capacity-based top-k
             mixture of experts — models/moe.py; the grouped
             ``cfg.expert_groups`` layout for expert-wise ZO selection
  ``ssm``    RWKV6 "Finch" recurrence — models/rwkv6.py; scan modes
             ``cfg.scan_mode`` ∈ {"chunk" (K11), "fused_recurrent"}

``Bundle.loss_fn(objective)`` takes ``OBJECTIVES``: token cross-entropy
(plus the moe load-balancing term) and the paper's non-differentiable
accuracy and F1 (``core/nondiff``).  hybrid and encdec come with the
other-families slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.core import nondiff
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import rwkv6, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import expert_group_count

#: Registry-selectable training objectives (``Bundle.loss_fn(objective=...)``):
#: "ce" is token cross-entropy; "accuracy" / "f1" are the paper §3.3
#: non-differentiable objectives (argmax-based, zero gradient a.e. — only ZO
#: optimizers make progress on them; core/nondiff.py).
OBJECTIVES = ("ce", "accuracy", "f1")

#: Representative registry arch per ported family — the ``--model-family``
#: alias of ``launch/train`` (JAX's table also names hybrid and encdec).
FAMILY_ARCHS = {
    "dense": "qwen2-0.5b",
    "moe": "mixtral-8x7b",
    "ssm": "rwkv6-3b",
}


def default_selection(cfg: ModelConfig) -> str:
    """Per-family default ``repro_torch.select`` spec, the value behind
    ``--select auto``: ``moe_experts(G)`` for moe (the router frozen, expert
    group t % G perturbed at step t; G = ``expert_group_count``, 1 for the
    single-leaf layout), ``full`` for every other family."""
    if cfg.n_experts:
        return f"moe_experts({expert_group_count(cfg)})"
    return "full"

_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class Arch:
    """A registered architecture: production config + reduced smoke config."""
    arch_id: str
    cfg: ModelConfig
    smoke_cfg: ModelConfig
    notes: str = ""


def register(arch_id: str, cfg: ModelConfig, smoke_cfg: ModelConfig,
             notes: str = "") -> Arch:
    arch = Arch(arch_id, cfg, smoke_cfg, notes)
    _REGISTRY[arch_id] = arch
    return arch


def get(arch_id: str) -> Arch:
    if arch_id not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers everything)
    return _REGISTRY[arch_id]


def all_archs() -> dict:
    import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)


class Bundle:
    """Callable surface for one ``ModelConfig`` of a ported family."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILY_ARCHS:
            raise NotImplementedError(
                f"family {cfg.family!r} is ported with the other-families "
                f"slice (hybrid, encdec); the port carries "
                f"{', '.join(FAMILY_ARCHS)}")
        self.cfg = cfg

    # ---- init ---------------------------------------------------------- #
    def init(self, seed: Union[int, torch.Generator] = 0,
             device: DeviceSpec = None) -> dict:
        """Random params from a ``torch.Generator`` (an int seeds a fresh
        one on ``device``).  JAX's threefry-normal init is not reproduced:
        give both frameworks the same weights through ``repro_torch.convert``."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(int(seed))
        if self.cfg.family == "ssm":
            return rwkv6.init_params(self.cfg, gen)
        return transformer.init_params(self.cfg, gen)

    def default_selection(self) -> str:
        """The config's ``default_selection``."""
        return default_selection(self.cfg)

    # ---- training objectives ---------------------------------------------- #
    def train_logits_fn(self) -> Callable:
        """(params, batch) -> teacher-forcing logits (B, S, padded_vocab)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            def logits_fn(params, batch):
                return rwkv6.forward(cfg, params, tokens=batch["tokens"])[0]
        else:
            def logits_fn(params, batch):
                return transformer.forward(cfg, params,
                                           tokens=batch.get("tokens"),
                                           embeds=batch.get("embeds")).logits
        return logits_fn

    def loss_fn(self, objective: str = "ce") -> Callable:
        """(params, batch) -> scalar minimization objective, ``objective``
        one of ``OBJECTIVES``:

        * ``"ce"`` — masked token cross-entropy, the default;
        * ``"accuracy"`` — −accuracy of argmax predictions over
          ``batch["labels"]`` (under ``loss_mask``).  Logits are sliced to
          the true ``vocab_size``, so padded vocab columns never win the
          argmax;
        * ``"f1"`` — −token F1 between the per-position argmax predictions
          and the labels; masked-out positions become −1 on both sides, so
          a real id-0 token still counts.
        """
        cfg = self.cfg
        if objective == "ce":
            if cfg.family == "ssm":
                def loss(params, batch):
                    logits, _ = rwkv6.forward(cfg, params,
                                              tokens=batch["tokens"])
                    return transformer.lm_loss(cfg, logits, batch["labels"],
                                               batch.get("loss_mask"))
                return loss
            return transformer.train_loss_fn(cfg)
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"available: {OBJECTIVES}")
        logits_fn = self.train_logits_fn()
        V = cfg.vocab_size
        if objective == "accuracy":
            def loss(params, batch):
                logits = logits_fn(params, batch)[..., :V]
                return nondiff.negative_accuracy(logits, batch["labels"],
                                                 batch.get("loss_mask"))
            return loss

        def loss(params, batch):      # objective == "f1"
            logits = logits_fn(params, batch)[..., :V]
            pred = torch.argmax(logits, dim=-1)
            gold = batch["labels"].to(pred.dtype)
            mask = batch.get("loss_mask")
            if mask is not None:
                keep = mask > 0
                pred = torch.where(keep, pred, -1)
                gold = torch.where(keep, gold, -1)
            return nondiff.negative_f1(pred, gold, pad_id=-1)
        return loss

    # ---- serving ---------------------------------------------------------- #
    def prefill_fn(self) -> Callable:
        """(params, {"tokens": (B,S)} or {"embeds": (B,S,d)}) -> (last
        logits (B,1,V), cache) — for ssm the recurrent state after the
        prompt in place of a cache."""
        cfg = self.cfg

        def prefill(params, batch):
            tokens = batch.get("tokens")
            if cfg.family == "ssm":
                logits, state = rwkv6.forward(
                    cfg, params, tokens=tokens,
                    state=rwkv6.init_rwkv_state(cfg, tokens.shape[0],
                                                tokens.device))
                return logits[:, -1:], state
            embeds = batch.get("embeds")      # the vision_stub frontend
            x = tokens if tokens is not None else embeds
            B, S = x.shape[:2]
            cache = attn_lib.init_cache(cfg, B, max(S, cfg.max_seq),
                                        cfg.param_dtype, x.device)
            r = transformer.forward(cfg, params, tokens=tokens, embeds=embeds,
                                    cache=cache, cache_pos=None)
            return r.logits[:, -1:], r.cache

        return prefill

    def chunk_prefill_fn(self) -> Callable:
        """Suffix prefill against pre-populated per-request caches — the
        paged engine's batched-prefill primitive (dense and moe without a
        sliding window).

        batch: ``"tokens"`` (B,S) right-padded suffixes; ``"cache"`` stacked
        (L,B,cap,KV,hd) with per-request ``"pos"`` (L,B,cap) (rows [0,plen_b)
        hold request b's prefix KV, the rest −1); ``"cache_pos"`` (B,) the
        prefix lengths.  Request b runs at positions plen_b + arange(S) and
        writes its suffix KV at rows [plen_b, plen_b+S) — JAX vmaps the
        single-request forward over b; here b is the batch axis (a moe
        group never spans two requests: M = min(moe_group_size, S) tokens
        of one row, padding included, as in each vmapped call).  Returns
        (logits (B,S,V), cache), the cache updated in place."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe") or cfg.sliding_window != 0:
            raise NotImplementedError(
                f"chunk_prefill_fn: family={cfg.family!r} with "
                f"sliding_window={cfg.sliding_window} has no "
                "absolute-position KV rows to resume from; the serving "
                "engine's legacy whole-prompt prefill handles it")

        def chunk_prefill(params, batch):
            tokens, plens = batch["tokens"], batch["cache_pos"]
            S = tokens.shape[1]
            positions = (plens.to(torch.int32)[:, None]
                         + torch.arange(S, dtype=torch.int32,
                                        device=tokens.device)[None])
            r = transformer.forward(cfg, params, tokens=tokens,
                                    positions=positions, cache=batch["cache"],
                                    cache_pos=plens)
            return r.logits, r.cache

        return chunk_prefill

    def decode_fn(self) -> Callable:
        """(params, {"token" (B,1), "cache", "cache_pos"}) -> (logits,
        cache): ``cache_pos`` (B,) decodes every row at its own position
        (continuous batching); a scalar decodes the batch in lockstep; a
        vision_stub model may take ``"embed"`` (B,1,d) in place of the
        token.  For
        ssm the batch carries ``"state"`` in place of a cache, and the new
        state comes back."""
        cfg = self.cfg

        def decode(params, batch):
            if cfg.family == "ssm":
                return rwkv6.forward(cfg, params, tokens=batch["token"],
                                     state=batch["state"])
            pos = batch["cache_pos"]
            token, embed = batch.get("token"), batch.get("embed")
            if isinstance(pos, torch.Tensor) and pos.dim() == 1:
                positions = pos[:, None].to(torch.int32)
            else:
                positions = torch.tensor(
                    [int(pos)], dtype=torch.int32,
                    device=(token if token is not None else embed).device)
            r = transformer.forward(cfg, params, tokens=token, embeds=embed,
                                    positions=positions, cache=batch["cache"],
                                    cache_pos=pos)
            return r.logits, r.cache

        return decode


def bundle(cfg_or_arch) -> Bundle:
    cfg = cfg_or_arch.cfg if isinstance(cfg_or_arch, Arch) else cfg_or_arch
    return Bundle(cfg)

