"""Architecture registry — the port of ``repro.models.registry``:
``Bundle`` gives ``init`` / ``loss_fn`` / ``train_logits_fn`` /
``prefill_fn`` / ``chunk_prefill_fn`` / ``decode_fn`` / ``input_specs`` /
``make_batch`` with the JAX signatures (``vmap`` becomes a batch dimension
written out) for every family:

  ``dense``   decoder-only transformer (an optional vision frontend through
              precomputed ``embeds``) — models/transformer.py
  ``moe``     the transformer whose FFN is a GShard capacity-based top-k
              mixture of experts — models/moe.py; the grouped
              ``cfg.expert_groups`` layout for expert-wise ZO selection
  ``ssm``     RWKV6 "Finch" recurrence — models/rwkv6.py; scan modes
              ``cfg.scan_mode`` ∈ {"chunk" (K11), "fused_recurrent"}
  ``hybrid``  Hymba-style parallel attention + mamba-2 SSD heads —
              models/transformer.py + models/ssm.py (the same scan modes)
  ``encdec``  Whisper-style encoder-decoder with cross-attention —
              models/encdec.py, on stub frame embeddings

``Bundle.loss_fn(objective)`` takes ``OBJECTIVES``: token cross-entropy
(plus the moe load-balancing term) and the paper's non-differentiable
accuracy and F1 (``core/nondiff``).  ``input_specs(cell)`` gives the
inputs of a shape cell as tensors on the ``meta`` device (shapes and
dtypes, nothing allocated), and ``make_batch`` JAX's smoke batch bit for
bit (threefry ``split`` / ``randint`` and the stub normal).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.core import nondiff
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.data.synthetic import randint, split
from repro_torch.models import attention as attn_lib
from repro_torch.models import encdec, rwkv6, transformer
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import MetaGen, placed_like
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.frontends import stub_normal
from repro_torch.models.moe import expert_group_count
from repro_torch.perturb.stream import Key

#: Registry-selectable training objectives (``Bundle.loss_fn(objective=...)``):
#: "ce" is token cross-entropy; "accuracy" / "f1" are the paper §3.3
#: non-differentiable objectives (argmax-based, zero gradient a.e. — only ZO
#: optimizers make progress on them; core/nondiff.py).
OBJECTIVES = ("ce", "accuracy", "f1")

#: Representative registry arch per family — the ``--model-family`` alias
#: of ``launch/train`` and the family axis of the conformance tests.
FAMILY_ARCHS = {
    "dense": "qwen2-0.5b",
    "moe": "mixtral-8x7b",
    "ssm": "rwkv6-3b",
    "hybrid": "hymba-1.5b",
    "encdec": "whisper-large-v3",
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


def family_arch(family: str, smoke: bool = True) -> ModelConfig:
    """The representative config of a family (``FAMILY_ARCHS``);
    ``smoke=True`` gives its CPU-scale reduction."""
    if family not in FAMILY_ARCHS:
        raise ValueError(f"unknown family {family!r}; "
                         f"available: {sorted(FAMILY_ARCHS)}")
    arch = get(FAMILY_ARCHS[family])
    return arch.smoke_cfg if smoke else arch.cfg


class Bundle:
    """Callable surface for one ``ModelConfig``, the family dispatch
    inside."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILY_ARCHS:
            raise ValueError(f"unknown family {cfg.family!r}; the registry "
                             f"has {', '.join(FAMILY_ARCHS)}")
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
        return self._init_params(gen)

    def param_shapes(self) -> dict:
        """The parameter tree as tensors on the ``meta`` device — JAX's
        ``jax.eval_shape(init)``, leaf for leaf (paths, shapes, dtypes):
        the init code runs with every draw skipped, so nothing is allocated
        and no generator is drawn from, at any config's full size."""
        return self._init_params(MetaGen())

    def _init_params(self, gen) -> dict:
        if self.cfg.family == "ssm":
            return rwkv6.init_params(self.cfg, gen)
        if self.cfg.family == "encdec":
            return encdec.init_params(self.cfg, gen)
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
        elif cfg.family == "encdec":
            def logits_fn(params, batch):
                return encdec.forward_train(cfg, params, batch["frames"],
                                            batch["tokens"])
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

        Each loss but the moe family's ``"ce"`` carries ``parts(params,
        batch)``: a (2,) f32 tensor ``[s, w]`` whose sums over row shards
        of a batch give the whole batch's loss as ``s / max(w, 1)`` (what
        ``distributed.collectives.data_parallel_loss`` all-reduces).
        """
        cfg = self.cfg
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"available: {OBJECTIVES}")
        if objective == "ce" and cfg.family not in ("ssm", "encdec"):
            return transformer.train_loss_fn(cfg)
        logits_fn = self.train_logits_fn()
        V = cfg.vocab_size
        if objective == "ce":
            def loss(params, batch):
                return transformer.lm_loss(cfg, logits_fn(params, batch),
                                           batch["labels"],
                                           batch.get("loss_mask"))

            def parts(params, batch):
                return transformer.lm_loss_parts(
                    cfg, logits_fn(params, batch), batch["labels"],
                    batch.get("loss_mask"))
        elif objective == "accuracy":
            def loss(params, batch):
                logits = logits_fn(params, batch)[..., :V]
                return nondiff.negative_accuracy(logits, batch["labels"],
                                                 batch.get("loss_mask"))

            def parts(params, batch):
                logits = logits_fn(params, batch)[..., :V]
                return nondiff.negative_accuracy_parts(
                    logits, batch["labels"], batch.get("loss_mask"))
        else:                         # objective == "f1"
            def f1_ids(params, batch):
                pred = torch.argmax(logits_fn(params, batch)[..., :V], dim=-1)
                gold = batch["labels"].to(pred.dtype)
                mask = batch.get("loss_mask")
                if mask is not None:
                    keep = mask > 0
                    pred = torch.where(keep, pred, -1)
                    gold = torch.where(keep, gold, -1)
                return pred, gold

            def loss(params, batch):
                return nondiff.negative_f1(*f1_ids(params, batch), pad_id=-1)

            def parts(params, batch):
                return nondiff.negative_f1_parts(*f1_ids(params, batch),
                                                 pad_id=-1)
        loss.parts = parts
        return loss

    # ---- serving ---------------------------------------------------------- #
    def prefill_fn(self) -> Callable:
        """(params, {"tokens": (B,S)} or {"embeds": (B,S,d)}) -> (last
        logits (B,1,V), cache) — for ssm the recurrent state after the
        prompt in place of a cache, for hybrid (cache, SSM state), for
        encdec (cache, cross K/V) from {"frames", "tokens"}.  The cache
        holds ``max(S, cfg.max_seq)`` rows, a ring capped at the window
        for a sliding-window model (encdec: ``cfg.max_seq`` rows)."""
        cfg = self.cfg

        def prefill(params, batch):
            tokens = batch.get("tokens")
            if cfg.family == "ssm":
                logits, state = rwkv6.forward(
                    cfg, params, tokens=tokens,
                    state=placed_like(tokens, rwkv6.init_rwkv_state(
                        cfg, tokens.shape[0], tokens.device)))
                return logits[:, -1:], state
            if cfg.family == "encdec":
                frames = batch["frames"]
                enc_out = encdec.encode(cfg, params, frames)
                cross_kv = encdec.precompute_cross_kv(cfg, params, enc_out)
                cache = placed_like(frames, attn_lib.init_cache(
                    cfg, frames.shape[0], cfg.max_seq, cfg.param_dtype,
                    frames.device))
                r = encdec.decode(cfg, params, tokens, cross_kv, cache=cache,
                                  cache_pos=0)
                return r.logits[:, -1:], (r.cache, cross_kv)
            embeds = batch.get("embeds")      # the vision_stub frontend
            x = tokens if tokens is not None else embeds
            B, S = x.shape[:2]
            cache = placed_like(x, attn_lib.init_cache(
                cfg, B, max(S, cfg.max_seq), cfg.param_dtype, x.device))
            state = (placed_like(x, ssm_lib.init_ssm_state(cfg, B,
                                                           device=x.device))
                     if cfg.family == "hybrid" else None)
            # cache_pos None: the prefill write (ring-rolled for a window)
            r = transformer.forward(cfg, params, tokens=tokens, embeds=embeds,
                                    cache=cache, cache_pos=None,
                                    ssm_state=state)
            if cfg.family == "hybrid":
                return r.logits[:, -1:], (r.cache, r.ssm_state)
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
        token.  For ssm the batch carries ``"state"`` in place of a cache
        and the new state comes back; hybrid carries both and returns
        (logits, (cache, state)); encdec carries ``"cross_kv"`` too."""
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
            if cfg.family == "encdec":
                r = encdec.decode(cfg, params, token, batch["cross_kv"],
                                  positions=positions, cache=batch["cache"],
                                  cache_pos=pos)
                return r.logits, r.cache
            state = batch.get("state") if cfg.family == "hybrid" else None
            r = transformer.forward(cfg, params, tokens=token, embeds=embed,
                                    positions=positions, cache=batch["cache"],
                                    cache_pos=pos, ssm_state=state)
            if cfg.family == "hybrid":
                return r.logits, (r.cache, r.ssm_state)
            return r.logits, r.cache

        return decode

    # ---- input specs (meta tensors: shapes and dtypes, no allocation) -- #
    def input_specs(self, cell: ShapeCell) -> dict:
        """The inputs of one shape cell's step function as tensors on the
        ``meta`` device — JAX's ``ShapeDtypeStruct`` tree, leaf for leaf."""
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len
        i32, f32, dt = torch.int32, torch.float32, cfg.param_dtype

        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        def tok(shape):
            return sds(shape, i32)

        if cell.kind == "train":
            if cfg.family == "encdec":
                return {"frames": sds((B, S, cfg.d_model), dt),
                        "tokens": tok((B, S)), "labels": tok((B, S)),
                        "loss_mask": sds((B, S), f32)}
            if cfg.frontend == "vision_stub":
                return {"embeds": sds((B, S, cfg.d_model), dt),
                        "labels": tok((B, S)), "loss_mask": sds((B, S), f32)}
            return {"tokens": tok((B, S)), "labels": tok((B, S)),
                    "loss_mask": sds((B, S), f32)}

        if cell.kind == "prefill":
            if cfg.family == "encdec":
                return {"frames": sds((B, S, cfg.d_model), dt),
                        "tokens": tok((B, 1))}
            if cfg.frontend == "vision_stub":
                return {"embeds": sds((B, S, cfg.d_model), dt)}
            return {"tokens": tok((B, S))}

        # decode: one new token against a seq_len-long context
        if cfg.family == "ssm":
            return {"token": tok((B, 1)),
                    "state": rwkv6.init_rwkv_state(cfg, B, "meta"),
                    "cache_pos": sds((), i32)}
        specs = {"token": tok((B, 1)), "cache_pos": sds((), i32),
                 "cache": attn_lib.init_cache(cfg, B, S, dt, "meta")}
        if cfg.family == "hybrid":
            specs["state"] = ssm_lib.init_ssm_state(cfg, B, device="meta")
        if cfg.family == "encdec":
            # Whisper's encoder extent for the decode cells: 1500 frames
            # (30 s of audio), padded to 1504; the long axis is the cache
            s_enc = 1504
            shape = (cfg.n_layers, B, s_enc, cfg.kv_heads, cfg.hd)
            specs["cross_kv"] = {"k": sds(shape, dt), "v": sds(shape, dt)}
        return specs

    # ---- smoke batch (JAX's, bit for bit) ------------------------------- #
    def make_batch(self, key: Key, batch: int, seq: int,
                   device: DeviceSpec = None) -> dict:
        """JAX's ``make_batch``: ``split(key, 3)``; frames (encdec) or
        embeds (vision_stub) the stub normal of the third key in the param
        dtype, tokens ``randint`` of the first, labels of the second (int32),
        a loss mask of ones."""
        cfg = self.cfg
        dev = resolve_device(device)
        k1, k2, k3 = split(key, 3)
        shape = (batch, seq)
        out: dict = {}
        if cfg.family == "encdec":
            out["frames"] = stub_normal(k3, shape + (cfg.d_model,),
                                        cfg.param_dtype, dev)
            out["tokens"] = randint(k1, shape, 0, cfg.vocab_size)
        elif cfg.frontend == "vision_stub":
            out["embeds"] = stub_normal(k3, shape + (cfg.d_model,),
                                        cfg.param_dtype, dev)
        else:
            out["tokens"] = randint(k1, shape, 0, cfg.vocab_size)
        out["labels"] = randint(k2, shape, 0, cfg.vocab_size)
        out["loss_mask"] = torch.ones(shape, dtype=torch.float32)
        return {k: v.to(device=dev, dtype=torch.int32)
                if k in ("tokens", "labels") else v.to(dev)
                for k, v in out.items()}


def bundle(cfg_or_arch) -> Bundle:
    cfg = cfg_or_arch.cfg if isinstance(cfg_or_arch, Arch) else cfg_or_arch
    return Bundle(cfg)

