"""Unified model configuration — the port of ``repro.models.config``.

Every field name and default is the JAX package's, so a config moves
between the two unchanged; ``dtype`` stays a string and ``param_dtype``
returns the torch dtype.
"""
from __future__ import annotations

import dataclasses

import torch


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0              # 0 -> = n_heads (MHA)
    head_dim: int = 0                # 0 -> d_model // n_heads
    activation: str = "silu"         # silu | gelu | sq_relu | relu
    gated_ffn: bool = True           # SwiGLU-style (w1*act(w3))·w2
    qkv_bias: bool = False
    causal: bool = True              # False -> bidirectional (masked LM)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_group_size: int = 512
    capacity_factor: float = 1.25
    expert_groups: int = 0

    # attention extent
    sliding_window: int = 0          # 0 = global causal

    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    scan_chunk: int = 32             # chunk length of the SSD / WKV forms
    # "chunk" = chunked-matmul form (K11 for rwkv6); "fused_recurrent" =
    # the exact per-token recurrence (the oracle)
    scan_mode: str = "chunk"

    # encoder-decoder
    encoder_layers: int = 0
    cross_attention: bool = False

    frontend: str = "none"           # none | vision_stub | audio_stub

    max_seq: int = 8192
    dtype: str = "float32"
    remat: bool = False
    scan_layers: bool = True
    attention_impl: str = "xla"      # xla | chunked | pallas_flash
    attention_chunk: int = 1024      # kv-block for the chunked/flash paths
    attention_q_chunk: int = 0       # q-block tiling (0 = off)

    vocab_pad_multiple: int = 128

    # sharding knobs of the JAX package (kept for field parity; unused here)
    shard_heads_fallback: str = "compiler"
    sequence_parallel: bool = False
    attention_cp: bool = False

    # ---------------------------------------------------------------- #
    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k cell?  ssm: O(1) state; hybrid:
        a window-bounded cache and O(1) SSM state; full attention: no."""
        return self.family == "ssm" or (self.family == "hybrid"
                                        and self.sliding_window > 0)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), JAX's
        formula for every family.  It is an estimate, not the tree's
        element count: for hybrid it counts ``d·sh/4`` for the dt
        projection, whose leaf is (d, ssm_heads), and no norms or ``mix``
        (hymba-1.5b: 1 330 841 600 against the tree's 1 433 039 264)."""
        d, ff, V = self.d_model, self.d_ff, self.padded_vocab
        hd, H, KV = self.hd, self.n_heads, self.kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # RWKV6 block accounting
            tm = d * (H * hd) * 4 + d * (H * hd)        # r,k,v,g,o (o square)
            tm += 2 * (d * 64 + 64 * d)                  # decay/ddlerp loras (approx)
            cm = d * ff + ff * d
            return emb + self.n_layers * (tm + cm)
        att = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        if self.qkv_bias:
            att += H * hd + 2 * KV * hd
        ffn = (3 if self.gated_ffn else 2) * d * ff
        if self.n_experts:
            ffn = ffn * self.n_experts + d * self.n_experts   # + router
        block = att + ffn
        if self.family == "hybrid":
            sh = self.ssm_heads * self.hd
            block += (d * (2 * sh) + d * sh // 4 + 2 * sh * self.ssm_state
                      + sh)                                    # ssm projs
        layers = self.n_layers * block
        if self.family == "encdec":
            enc_block = (d * (H * hd) * 2 + 2 * d * (KV * hd)
                         + (2 if not self.gated_ffn else 3) * d * ff)
            layers += self.encoder_layers * enc_block
            layers += self.n_layers * (d * (H * hd) + 2 * d * (KV * hd)
                                       + (H * hd) * d)         # cross-attn
        return emb + layers

    def n_active_params(self) -> int:
        """Active (per-token) parameters — MoE counts top_k of n_experts."""
        if not self.n_experts:
            return self.n_params()
        dense_ffn = (3 if self.gated_ffn else 2) * self.d_model * self.d_ff
        return self.n_params() - self.n_layers * dense_ffn * (
            self.n_experts - self.top_k)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")
ALL_CELLS = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def cells_for(cfg: ModelConfig) -> list:
    """The runnable shape cells of an architecture: long_500k only for the
    sub-quadratic ones."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        cells.append(LONG_500K)
    return cells
