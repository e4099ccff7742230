"""Port parity of the paper's dense archs, the other dense configs and the
moe configs:

* every ported config (``repro_torch.configs``) has JAX's field values,
  notes, ``n_params`` and ``n_active_params``, full and ``SMOKE``; the arch
  lists ``ASSIGNED_ARCHS`` / ``PAPER_ARCHS`` are JAX's;
* at each ``SMOKE`` config (opt-13b/30b/66b, roberta-large, qwen2-7b,
  yi-6b, nemotron-4-340b, granite-moe-3b-a800m, mixtral-8x7b;
  phi-3-vision through ``embeds``) ``loss_fn``,
  ``prefill_fn`` and ``decode_fn`` equal JAX's in f32 within atol 1e-4
  (both frameworks sum f32 matmuls in their own order), under ``xla`` and
  ``pallas_flash`` (JAX's Pallas kernel in interpret mode, K2's plain
  version here), with JAX's weights through ``repro_torch.convert``;
* roberta-large (``causal=False``) under ``pallas_flash`` never reaches K2:
  JAX's routing rule sends it to the chunked path;
* the initializer draws one layer's slice of a stacked leaf at a time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import PAPER_ARCHS as JAX_PAPER
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro_torch import convert
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.models import all_archs, bundle
from repro_torch.models import attention as attn_lib

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

ATOL = 1e-4
PORTED = ["granite-moe-3b-a800m", "hymba-1.5b", "mixtral-8x7b",
          "nemotron-4-340b", "opt-13b", "opt-30b", "opt-66b",
          "phi-3-vision-4.2b", "qwen2-0.5b", "qwen2-7b", "roberta-large",
          "rwkv6-3b", "whisper-large-v3", "yi-6b"]
NEW_DENSE = ["opt-13b", "opt-30b", "opt-66b", "roberta-large", "qwen2-7b",
             "yi-6b", "nemotron-4-340b", "phi-3-vision-4.2b"]
#: the moe family (``models/moe.py``), held as the dense archs are; their
#: routing margins at these inputs exceed the tolerance (test_torch_moe.py)
MOE = ["granite-moe-3b-a800m", "mixtral-8x7b"]
IMPLS = ["xla", "pallas_flash"]
B, S = 2, 20


def test_registry_holds_every_ported_config_and_jax_lists():
    assert sorted(all_archs()) == PORTED
    assert set(PORTED) == set(jax_archs())
    assert ASSIGNED_ARCHS == JAX_ASSIGNED and PAPER_ARCHS == JAX_PAPER


@pytest.mark.parametrize("arch", PORTED)
def test_config_fields_and_counts_equal_jax(arch):
    t, j = all_archs()[arch], jax_archs()[arch]
    assert t.notes == j.notes
    for tc, jc in ((t.cfg, j.cfg), (t.smoke_cfg, j.smoke_cfg)):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        assert (tc.padded_vocab, tc.hd, tc.kv_heads) == \
            (jc.padded_vocab, jc.hd, jc.kv_heads)


def test_opt_sizes():
    """The paper's sizes (the card's phases print them): OPT-30b is
    30 316 167 168 parameters by the analytic count, 56.47 GiB of bf16;
    OPT-66b's 123.2 GiB does not fit one 80 GB card."""
    n30 = all_archs()["opt-30b"].cfg.n_params()
    assert n30 == 30_316_167_168 and round(2 * n30 / 2**30, 2) == 56.47
    assert round(2 * all_archs()["opt-66b"].cfg.n_params() / 2**30, 1) == 123.2


def _pair(arch, impl):
    jcfg = jax_archs()[arch].smoke_cfg.replace(attention_impl=impl,
                                               attention_chunk=16)
    tcfg = all_archs()[arch].smoke_cfg.replace(attention_impl=impl,
                                               attention_chunk=16)
    w = jax.tree.map(np.asarray, jax_bundle(jcfg).init(jax.random.PRNGKey(0)))
    return jax_bundle(jcfg), bundle(tcfg), w


def _inputs(cfg, rng, S):
    """The model input: token ids, or for the vision_stub frontend the
    merged text + patch embeddings."""
    if cfg.frontend == "vision_stub":
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", NEW_DENSE + MOE)
def test_loss_matches_jax(arch, impl):
    jb, tb, w = _pair(arch, impl)
    cfg = tb.cfg
    rng = np.random.default_rng(0)
    x = _inputs(cfg, rng, S)
    key = "embeds" if cfg.frontend == "vision_stub" else "tokens"
    batch = {key: x,
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    jl = jb.loss_fn()(jax.tree.map(jnp.asarray, w),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    tl = tb.loss_fn()(convert.params_from_jax(w),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) < ATOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", NEW_DENSE + MOE)
def test_prefill_then_decode_match_jax(arch, impl):
    """A prefill of S positions, then one decode step at position S from
    each side's own cache (lockstep ``cache_pos``)."""
    jb, tb, w = _pair(arch, impl)
    cfg = tb.cfg
    rng = np.random.default_rng(1)
    vision = cfg.frontend == "vision_stub"
    x = _inputs(cfg, rng, S)
    nxt = _inputs(cfg, rng, 1)
    pkey, dkey = ("embeds", "embed") if vision else ("tokens", "token")
    jw, tw = jax.tree.map(jnp.asarray, w), convert.params_from_jax(w)
    jl, jc = jb.prefill_fn()(jw, {pkey: jnp.asarray(x)})
    tl, tc = tb.prefill_fn()(tw, {pkey: torch.from_numpy(x)})
    _close(tl, jl)
    _close(tc["k"][:, :, :S], jc["k"][:, :, :S])
    _close(tc["v"][:, :, :S], jc["v"][:, :, :S])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    jl, jc = jb.decode_fn()(jw, {dkey: jnp.asarray(nxt), "cache": jc,
                                 "cache_pos": jnp.int32(S)})
    tl, tc = tb.decode_fn()(tw, {dkey: torch.from_numpy(nxt), "cache": tc,
                                 "cache_pos": S})
    _close(tl, jl)
    _close(tc["k"][:, :, :S + 1], jc["k"][:, :, :S + 1])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_roberta_pallas_flash_never_reaches_k2(monkeypatch):
    """causal=False: the routing rule sends every attention call to the
    chunked path, so neither K2's wrapper nor its plain version runs."""
    def refuse(*a, **k):
        raise AssertionError("K2 reached under causal=False")

    monkeypatch.setattr(attn_lib, "flash_attention", refuse)
    monkeypatch.setattr(k2, "flash_attention", refuse)
    monkeypatch.setattr(k2, "flash_attention_plain", refuse)
    jb, tb, w = _pair("roberta-large", "pallas_flash")
    assert tb.cfg.causal is False
    tw = convert.params_from_jax(w)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 256, (B, S)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks,
             "loss_mask": torch.ones(B, S)}
    for objective in ("ce", "accuracy", "f1"):
        assert np.isfinite(float(tb.loss_fn(objective)(tw, batch)))
    _, cache = tb.prefill_fn()(tw, {"tokens": toks})
    tb.decode_fn()(tw, {"token": toks[:, :1], "cache": cache,
                        "cache_pos": S})


@pytest.mark.parametrize("arch", ["opt-30b", "roberta-large", "qwen2-0.5b",
                                  "rwkv6-3b"])
def test_init_draws_one_layer_slice_at_a_time(arch, monkeypatch):
    """Every ``torch.randn`` of the initializer draws one layer's slice of
    a stacked (3-D) leaf, or a whole leaf of at most 2 dimensions (the
    embedding, the head, a LoRA factor); the leaves are allocated in their
    final dtype (bf16 for the full configs, cast here at the smoke size)."""
    drawn = []
    real = torch.randn

    def spy(*shape, **kw):
        size = shape[0] if len(shape) == 1 and isinstance(
            shape[0], (tuple, list, torch.Size)) else shape
        drawn.append(tuple(size))
        return real(*shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    cfg = all_archs()[arch].smoke_cfg.replace(dtype="bfloat16")
    params = bundle(cfg).init(0, device="cpu")
    leaves = [p for p in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    allowed = {tuple(p.shape[1:]) if p.dim() == 3 else tuple(p.shape)
               for p in leaves}
    assert drawn and all(len(s) <= 2 for s in drawn)
    assert set(drawn) <= allowed
    stacked = [p for p in leaves if p.dim() == 3]
    # one draw per layer of each stacked leaf that is drawn at all
    n_layer_draws = sum(1 for s in drawn
                        if any(tuple(p.shape[1:]) == s for p in stacked))
    assert n_layer_draws >= cfg.n_layers
    assert all(p.dtype == torch.bfloat16 for p in leaves)
    # the layers of a stacked leaf are distinct draws
    w1 = stacked[0]
    assert not torch.equal(w1[0], w1[1])
