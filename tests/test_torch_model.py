"""Port parity of the dense model: ``Bundle.loss_fn`` / ``prefill_fn`` /
``chunk_prefill_fn`` / ``decode_fn`` on the qwen2-0.5b smoke config in f32,
JAX and the port given the same weights and inputs, for every attention
impl (``pallas_flash`` reaches the Pallas kernel in interpret mode on the
JAX side and K2's plain version here).  atol 1e-4: both frameworks sum f32
matmuls in their own order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro_torch import convert
from repro_torch.models import all_archs, bundle

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

IMPLS = ["xla", "chunked", "pallas_flash"]
ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    cfg = jax_archs()["qwen2-0.5b"].smoke_cfg
    return jax.tree.map(np.asarray, jax_bundle(cfg).init(jax.random.PRNGKey(0)))


def _pair(impl):
    jcfg = jax_archs()["qwen2-0.5b"].smoke_cfg.replace(attention_impl=impl,
                                                       attention_chunk=16)
    tcfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(attention_impl=impl,
                                                       attention_chunk=16)
    return jax_bundle(jcfg), bundle(tcfg)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL,
                               rtol=0)


def _cache(rng, L, B, cap, KV, hd, plens):
    k = rng.standard_normal((L, B, cap, KV, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, cap, KV, hd)).astype(np.float32)
    pos = np.full((L, B, cap), -1, np.int32)
    for b, n in enumerate(plens):
        pos[:, b, :n] = np.arange(n)
    return k, v, pos


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_logits_match_jax(weights, impl):
    jb, tb = _pair(impl)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 24)).astype(np.int32),
             "loss_mask": (rng.random((2, 24)) > 0.2).astype(np.float32)}
    jl = jb.loss_fn()(jax.tree.map(jnp.asarray, weights),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    tl = tb.loss_fn()(convert.params_from_jax(weights),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) < ATOL


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax(weights, impl):
    jb, tb = _pair(impl)
    toks = np.random.default_rng(1).integers(0, 256, (2, 20)).astype(np.int32)
    jl, jc = jb.prefill_fn()(jax.tree.map(jnp.asarray, weights),
                             {"tokens": jnp.asarray(toks)})
    tl, tc = tb.prefill_fn()(convert.params_from_jax(weights),
                             {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    _close(tc["k"][:, :, :20], jc["k"][:, :, :20])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("prefix", ["cold", "warm"])
def test_chunk_prefill_matches_jax(weights, impl, prefix):
    """cold: no cached prefix, Sq == Sk (the K2 route under pallas_flash);
    warm: per-request prefixes of 16 and 0 tokens resumed from the cache."""
    jb, tb = _pair(impl)
    cfg = tb.cfg
    rng = np.random.default_rng(2)
    S = 16
    plens = [0, 0] if prefix == "cold" else [16, 0]
    pcap = 0 if prefix == "cold" else 32
    k, v, pos = _cache(rng, cfg.n_layers, 2, pcap + S, cfg.kv_heads, cfg.hd,
                       plens)
    toks = rng.integers(0, 256, (2, S)).astype(np.int32)
    jl, jc = jb.chunk_prefill_fn()(
        jax.tree.map(jnp.asarray, weights),
        {"tokens": jnp.asarray(toks), "cache_pos": jnp.asarray(plens, jnp.int32),
         "cache": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                   "pos": jnp.asarray(pos)}})
    tl, tc = tb.chunk_prefill_fn()(
        convert.params_from_jax(weights),
        {"tokens": torch.from_numpy(toks),
         "cache_pos": torch.tensor(plens),
         "cache": {"k": torch.from_numpy(k.copy()),
                   "v": torch.from_numpy(v.copy()),
                   "pos": torch.from_numpy(pos.copy())}})
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_jax(weights, impl):
    jb, tb = _pair(impl)
    cfg = tb.cfg
    rng = np.random.default_rng(3)
    valid = [5, 17, 0]
    k, v, pos = _cache(rng, cfg.n_layers, 3, 32, cfg.kv_heads, cfg.hd, valid)
    toks = rng.integers(0, 256, (3, 1)).astype(np.int32)
    jl, jc = jb.decode_fn()(
        jax.tree.map(jnp.asarray, weights),
        {"token": jnp.asarray(toks), "cache_pos": jnp.asarray(valid, jnp.int32),
         "cache": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                   "pos": jnp.asarray(pos)}})
    tl, tc = tb.decode_fn()(
        convert.params_from_jax(weights),
        {"token": torch.from_numpy(toks), "cache_pos": torch.tensor(valid),
         "cache": {"k": torch.from_numpy(k.copy()),
                   "v": torch.from_numpy(v.copy()),
                   "pos": torch.from_numpy(pos.copy())}})
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
