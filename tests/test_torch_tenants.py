"""The port's multi-tenant adapter serving (``repro_torch.serve.tenants``):
the mirror of ``tests/test_serve_tenants.py``'s non-slow tests and of
``tests/test_serve_paged.py::test_radix_scoped_per_adapter``, on JAX's tiny
config (2 layers, d 32, f32) with JAX's base weights carried across by
``convert``.

Each claim is bitwise where the design promises bitwise: a cached delta IS
the fresh replay (the ``xla`` stream and ``pallas``'s counter stream, the
plain K1 here); a compacted ledger materializes the full replay; the
byte-budgeted LRU evicts; a mixed-adapter decode emits token for token what
one single-slot engine per request emits, in one stacked decode call a
step; identity mismatches refuse (``LedgerHashMismatchError``, the
engine's guardrails).  Across frameworks (the rest in ``test_torch_tenants_parity.py``): a tenant
JAX trained on ``pallas-interpret`` materializes in the port, through the
plain K1, to JAX's LoRA tree bitwise and its merged leaves within
``MERGE_ATOL``."""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro_torch import convert
from repro_torch.core.trajectory import TrajectoryLedger, replay
from repro_torch.models.config import ModelConfig
from repro_torch.models.peft import merge_lora
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.tenants import (AdapterDelta, AdapterStore, DeltaCache,
                                       LedgerHashMismatchError, compact,
                                       composition_for_ledger, lora_runtime,
                                       make_lora_tenants, materialize,
                                       serve_load, synthetic_requests,
                                       tenant_name)
from repro_torch.serve.tenants.synth import lora_params0
from repro_torch.tree_utils import tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

BACKENDS = ["xla", "pallas"]
# W + (α/r)·A·B: JAX's and torch's f32 rank-2 products round differently
# at most in the last place of |W + Δ| ≲ 4 here (measured: equal)
MERGE_ATOL = 1e-6
TINY = dict(name="tenants-lm", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128, max_seq=64,
            dtype="float32")


@pytest.fixture(scope="module")
def base_setup():
    from repro.models.config import ModelConfig as JaxConfig
    jparams = jax.jit(jax_bundle(JaxConfig(**TINY)).init)(
        jax.random.PRNGKey(0))
    return ModelConfig(**TINY), convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def assert_trees_bitwise(a, b, msg=""):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, msg
        assert x.numpy().tobytes() == y.numpy().tobytes(), msg


def engine(cfg, params, **kw):
    return ServeEngine(cfg, params, device="cpu", **kw)


# --------------------------------------------------------------------------- #
# content_hash (the cache-key primitive)
# --------------------------------------------------------------------------- #
def test_content_hash_roundtrip_and_sensitivity():
    led = TrajectoryLedger(base_seed=7, grad_dtype="float16")
    for s in range(5):
        led.append(s, 0.25 * (s + 1), 1e-4)
    led2 = TrajectoryLedger.from_bytes(led.to_bytes())
    assert led2.content_hash() == led.content_hash()
    led3 = led.slice(0, 3)
    assert led.content_hash(upto=3) == led3.content_hash()
    led4 = TrajectoryLedger.from_bytes(led.to_bytes())
    led4.grads[2] = float(np.float16(9.0))
    assert led4.content_hash() != led.content_hash()
    led5 = TrajectoryLedger.from_bytes(led.to_bytes())
    led5.base_seed = 8
    assert led5.content_hash() != led.content_hash()
    with pytest.raises(ValueError):
        led.content_hash(upto=99)


def test_store_refuses_corrupted_blob():
    led = TrajectoryLedger(base_seed=1)
    led.append(0, 0.5, 1e-4)
    other = TrajectoryLedger(base_seed=2)
    other.append(0, 0.25, 1e-4)
    store = AdapterStore()
    key = store.put("t", led)
    assert store.key("t") == key
    store._blobs[key[0]] = other.to_bytes()     # a mis-filed blob
    with pytest.raises(LedgerHashMismatchError):
        store.ledger("t")
    with pytest.raises(KeyError):
        store.key("unknown")


# --------------------------------------------------------------------------- #
# cached delta ≡ fresh replay, per backend
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_cached_delta_bitwise_equals_fresh_replay(base_setup, backend):
    cfg, base = base_setup
    snapshot = [t.clone() for t in tree_leaves(base)]
    store = make_lora_tenants(cfg, base, 2, steps=3, batch=4, backend=backend)
    rt = lora_runtime(cfg, base, store, cache_bytes=10_000_000)
    delta = rt.delta(tenant_name(0))
    folds = rt.records_replayed
    assert folds == 3                     # the cold materialization replayed
    assert rt.delta(tenant_name(0)) is delta   # hit: same buffers
    assert rt.records_replayed == folds        # ...and zero further folds

    led = store.ledger(tenant_name(0))
    assert led.backend == composition_for_ledger(led).backend_name
    tuned = replay(lora_params0(cfg, base, led), led,
                   composition_for_ledger(led))
    fresh = merge_lora(tuned["base"], tuned["lora"])
    assert_trees_bitwise(delta.apply(base), fresh,
                         f"cached delta != fresh replay under {backend}")
    assert delta.indices and not delta.full_tree
    # the base was never written: training and replay touch the LoRA only
    assert_trees_bitwise(base, tree_unflatten(base, snapshot))


@pytest.mark.parametrize("backend", BACKENDS)
def test_compaction_bitwise_equals_full_replay(base_setup, backend):
    cfg, base = base_setup
    store = make_lora_tenants(cfg, base, 1, steps=6, batch=4, backend=backend,
                              seed0=300)
    led = store.ledger(tenant_name(0))
    opt = composition_for_ledger(led)
    p0 = lora_params0(cfg, base, led)
    full = replay(lora_params0(cfg, base, led), led, opt)
    lora0 = [t.clone() for t in tree_leaves(p0["lora"])]
    for keep_tail in (0, 2, 6, 99):
        comp = compact(p0, led, opt, keep_tail=keep_tail)
        assert comp.upto == max(0, 6 - keep_tail)
        assert len(comp.tail) == 6 - comp.upto
        stored = [t.clone() for t in comp.delta.values]
        assert_trees_bitwise(materialize(p0, comp, opt, ledger=led), full,
                             f"compacted (tail={keep_tail}) != full replay")
        # neither params0 nor the record's buffers were written
        assert_trees_bitwise(p0["lora"], tree_unflatten(p0["lora"], lora0))
        assert all(torch.equal(a, b)
                   for a, b in zip(comp.delta.values, stored))


def test_compaction_refuses_mismatched_ledger(base_setup):
    cfg, base = base_setup
    store = make_lora_tenants(cfg, base, 2, steps=4, batch=4, seed0=400)
    led_a = store.ledger(tenant_name(0))
    led_b = store.ledger(tenant_name(1))
    opt = composition_for_ledger(led_a)
    comp = compact(lora_params0(cfg, base, led_a), led_a, opt, keep_tail=1)
    with pytest.raises(LedgerHashMismatchError):
        materialize(lora_params0(cfg, base, led_b), comp, opt, ledger=led_b)
    store2 = AdapterStore()
    store2.put("b", led_b)
    with pytest.raises(LedgerHashMismatchError):
        store2.put_compacted("b", comp)


def test_runtime_uses_compacted_tail(base_setup):
    cfg, base = base_setup
    store = make_lora_tenants(cfg, base, 1, steps=8, batch=4, seed0=500)
    rt = lora_runtime(cfg, base, store, cache_bytes=10_000_000)
    t = tenant_name(0)
    full_delta = rt.delta(t)
    assert rt.records_replayed == 8
    comp = rt.compact_tenant(t, keep_tail=2)
    assert comp.upto == 6 and len(comp.tail) == 2
    rt.cache._entries.clear()             # force a cold re-materialization
    rt.cache.bytes = 0
    rt2_folds = rt.records_replayed
    delta2 = rt.delta(t)
    assert rt.records_replayed == rt2_folds + 2   # O(tail), not O(steps)
    assert_trees_bitwise(delta2.apply(base), full_delta.apply(base),
                         "compacted materialization != full")


# --------------------------------------------------------------------------- #
# DeltaCache: byte-budgeted LRU
# --------------------------------------------------------------------------- #
def _delta_of_bytes(n_floats, tag):
    v = torch.full((n_floats,), float(tag), dtype=torch.float32)
    return AdapterDelta((0,), (v,), 1, 1)


def test_delta_cache_lru_eviction_under_byte_budget():
    cache = DeltaCache(budget_bytes=1024)          # holds two 100-float deltas
    d = {k: _delta_of_bytes(100, i) for i, k in enumerate("abc")}
    cache.put("a", d["a"])
    cache.put("b", d["b"])
    assert cache.get("a") is d["a"]                # refresh a: b is now LRU
    cache.put("c", d["c"])                         # 1200 B > budget -> evict b
    assert cache.get("b") is None
    assert cache.get("a") is d["a"] and cache.get("c") is d["c"]
    assert cache.evictions == 1 and cache.bytes == 800
    assert not cache.put("big", _delta_of_bytes(1000, 9))
    assert cache.oversize == 1 and len(cache) == 2
    stats = cache.stats
    assert stats["hits"] == 3 and stats["misses"] == 1
    with pytest.raises(ValueError):
        DeltaCache(0)


def test_adapter_delta_diff_and_apply_are_exact(base_setup):
    _, base = base_setup
    leaves = tree_leaves(base)
    changed = list(leaves)
    changed[1] = changed[1] + torch.tensor(0.125, dtype=torch.float32)
    tuned = tree_unflatten(base, changed)
    delta = AdapterDelta.diff(base, tuned)
    assert delta.indices == (1,)
    assert not delta.full_tree
    assert_trees_bitwise(delta.apply(base), tuned)
    assert delta.values[0] is changed[1]          # no copy
    # a value that differs only in its bits (−0 against +0) is a change
    signed = list(leaves)
    signed[0] = torch.where(leaves[0] == 0, torch.tensor(-0.0), leaves[0])
    if not torch.equal(signed[0].view(torch.int32),
                       leaves[0].view(torch.int32)):
        assert AdapterDelta.diff(base, tree_unflatten(base, signed)
                                 ).indices == (0,)
    small = tree_unflatten(base, [leaf[..., :1] for leaf in leaves])
    with pytest.raises(ValueError):
        delta.apply(small)


# --------------------------------------------------------------------------- #
# Engine: mixed-adapter batching + guardrails + timestamps
# --------------------------------------------------------------------------- #
def _sequential_reference(cfg, base, rt, tagged, n_new):
    """Per-adapter sequential decode: one single-slot engine per request."""
    outs = []
    for tenant, req in tagged:
        e1 = engine(cfg, base, slots=1, max_len=48)
        if tenant is not None:
            e1.register_adapter(tenant, rt.delta(tenant))
        r1 = Request(req.rid, list(req.prompt_ids), max_new_tokens=n_new,
                     adapter=tenant)
        e1.submit(r1)
        e1.run()
        outs.append(r1.out_ids)
    return outs


def test_mixed_adapter_batch_matches_sequential(base_setup):
    cfg, base = base_setup
    store = make_lora_tenants(cfg, base, 3, steps=3, batch=4, seed0=600)
    rt = lora_runtime(cfg, base, store, cache_bytes=10_000_000)
    eng = engine(cfg, base, slots=3, max_len=48)
    tagged = synthetic_requests(7, cfg.vocab_size, store.tenants(), seed=2,
                                max_new_tokens=5)
    tagged[3] = (None, tagged[3][1])      # one base-model request in the mix
    serve_load(eng, rt, tagged)
    want = _sequential_reference(cfg, base, rt, tagged, 5)
    for (tenant, req), ref in zip(tagged, want):
        assert req.out_ids == ref, (tenant, req.rid, req.out_ids, ref)
    # every mixed step was ONE stacked decode call
    assert eng.decode_steps["stacked"] > 0
    assert eng.decode_calls["stacked"] == eng.decode_steps["stacked"]
    assert eng.decode_calls["grouped"] == 0


def test_full_tree_delta_takes_grouped_path(base_setup):
    cfg, base = base_setup
    noisy = tree_map(lambda a: a + torch.tensor(0.01, dtype=a.dtype)
                     if a.dtype.is_floating_point else a, base)
    full_delta = AdapterDelta.diff(base, noisy)
    assert full_delta.full_tree
    eng = engine(cfg, base, slots=2, max_len=48)
    eng.register_adapter("full", full_delta)
    reqs = [Request(0, [3, 5, 7], max_new_tokens=4, adapter="full"),
            Request(1, [11, 13], max_new_tokens=4)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.decode_steps["grouped"] > 0 and eng.decode_steps["stacked"] == 0
    assert eng.decode_calls["grouped"] == 2 * eng.decode_steps["grouped"]
    for r, name in zip(reqs, ["full", None]):
        e1 = engine(cfg, base, slots=1, max_len=48)
        if name:
            e1.register_adapter(name, full_delta)
        r1 = Request(r.rid, list(r.prompt_ids), max_new_tokens=4, adapter=name)
        e1.submit(r1)
        e1.run()
        assert r1.out_ids == r.out_ids


def test_engine_refuses_overlong_prompt_and_unknown_adapter(base_setup):
    cfg, base = base_setup
    eng = engine(cfg, base, slots=1, max_len=16)
    with pytest.raises(ValueError, match="exceeds this engine's limit"):
        eng.submit(Request(0, list(range(1, 20)), max_new_tokens=2))
    with pytest.raises(KeyError, match="not registered"):
        eng.submit(Request(1, [1, 2], adapter="ghost"))
    assert not eng.queue                  # nothing was half-admitted


def test_request_timestamp_trail(base_setup):
    cfg, base = base_setup
    eng = engine(cfg, base, slots=1, max_len=32)
    r = Request(0, [4, 5, 6], max_new_tokens=3)
    eng.submit(r)
    eng.run()
    assert r.done
    ts = r.times
    assert set(ts) >= {"queued", "prefill", "decode", "done"}
    assert ts["queued"] <= ts["prefill"] <= ts["decode"] <= ts["done"]


def test_radix_scoped_per_adapter():
    """KV cached under one adapter identity is invisible to every other
    scope: the same template misses across base -> adapter-a -> adapter-b
    and hits only within a scope; re-registering other weights under a
    name drops its scope."""
    from repro_torch.models import all_archs
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    params = convert.params_from_jax(jax.tree.map(np.asarray, jax.jit(
        jax_bundle(jax_archs()["qwen2-0.5b"].smoke_cfg).init)(
            jax.random.PRNGKey(0))))
    leaves = tree_leaves(params)

    def bumped(by):
        return AdapterDelta.diff(params, tree_unflatten(
            params, [leaves[0] + by] + leaves[1:]))

    eng = engine(cfg, params, slots=1, max_len=64)
    eng.register_adapter("a", bumped(0.25))
    tpl = list(range(3, 43))

    def wave(last, adapter, rid):
        r = Request(rid, tpl + [last], max_new_tokens=4, adapter=adapter)
        eng.submit(r)
        eng.run()

    wave(50, None, 0)                     # base, cold
    assert eng.stats["prefix_hits"] == 0
    wave(51, "a", 10)                     # adapter, still cold
    assert eng.stats["prefix_hits"] == 0
    wave(52, "a", 20)                     # adapter, warm
    assert eng.stats["prefix_hits"] == 1
    wave(53, None, 30)                    # base, warm
    assert eng.stats["prefix_hits"] == 2
    eng.register_adapter("a", bumped(0.5))
    wave(54, "a", 40)
    assert eng.stats["prefix_hits"] == 2  # cold again


def test_jax_pallas_interpret_tenant_materializes_to_jaxs(base_setup):
    from repro.models.config import ModelConfig as JaxConfig
    from repro.serve import tenants as jten
    cfg, base = base_setup
    jcfg = JaxConfig(**TINY)
    jbase = jax.tree.map(jax.numpy.asarray, convert.params_to_jax(base))
    jstore = jten.make_lora_tenants(jcfg, jbase, 1, steps=2, batch=4,
                                    backend="pallas-interpret", seed0=700)
    t = jstore.tenants()[0]
    jled = jstore.ledger(t)
    assert jled.backend == "pallas+z2"
    store = AdapterStore()
    assert store.put(t, TrajectoryLedger.from_bytes(jled.to_bytes())) == \
        jstore.key(t)
    seen = {}
    jrt = jten.lora_runtime(jcfg, jbase, jstore)
    rt = lora_runtime(cfg, base, store)
    for name, r in (("jax", jrt), ("port", rt)):
        merge = r.serve_map
        r.serve_map = (lambda merged, name=name, merge=merge:
                       (seen.__setitem__(name, merged["lora"]),
                        merge(merged))[1])
    jd, d = jrt.delta(t), rt.delta(t)
    assert d.indices == jd.indices and len(d.indices) == 2
    for a, b in zip(jd.values, d.values):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=MERGE_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(seen["jax"]),
                    tree_leaves(seen["port"])):
        assert b.numpy().tobytes() == np.asarray(a).tobytes()
