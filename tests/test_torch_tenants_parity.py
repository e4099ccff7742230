"""Port parity of multi-tenant serving against ``repro.serve.tenants`` on
JAX's tiny config (2 layers, d 32, f32), base weights from JAX through
``convert``.

* ``init_lora`` from a threefry key is JAX's LoRA init bit for bit, in both
  threefry layouts and in f32 and bf16;
* the port's flatten order is ``jax.tree_util.tree_flatten``'s on the
  trees a delta indexes (so a delta's ``indices`` name the same leaves);
* a JAX-made ``AdapterStore`` blob loads into the port under the same key;
* the port's ``TenantRuntime.delta`` over JAX-trained ``xla`` tenant
  ledgers changes JAX's leaves, its replayed LoRA tree is JAX's bitwise,
  and its merged leaves are within ``MERGE_ATOL`` of JAX's (a rank-2
  product summed in each framework's own order) — ``pallas-interpret``
  ledgers in ``test_torch_tenants.py``;
* ``DeltaCache.stats`` equal JAX's after every call of one sequence;
* ``synthetic_requests`` / ``template_requests`` draw JAX's requests;
* the port's engine emits JAX's engine's greedy ids per adapter on the same
  mixed load of JAX-trained tenants."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.models import peft as jpeft
from repro.models.config import ModelConfig as JaxConfig
from repro.serve import tenants as jten
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.core.trajectory import TrajectoryLedger
from repro_torch.models import all_archs, bundle
from repro_torch.models.config import ModelConfig
from repro_torch.models.peft import init_lora
from repro_torch.perturb.stream import prng_key, threefry_partitionable
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.tenants import (AdapterStore, DeltaCache,
                                       lora_runtime, serve_load,
                                       synthetic_requests, template_requests)
from repro_torch.serve.tenants.store import AdapterDelta
from repro_torch.tree_utils import flatten_with_path, tree_leaves

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

TINY = dict(name="tenants-lm", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128, max_seq=64,
            dtype="float32")
# W + (α/r)·A·B: JAX's and torch's f32 rank-2 products round differently
# at most in the last place of |W + Δ| ≲ 4 here (measured: equal)
MERGE_ATOL = 1e-6


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def setup():
    jbase = jax.jit(jax_bundle(JaxConfig(**TINY)).init)(jax.random.PRNGKey(0))
    tbase = convert.params_from_jax(jax.tree.map(np.asarray, jbase))
    return JaxConfig(**TINY), jbase, ModelConfig(**TINY), tbase


@pytest.fixture(scope="module")
def jax_stores(setup):
    """JAX-trained tenant stores: 2 tenants on xla (JAX's pallas-interpret
    tenants are held in ``test_torch_tenants.py``, to keep each file's
    time)."""
    jcfg, jbase, _, _ = setup
    return {"xla": jten.make_lora_tenants(jcfg, jbase, 2, steps=3, batch=4,
                                          backend="xla", seed0=600)}


def _capturing(rt):
    """``rt`` with its serve map recording each tuned LoRA tree it maps,
    in materialization order."""
    seen, merge = [], rt.serve_map
    rt.serve_map = lambda merged: (seen.append(merged["lora"]),
                                   merge(merged))[1]
    return rt, seen


@pytest.fixture(scope="module")
def runtimes(setup, jax_stores):
    """Per backend: JAX's runtime and the port's over the same ledgers, each
    recording its replayed LoRA trees; every tenant materialized once."""
    jcfg, jbase, tcfg, tbase = setup
    out = {}
    for backend, jstore in jax_stores.items():
        jrt, jseen = _capturing(jten.lora_runtime(jcfg, jbase, jstore,
                                                  cache_bytes=10_000_000))
        rt, seen = _capturing(lora_runtime(tcfg, tbase, _port_store(jstore),
                                           cache_bytes=10_000_000))
        for t in jstore.tenants():
            jrt.delta(t)
            rt.delta(t)
        out[backend] = (jrt, jseen, rt, seen)
    return out


def _port_store(jstore):
    store = AdapterStore()
    for t in jstore.tenants():
        store.put(t, TrajectoryLedger.from_bytes(jstore._blobs[
            jstore.key(t)[0]]))
    return store


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lora_from_a_key_is_jax_bitwise(partitionable, dtype):
    kw = {**TINY, "dtype": dtype, "n_layers": 3, "d_model": 48}
    for seed in (100, -3):
        with jax.threefry_partitionable(partitionable), \
                threefry_partitionable(partitionable):
            j = jpeft.init_lora(JaxConfig(**kw), jax.random.PRNGKey(seed),
                                rank=2, alpha=16.0, targets=("wq", "wo"))
            t = init_lora(ModelConfig(**kw), prng_key(seed), rank=2,
                          alpha=16.0, targets=("wq", "wo"), device="cpu")
        jl = jax.tree_util.tree_flatten_with_path(j)[0]
        tl = flatten_with_path(t)
        assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (path, b) in zip(jl, tl):
            assert str(b.dtype).endswith(str(a.dtype)), path
            assert _np(b).tobytes() == _np(a).tobytes(), (seed, path)


@pytest.mark.parametrize("arch", [None, "granite-moe-3b-a800m", "hymba-1.5b",
                                  "rwkv6-3b"])
def test_flatten_order_is_jax(setup, arch):
    """The leaf order a delta's ``indices`` refer to: the tiny tree and its
    merged LoRA training tree, and the moe / hybrid / ssm smoke trees."""
    if arch is None:
        jcfg, jbase, _, _ = setup
        lora = jax.eval_shape(lambda k: jpeft.init_lora(jcfg, k, rank=2),
                              jax.random.PRNGKey(1))
        trees = [jbase, {"base": jbase, "lora": jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype), lora)}]
    else:
        # shapes only: JAX's init traced, the port's tree its own init
        cfg = jax_archs()[arch].smoke_cfg
        trees = [jax.eval_shape(jax_bundle(cfg).init, jax.random.PRNGKey(0))]
    for jtree in trees:
        ttree = (bundle(all_archs()[arch].smoke_cfg).init(0, device="cpu")
                 if arch else convert.params_from_jax(
                     jax.tree.map(np.asarray, jtree)))
        jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
        assert [jax.tree_util.keystr(p) for p, _ in jl] == [
            p for p, _ in flatten_with_path(ttree)]
        for (_, a), b in zip(jl, tree_leaves(ttree)):
            assert tuple(a.shape) == tuple(b.shape)


def test_jax_store_blob_loads_with_the_same_key(jax_stores):
    for jstore in jax_stores.values():
        store = _port_store(jstore)
        assert store.tenants() == jstore.tenants()
        for t in jstore.tenants():
            assert store.key(t) == jstore.key(t)
            assert store.ledger(t).to_bytes() == jstore._blobs[
                jstore.key(t)[0]]
        assert store.nbytes() == jstore.nbytes()


@pytest.mark.parametrize("backend", ["xla"])
def test_runtime_delta_over_jax_ledgers_is_jaxs(jax_stores, runtimes,
                                               backend):
    jrt, jseen, rt, seen = runtimes[backend]
    for i, t in enumerate(jax_stores[backend].tenants()):
        jd, d = jrt.delta(t), rt.delta(t)         # cache hits on both sides
        assert d.indices == jd.indices and len(d.indices) == 2
        assert (d.n_leaves, d.n_float_leaves) == (jd.n_leaves,
                                                  jd.n_float_leaves)
        for a, b in zip(jd.values, d.values):
            np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                       atol=MERGE_ATOL)
        # the replayed LoRA tree itself: bitwise JAX's
        for a, b in zip(jax.tree_util.tree_leaves(jseen[i]),
                        tree_leaves(seen[i])):
            assert _np(b).tobytes() == _np(a).tobytes(), (backend, t)
    assert rt.stats == {**jrt.stats, "bytes": rt.stats["bytes"]}


def test_delta_cache_stats_equal_jax():
    rng = np.random.default_rng(5)
    jc, tc = jten.DeltaCache(4096), DeltaCache(4096)
    for step in range(60):
        key = f"k{int(rng.integers(0, 8))}"
        if rng.random() < 0.5:
            jhit, thit = jc.get(key), tc.get(key)
            assert (jhit is None) == (thit is None)
        else:
            n = int(rng.choice([64, 256, 700, 1100]))
            jok = jc.put(key, jten.AdapterDelta(
                (0,), (jnp.zeros((n,), jnp.float32),), 1, 1))
            tok = tc.put(key, AdapterDelta(
                (0,), (torch.zeros((n,), dtype=torch.float32),), 1, 1))
            assert jok == tok
        assert tc.stats == jc.stats, step
        assert (key in tc) == (key in jc) and len(tc) == len(jc)
    assert jc.evictions > 0 and jc.oversize > 0 and jc.hits > 0


def test_request_streams_equal_jax():
    tenants = [f"tenant-{i:03d}" for i in range(5)]

    def rows(tagged):
        return [(t, r.rid, r.prompt_ids, r.max_new_tokens) for t, r in tagged]

    assert rows(synthetic_requests(40, 300, tenants, seed=3,
                                   max_new_tokens=7)) == rows(
        jten.synthetic_requests(40, 300, tenants, seed=3, max_new_tokens=7))
    for kw in ({}, {"template_seed": 9, "rid0": 100, "skew": 0.5}):
        assert rows(template_requests(30, 300, tenants, n_templates=3,
                                      template_len=12, seed=4, **kw)) == rows(
            jten.template_requests(30, 300, tenants, n_templates=3,
                                   template_len=12, seed=4, **kw))


def test_mixed_load_ids_equal_jax_engine(setup, runtimes):
    """JAX's engine and the port's, each fed its own runtime's deltas of the
    same JAX-trained ledgers: a mixed load of the 2 tenants and the base
    over 3 slots (the stacked decode on both sides)."""
    jcfg, jbase, tcfg, tbase = setup
    jrt, _, rt, _ = runtimes["xla"]
    tenants = jrt.store.tenants()
    jreqs = jten.synthetic_requests(5, jcfg.vocab_size, tenants, seed=2,
                                    max_new_tokens=4)
    treqs = synthetic_requests(5, tcfg.vocab_size, tenants, seed=2,
                               max_new_tokens=4)
    for reqs in (jreqs, treqs):
        reqs[3] = (None, reqs[3][1])      # one base-model request
    jten.serve_load(JaxEngine(jcfg, jbase, slots=3, max_len=48), jrt, jreqs)
    eng = ServeEngine(tcfg, tbase, slots=3, max_len=48, device="cpu")
    serve_load(eng, rt, treqs)
    assert [(t, r.out_ids) for t, r in treqs] == [
        (t, r.out_ids) for t, r in jreqs]
    assert eng.decode_calls["stacked"] == eng.decode_steps["stacked"] > 0
