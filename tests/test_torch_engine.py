"""Port parity of the paged serving engine: the port's ``ServeEngine``
emits JAX's greedy ids on the same weights, its prefix cache is invisible in
the ids, and its refusals match JAX's (an unregistered adapter among them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.paged import PoolExhaustedError as JaxPoolExhausted
from repro.serve.tenants import AdapterDelta as JaxAdapterDelta
from repro_torch import convert
from repro_torch.models import all_archs
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged import PoolExhaustedError
from repro_torch.serve.tenants import AdapterDelta
from repro_torch.tree_utils import tree_leaves, tree_unflatten

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist


@pytest.fixture(scope="module")
def weights():
    cfg = jax_archs()["qwen2-0.5b"].smoke_cfg
    return jax.tree.map(np.asarray, jax_bundle(cfg).init(jax.random.PRNGKey(0)))


def _prompts():
    """6 seeded prompts: one 40-token template + fresh 1–5 token suffixes."""
    rng = np.random.default_rng(0)
    tpl = [int(t) for t in rng.integers(1, 255, 40)]
    return [tpl + [int(t) for t in rng.integers(1, 255, int(rng.integers(1, 6)))]
            for _ in range(6)]


def _cfgs(impl):
    return (jax_archs()["qwen2-0.5b"].smoke_cfg.replace(attention_impl=impl),
            all_archs()["qwen2-0.5b"].smoke_cfg.replace(attention_impl=impl))


def _serve(engine, request_cls, prompts, n_new=8):
    reqs = [request_cls(i, p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [r.out_ids for r in reqs]


@pytest.mark.parametrize("impl", ["xla", "pallas_flash"])
def test_greedy_ids_match_jax_and_cache_on_off(weights, impl):
    jcfg, tcfg = _cfgs(impl)
    prompts = _prompts()
    want = _serve(JaxEngine(jcfg, jax.tree.map(jnp.asarray, weights),
                            slots=3, max_len=64), JaxRequest, prompts)
    outs = {}
    for pc in (True, False):
        eng = ServeEngine(tcfg, convert.params_from_jax(weights), slots=3,
                          max_len=64, prefix_cache=pc, device="cpu")
        outs[pc] = _serve(eng, Request, prompts)
        if pc:
            st = eng.prefix_stats()
            assert st["prefix_hits"] >= 3, st
            assert st["prefill_tokens_computed"] < \
                st["prefill_tokens_submitted"], st
    assert outs[True] == want
    assert outs[False] == outs[True]
    assert all(len(ids) == 8 for ids in want)


def test_refusals_match_jax(weights):
    jcfg, tcfg = _cfgs("xla")
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, weights), slots=2,
                     max_len=32)
    teng = ServeEngine(tcfg, convert.params_from_jax(weights), slots=2,
                       max_len=32, device="cpu")
    long_prompt = list(range(1, 33))
    with pytest.raises(ValueError) as je:
        jeng.submit(JaxRequest(0, long_prompt))
    with pytest.raises(ValueError) as te:
        teng.submit(Request(0, long_prompt))
    assert str(te.value) == str(je.value)
    with pytest.raises(KeyError):
        teng.submit(Request(1, [1, 2], adapter="tenant-a"))
    # a registered adapter is admitted; an unregistered one refuses with
    # JAX's KeyError, naming the registered ones
    jleaves, jdef = jax.tree_util.tree_flatten(jeng.params)
    jeng.register_adapter("tenant-a", JaxAdapterDelta.diff(
        jeng.params, jax.tree_util.tree_unflatten(
            jdef, [jleaves[0] + 0.25] + jleaves[1:])))
    tleaves = tree_leaves(teng.params)
    teng.register_adapter("tenant-a", AdapterDelta.diff(
        teng.params, tree_unflatten(teng.params,
                                    [tleaves[0] + 0.25] + tleaves[1:])))
    teng.submit(Request(1, [1, 2], adapter="tenant-a"))
    assert len(teng.queue) == 1
    with pytest.raises(KeyError) as je:
        jeng.submit(JaxRequest(2, [1, 2], adapter="tenant-b"))
    with pytest.raises(KeyError) as te:
        teng.submit(Request(2, [1, 2], adapter="tenant-b"))
    assert str(te.value) == str(je.value) and "tenant-a" in str(te.value)

    # a pool of 3 blocks (trash + 2) cannot hold a 40-token prompt
    prompt = list(range(1, 41))
    jsmall = JaxEngine(jcfg, jax.tree.map(jnp.asarray, weights), slots=1,
                       max_len=64, pool_blocks=3)
    tsmall = ServeEngine(tcfg, convert.params_from_jax(weights), slots=1,
                         max_len=64, pool_blocks=3, device="cpu")
    jsmall.submit(JaxRequest(0, prompt))
    tsmall.submit(Request(0, prompt))
    with pytest.raises(JaxPoolExhausted) as je:
        jsmall.step()
    with pytest.raises(PoolExhaustedError) as te:
        tsmall.step()
    assert str(te.value) == str(je.value)


def test_temperature_sampling_is_seeded(weights):
    _, tcfg = _cfgs("xla")
    outs = []
    for _ in range(2):
        eng = ServeEngine(tcfg, convert.params_from_jax(weights), slots=2,
                          max_len=32, seed=5, device="cpu")
        reqs = [Request(i, [3, 4, 5, i + 1], max_new_tokens=6, temperature=1.0)
                for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out_ids for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < tcfg.vocab_size for ids in outs[0] for t in ids)
