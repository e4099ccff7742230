"""Port parity of the serving engine's dense-slab path (per-slot KV caches,
SWA ring caches, the hybrid SSM state) against the JAX engine, on the
smoke configs in f32 on the CPU.

* ``init_cache(..., per_slot=True)``: JAX's shapes and dtypes; the
  per-row decode write lands where JAX's one-hot ring scatter does (row
  ``cache_pos % cap``; ``pos`` bitwise JAX's, holding the absolute
  position; every other row untouched), its K / V within ``ATOL``;
* greedy ids from the port's engine equal JAX's engine's for hymba-smoke
  (the exact-length prefill, the SSM state per slot, every ring wrapping)
  and for mixtral-smoke (bucketed prefills, the window's ring), as
  ``tests/test_serve.py`` holds JAX's engine to its own reference;
* qwen2-smoke with ``paged=False`` gives the paged engine's ids;
* a prompt longer than the window is refused at ``submit`` with JAX's
  message; the serving launcher serves hymba and mixtral through the slab.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import all_archs as jax_archs
from repro.models import attention as jattn
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.models import all_archs, bundle
from repro_torch.models import attention as tattn
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

ATOL = 1e-5


def _weights(arch):
    """The port's seeded smoke θ as numpy, for both engines."""
    return convert.params_to_jax(bundle(all_archs()[arch].smoke_cfg).init(
        0, device="cpu"))


def _prompts(n_tpl=13):
    tpl = [(7 * i) % 200 + 3 for i in range(n_tpl)]
    return ([tpl + [50 + i] for i in range(3)] + [[3, 5, 7, 9] * 3]
            + [[4, 8, 15]])


def _serve(arch, prompts, new_tokens, **kw):
    """(JAX's ids, the port's ids, the port's engine) for ``prompts``
    through both engines with the same weights, 2 slots, max_len 48."""
    w = _weights(arch)
    outs, eng = [], None
    for cls, req, params, extra in (
            (JaxEngine, JaxRequest, jax.tree.map(jnp.asarray, w), {}),
            (ServeEngine, Request, convert.params_from_jax(w),
             {"device": "cpu"})):
        cfg = (jax_archs() if cls is JaxEngine else all_archs())[arch].smoke_cfg
        eng = cls(cfg, params, slots=2, max_len=48, **kw, **extra)
        reqs = [req(i, p, max_new_tokens=new_tokens)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out_ids for r in reqs])
    return outs[0], outs[1], eng


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x7b", "qwen2-0.5b"])
def test_per_slot_cache_and_decode_write_equal_jax(arch):
    """One per-slot decode step on a half-filled slab through
    ``self_attention``: ``pos`` after the write is JAX's one-hot scatter's
    exactly (row ``cache_pos % cap``; a slot past the window wraps), the
    K / V rows land in the same row and match within ``ATOL``, and so do
    the outputs."""
    tcfg = all_archs()[arch].smoke_cfg
    jcfg = jax_archs()[arch].smoke_cfg
    B, max_len = 3, 40
    tc = tattn.init_cache(tcfg, B, max_len, torch.float32, "cpu",
                          layers=1, per_slot=True)
    jc = jattn.init_cache(jcfg, B, max_len, jnp.float32, layers=1,
                          per_slot=True)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert tc["pos"].dtype == torch.int32 and bool((tc["pos"] == -1).all())
    cap = tc["k"].shape[2]
    rng = np.random.default_rng(0)
    filled = [min(cap, 5), min(cap, 12), cap]
    ck = rng.standard_normal(tc["k"].shape[1:]).astype(np.float32)
    cv = rng.standard_normal(tc["v"].shape[1:]).astype(np.float32)
    pos = np.full((B, cap), -1, np.int32)
    for b, n in enumerate(filled):
        pos[b, :n] = np.arange(n)
    cache_pos = np.array([filled[0], filled[1], cap + 3], np.int32)
    p = {k: v[0].numpy() for k, v in tattn.attention_params(
        tcfg, torch.Generator().manual_seed(1), torch.float32, 1).items()}
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(
        cv.copy()), "pos": torch.from_numpy(pos.copy())}
    tout, tcache = tattn.self_attention(
        tcfg, convert.params_from_jax(p), torch.from_numpy(x),
        torch.from_numpy(cache_pos[:, None]), tcache,
        torch.from_numpy(cache_pos))
    jout, jcache = jattn.self_attention(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(cache_pos[:, None]),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(pos)},
        jnp.asarray(cache_pos))
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert int(tcache["pos"][2, 3 % cap]) == cap + 3
    rows = cache_pos % cap
    for name, before in (("k", ck), ("v", cv)):
        got, want = tcache[name].numpy(), np.asarray(jcache[name])
        for b in range(B):
            keep = np.arange(cap) != rows[b]
            # every other row untouched on both sides, bit for bit; the
            # written row is each framework's own projection
            assert np.array_equal(got[b, keep], before[b, keep])
            assert np.array_equal(want[b, keep], before[b, keep])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)


def test_hybrid_engine_greedy_ids_equal_jax():
    """hymba-smoke (window 16): 5 requests over 2 slots, 24 new tokens
    each, so every slot's ring wraps; each request is prefilled at its
    exact length with its own SSM state."""
    jids, tids, eng = _serve("hymba-1.5b", _prompts(), 24)
    assert tids == jids
    assert not eng.paged and eng.cache["k"].shape[2] == 16
    assert tuple(eng.state.shape) == (2, 2, 4, 16, 4)
    assert eng.stats["prefill_tokens_computed"] == sum(map(len, _prompts()))


def test_mixtral_slab_engine_ids_equal_jax():
    """mixtral-smoke (window 32): bucketed prefills into per-slot rings."""
    jids, tids, eng = _serve("mixtral-8x7b", _prompts(20), 12)
    assert tids == jids
    assert not eng.paged and eng.cache["k"].shape[2] == 32


def test_paged_false_equals_paged_engine():
    """qwen2-smoke through the dense slab (``paged=False``) and through
    the paged engine: the same ids, and JAX's slab's."""
    jids, slab, eng = _serve("qwen2-0.5b", _prompts(), 10, paged=False)
    assert slab == jids and not eng.paged and eng.pool is None
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    paged = ServeEngine(cfg, convert.params_from_jax(_weights("qwen2-0.5b")),
                        slots=2, max_len=48, device="cpu")
    reqs = [Request(i, p, max_new_tokens=10) for i, p in enumerate(_prompts())]
    for r in reqs:
        paged.submit(r)
    paged.run()
    assert paged.paged and [r.out_ids for r in reqs] == slab


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x7b"])
def test_prompt_longer_than_window_refused_at_submit(arch):
    """The slot's capacity is the window: a longer prompt is refused at
    ``submit`` with JAX's message; a prompt of exactly the window is
    served."""
    tcfg = all_archs()[arch].smoke_cfg
    jcfg = jax_archs()[arch].smoke_cfg
    teng = ServeEngine(tcfg, bundle(tcfg).init(0, device="cpu"), slots=2,
                       max_len=64, device="cpu")
    jeng = JaxEngine(jcfg, None, slots=2, max_len=64)
    W = tcfg.sliding_window
    assert teng._prompt_limit() == jeng._prompt_limit() == W
    with pytest.raises(ValueError) as te:
        teng.submit(Request(0, list(range(1, W + 2))))
    with pytest.raises(ValueError) as je:
        jeng.submit(JaxRequest(0, list(range(1, W + 2))))
    assert str(te.value) == str(je.value)
    r = Request(1, list(range(1, W + 1)), max_new_tokens=3)
    teng.submit(r)
    teng.run()
    assert r.done and len(r.out_ids) == 3


def test_serve_cli_serves_the_slab(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                    "--requests", "3", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "dense slab: 4 slots × 32 KV rows (a ring of the window 32)" in out
    assert "3 requests / 12 tokens" in out
