"""bf16 greedy ids and the prefix cache: reference behaviour, not a port
fault.

The paged engine's contract is token identity with the prefix cache on and
off.  Both engines hold it in f32.  In bf16 the warm path (prefix KV from
the pool, chunked attention over the suffix) and the cold path (the flash
kernel over the whole prompt) round differently, and random weights give
near-flat logits, so greedy ids flip on near-ties.  ``chip_smoke.py`` sees
this on the card at full qwen2-0.5b (bf16 ids agree on 166 of 192).  Here
JAX's engine, the reference, shows the same at qwen2-0.5b's width (4
layers, vocab cut to 32 768) on the CPU with its ``pallas_flash``
attention: its bf16 ids with the cache on and off differ, and its f32 ids
do not; the port's engine (its CPU path, the same weights) behaves alike
(58 of 64 bf16 ids agree).  At the smoke config (2 layers, d 64, vocab
256) neither engine's bf16 ids flip.
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.models import all_archs
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(2)

N_REQ, NEW = 8, 8
#: (layers, vocab, width kept) per scale: "wide" is qwen2-0.5b's width cut
#: to 4 layers and a 32 768 vocab, "smoke" the registry's smoke config
SCALES = {"wide": (4, 32768), "smoke": None}


def _prompts(vocab):
    """A shared 80-token template with 4-20-token suffixes."""
    rng = np.random.default_rng(11)
    tpl = [int(t) for t in rng.integers(1, vocab - 1, 80)]
    return [tpl + [int(t) for t in rng.integers(1, vocab - 1,
                                                int(rng.integers(4, 21)))]
            for _ in range(N_REQ)]


def _cfg(archs, scale, dtype):
    arch = archs()["qwen2-0.5b"]
    if SCALES[scale] is None:
        return arch.smoke_cfg.replace(dtype=dtype, max_seq=128,
                                      attention_impl="pallas_flash")
    layers, vocab = SCALES[scale]
    return arch.cfg.replace(n_layers=layers, vocab_size=vocab, max_seq=256,
                            dtype=dtype, attention_impl="pallas_flash")


def _ids(engine, request, cfg, params, prefix_cache, **kw):
    eng = engine(cfg, params, slots=4, max_len=128,
                 prefix_cache=prefix_cache, **kw)
    reqs = [request(i, p, max_new_tokens=NEW)
            for i, p in enumerate(_prompts(cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    if prefix_cache:
        assert eng.prefix_stats()["prefix_hits"] > 0
    return [r.out_ids for r in reqs]


@pytest.mark.parametrize("scale,dtype", [("smoke", "bfloat16"),
                                         ("wide", "float32"),
                                         ("wide", "bfloat16")])
def test_ids_with_and_without_the_prefix_cache(scale, dtype):
    """The ids with the cache on against the ids with it off, in both
    engines: at the smoke config all agree, in bf16 too; at qwen2-0.5b's
    width all agree in f32, while in bf16 the reference's differ (JAX's
    agree on 45 of 64 here, the port's on 58 — near-ties, so only the
    reference's flip is asserted)."""
    jcfg = _cfg(jax_archs, scale, dtype)
    params = jax_bundle(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(params)
    tcfg = _cfg(all_archs, scale, dtype)
    agree = {}
    for name, run in (
            ("jax", lambda pc: _ids(JaxEngine, JaxRequest, jcfg, params, pc)),
            ("port", lambda pc: _ids(ServeEngine, Request, tcfg, tparams, pc,
                                     device="cpu"))):
        on, off = run(True), run(False)
        assert all(len(ids) == NEW for ids in on + off)
        agree[name] = sum(a == b for x, y in zip(on, off)
                          for a, b in zip(x, y))
    if (scale, dtype) == ("wide", "bfloat16"):
        assert agree["jax"] < N_REQ * NEW, agree
    else:
        assert agree == {"jax": N_REQ * NEW, "port": N_REQ * NEW}
