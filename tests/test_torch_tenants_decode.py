"""The port's mixed-adapter decode on every family the engine serves, on the
smoke configs in f32 (the port's own seeded weights; no JAX): two adapters
whose deltas change different leaves (the embedding among them) and the
base, mixed over 3 slots, give the greedy ids of one single-slot engine per
request.

* dense (qwen2, paged), moe (granite, paged; mixtral, the dense slab with
  its window): the STACKED decode — one ``vmap`` call a step, counted;
* ssm (rwkv6) and hybrid (hymba), over the slab: the GROUPED decode — one
  call per distinct live adapter a step, on that group's cache and state
  rows.

The call counter counts the registry decode itself: a loop over slots in
place of ``vmap`` gives the same ids and books one call per slot, and a
full-tree adapter whose slot has gone idle leaves the stacked union."""
import pytest
torch = pytest.importorskip("torch")

from repro_torch.models import all_archs, bundle
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.tenants import AdapterDelta
from repro_torch.tree_utils import (is_floating, tree_leaves, tree_map,
                                    tree_unflatten)

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

PROMPTS = [[3, 5, 7, 9, 11], [4, 8], [6, 2, 1, 7, 7, 3, 9], [12, 13, 14],
           [5, 5, 5, 5], [9, 1]]
ADAPTERS = ["a", None, "b", "a", "b", None]
NEW = 5


def _deltas(params):
    """Two adapters over ``params``: ``a`` scales the embedding and a
    middle leaf, ``b`` two other leaves; each a few leaves, never all."""
    leaves = tree_leaves(params)
    fl = [i for i, leaf in enumerate(leaves) if is_floating(leaf)]
    gen = torch.Generator().manual_seed(3)

    def bump(idx):
        out = list(leaves)
        for i in idx:
            noise = torch.randn(leaves[i].shape, generator=gen)
            out[i] = leaves[i] + 0.5 * noise.to(leaves[i].dtype)
        return AdapterDelta.diff(params, tree_unflatten(params, out))

    return {"a": bump([fl[0], fl[len(fl) // 2]]),
            "b": bump([fl[1], fl[-2]])}


def _serve(cfg, params, deltas, prompts, adapters, slots):
    eng = ServeEngine(cfg, params, slots=slots, max_len=32, device="cpu")
    for name, d in deltas.items():
        eng.register_adapter(name, d)
    reqs = [Request(i, list(p), max_new_tokens=NEW, adapter=a)
            for i, (p, a) in enumerate(zip(prompts, adapters))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, [r.out_ids for r in reqs]


@pytest.mark.parametrize("arch,path", [
    ("qwen2-0.5b", "stacked"), ("granite-moe-3b-a800m", "stacked"),
    ("mixtral-8x7b", "stacked"), ("rwkv6-3b", "grouped"),
    ("hymba-1.5b", "grouped")])
def test_mixed_adapter_decode_equals_single_slot_engines(arch, path):
    cfg = all_archs()[arch].smoke_cfg.replace(dtype="float32")
    params = bundle(cfg).init(0, device="cpu")
    deltas = _deltas(params)
    assert not any(d.full_tree for d in deltas.values())
    eng, got = _serve(cfg, params, deltas, PROMPTS, ADAPTERS, slots=3)
    want = [_serve(cfg, params, deltas, [p], [a], slots=1)[1][0]
            for p, a in zip(PROMPTS, ADAPTERS)]
    assert got == want
    assert all(len(ids) == NEW for ids in got)
    other = "grouped" if path == "stacked" else "stacked"
    assert eng.decode_steps[path] > 0 and eng.decode_steps[other] == 0
    if path == "stacked":
        assert eng.decode_calls["stacked"] == eng.decode_steps["stacked"]
    else:
        # more than one distinct live adapter on some step
        assert eng.decode_calls["grouped"] > eng.decode_steps["grouped"]
    # the adapters change the ids: the deltas are live on the path
    base = [_serve(cfg, params, {}, [p], [None], slots=1)[1][0]
            for p, a in zip(PROMPTS, ADAPTERS) if a is not None]
    assert base != [ids for ids, a in zip(got, ADAPTERS) if a is not None]


def _loop_vmap(fn, in_dims):
    """A Python loop over the slot axis in place of ``torch.func.vmap``."""
    def run(*args):
        n = args[1].shape[in_dims[1]]
        return torch.stack([fn(*(tree_map(lambda a, d=d: a.select(d, s), arg)
                                 for arg, d in zip(args, in_dims)))
                            for s in range(n)])
    return run


def test_stacked_counter_books_a_loop_over_slots(monkeypatch):
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype="float32")
    params = bundle(cfg).init(0, device="cpu")
    deltas = _deltas(params)
    eng, want = _serve(cfg, params, deltas, PROMPTS, ADAPTERS, slots=3)
    assert eng.decode_calls["stacked"] == eng.decode_steps["stacked"] > 0
    monkeypatch.setattr(engine_mod, "vmap", _loop_vmap)
    loop, got = _serve(cfg, params, deltas, PROMPTS, ADAPTERS, slots=3)
    assert got == want
    assert loop.decode_steps == eng.decode_steps
    assert loop.decode_calls["stacked"] == 3 * loop.decode_steps["stacked"]


def test_idle_full_tree_slot_leaves_the_stacked_union():
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype="float32")
    params = bundle(cfg).init(0, device="cpu")
    deltas = _deltas(params)
    bumped = tree_map(lambda a: a + 0.01 if is_floating(a) else a, params)
    deltas["full"] = AdapterDelta.diff(params, bumped)
    assert deltas["full"].full_tree
    eng = ServeEngine(cfg, params, slots=3, max_len=32, device="cpu")
    for name, d in deltas.items():
        eng.register_adapter(name, d)
    # "full" finishes first; its slot stays idle while "a" and "b" decode
    reqs = [Request(0, PROMPTS[0], max_new_tokens=2, adapter="full"),
            Request(1, PROMPTS[1], max_new_tokens=NEW, adapter="a"),
            Request(2, PROMPTS[2], max_new_tokens=NEW, adapter="b")]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.decode_steps["grouped"] > 0 and eng.decode_steps["stacked"] > 0
    vidx, _ = eng._stack
    assert set(vidx) == set(deltas["a"].indices) | set(deltas["b"].indices)
    assert len(vidx) < len(deltas["full"].indices)
    assert [len(r.out_ids) for r in reqs] == [2, NEW, NEW]
