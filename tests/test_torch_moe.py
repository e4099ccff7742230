"""Port parity of the moe family (``models/moe.py`` and the transformer's
moe branch) against the JAX package, on the smoke configs in f32 on the CPU.

* ``moe_ffn`` on the same ``h2`` (JAX's input, converted): the routing —
  ``gate_idx``, ``keep`` and ``pos`` — exactly JAX's, the renormalised
  gates within ``GATE_RTOL`` (a few f32 ulps), the output within
  ``OUT_ATOL`` and the load-balancing loss within ``AUX_ATOL`` (both
  frameworks sum f32 products in their own order); the single-leaf and the
  grouped ``expert_groups=2`` layouts agree;
* capacity drops at a tiny capacity, routing still exact;
* forward logits and ``loss_fn("ce" | "accuracy" | "f1")`` against JAX
  through ``convert``.  Held within ``ATOL`` on seeds whose routing margins
  exceed the forward tolerance: ``_margin`` checks, at every layer's router
  input, that the k-th and (k+1)-th probabilities of every token differ by
  more than 1e-4 (so no top-k choice can flip within the tolerance);
* ``n_params`` / ``n_active_params`` and ``default_selection`` equal
  JAX's for both full configs; ``moe_experts(2)`` masks on the real tree;
* a JAX-trained moe ledger (``xla`` and ``pallas+z2``) replays bitwise;
* greedy ids from the port's paged engine equal JAX's for granite-smoke,
  with the prefix cache on and off; mixtral's engine refusal;
* ``launch.train --model-family moe --smoke`` runs two steps on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import zo as jzo
from repro.core import TrajectoryLedger as JaxLedger
from repro.core import replay as jax_replay
from repro.data.pipeline import DataSpec as JaxSpec
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.models import default_selection as jax_default_selection
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.common import KeyGen
from repro.select import parse_selection as jax_parse_selection
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train.loop import train as jax_train
from repro_torch import convert
from repro_torch.core import TrajectoryLedger, replay
from repro_torch.models import all_archs, bundle
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import default_selection
from repro_torch.select import parse_selection
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.tenants import composition_for_ledger
from repro_torch.tree_utils import tree_leaves

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b"]
OUT_ATOL = 1e-5
AUX_ATOL = 1e-6
ATOL = 1e-4
MARGIN = 1e-4
GATE_RTOL = 4e-6


def _jax_routing(cfg, router, xg):
    """The first lines of JAX's ``moe_ffn``: (probs, gate_vals, gate_idx,
    pos, keep) for x reshaped to (G, M, d)."""
    E, K = cfg.n_experts, cfg.top_k
    G, M, _ = xg.shape
    C = jmoe._capacity(cfg, M)
    logits = (xg @ router).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(G, K * M, E)
    pos = jnp.sum(flat * (jnp.cumsum(flat, axis=1) - flat), axis=-1)
    keep = pos < C
    pos = pos.reshape(G, K, M).transpose(0, 2, 1)
    keep = keep.reshape(G, K, M).transpose(0, 2, 1)
    return probs, gate_vals * keep, gate_idx, pos, keep


def _setup(arch, seed=0, **replace):
    jcfg = jax_archs()[arch].smoke_cfg.replace(**replace)
    tcfg = all_archs()[arch].smoke_cfg.replace(**replace)
    p = jax.tree.map(np.asarray, jmoe.moe_params(
        jcfg, KeyGen(jax.random.PRNGKey(seed)), jnp.float32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (2, 64, jcfg.d_model)))
    return jcfg, tcfg, p, x


def _check_routing(jcfg, tcfg, p, x):
    M = min(jcfg.moe_group_size, x.shape[1])
    xg = x.reshape(-1, M, x.shape[-1])
    jr = _jax_routing(jcfg, jnp.asarray(p["router"]), jnp.asarray(xg))
    tr = tmoe.route(tcfg, torch.from_numpy(p["router"]), torch.from_numpy(xg))
    assert np.array_equal(tr.gate_idx.numpy(), np.asarray(jr[2]))
    assert np.array_equal(tr.keep.numpy(), np.asarray(jr[4]))
    assert np.array_equal(tr.pos.numpy(), np.asarray(jr[3]).astype(np.int64))
    # the gates: softmax and matmul round in each framework's own order
    np.testing.assert_allclose(tr.gate_vals.numpy(), np.asarray(jr[1]),
                               atol=1e-7, rtol=GATE_RTOL)
    return tr


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_routing_exact_and_output_close(arch):
    jcfg, tcfg, p, x = _setup(arch)
    _check_routing(jcfg, tcfg, p, x)
    jo, ja = jmoe.moe_ffn(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    to, ta = tmoe.moe_ffn(tcfg, convert.params_from_jax(p),
                          torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OUT_ATOL,
                               rtol=0)
    assert abs(float(ta) - float(ja)) <= AUX_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_layout_agrees_with_single_leaf(arch):
    """The same experts split into eg0 / eg1 (JAX's grouped layout, built
    from the single leaves; 4 experts, so granite-smoke's 5 are cut): the
    port's output is its single-leaf output, and JAX's grouped output
    within ``OUT_ATOL``."""
    jcfg, tcfg, p, x = _setup(arch, n_experts=4)
    E, G = 4, 2
    grouped = {"router": p["router"]}
    for j in range(G):
        grouped[f"eg{j}"] = {k: p[k][j * E // G:(j + 1) * E // G]
                             for k in ("w1", "w2", "w3")}
    gj, gt = jcfg.replace(expert_groups=G), tcfg.replace(expert_groups=G)
    single, _ = tmoe.moe_ffn(tcfg, convert.params_from_jax(p),
                             torch.from_numpy(x))
    split, _ = tmoe.moe_ffn(gt, convert.params_from_jax(grouped),
                            torch.from_numpy(x))
    np.testing.assert_allclose(split.numpy(), single.numpy(), atol=1e-6,
                               rtol=0)
    jo, _ = jmoe.moe_ffn(gj, jax.tree.map(jnp.asarray, grouped),
                         jnp.asarray(x))
    np.testing.assert_allclose(split.numpy(), np.asarray(jo), atol=OUT_ATOL,
                               rtol=0)


def test_capacity_drops_tokens_with_routing_exact():
    """As ``tests/test_moe.py``: at a capacity far below the assignments
    most choices are dropped and the output shrinks; the dropped set is
    JAX's exactly."""
    jcfg, tcfg, p, x = _setup("mixtral-8x7b", moe_group_size=64)
    tp = convert.params_from_jax(p)
    full, _ = tmoe.moe_ffn(tcfg.replace(capacity_factor=8.0), tp,
                           torch.from_numpy(x))
    tiny_cfg = tcfg.replace(capacity_factor=0.01)
    tiny, _ = tmoe.moe_ffn(tiny_cfg, tp, torch.from_numpy(x))
    assert float(tiny.abs().mean()) < 0.75 * float(full.abs().mean())
    tr = _check_routing(jcfg.replace(capacity_factor=0.01), tiny_cfg, p, x)
    assert tr.capacity == 8 and float(tr.keep.float().mean()) < 0.5
    jo, _ = jmoe.moe_ffn(jcfg.replace(capacity_factor=0.01),
                         jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(tiny.numpy(), np.asarray(jo), atol=OUT_ATOL,
                               rtol=0)


def test_capacity_rule_and_decode_groups():
    cfg = all_archs()["granite-moe-3b-a800m"].cfg
    jcfg = jax_archs()["granite-moe-3b-a800m"].cfg
    for m in (1, 7, 100, 256, 512):
        assert tmoe._capacity(cfg, m) == jmoe._capacity(jcfg, m)
    assert tmoe._capacity(cfg, 1) == 8           # decode: nothing dropped


# --------------------------------------------------------------------------- #
# The whole model
# --------------------------------------------------------------------------- #
def _pair(arch, dtype="float32", **replace):
    jcfg = jax_archs()[arch].smoke_cfg.replace(dtype=dtype, **replace)
    tcfg = all_archs()[arch].smoke_cfg.replace(dtype=dtype, **replace)
    w = jax.tree.map(np.asarray, jax_bundle(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, w


def _margin(cfg, params, tokens) -> float:
    """The smallest gap between the k-th and (k+1)-th router probability
    over every token and layer of the JAX forward (the routing margin the
    whole-model tolerance relies on)."""
    x = jnp.take(params["embed"], tokens, axis=0) * jnp.sqrt(
        jnp.float32(cfg.d_model)).astype(params["embed"].dtype)
    pos = jnp.arange(tokens.shape[1], dtype=jnp.int32)
    worst = np.inf
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        h = jtr.apply_norm(cfg, x, lp["ln1"])
        a, _ = jtr.attn_lib.self_attention(cfg, lp["attn"], h, pos, None,
                                           None)
        h2 = jtr.apply_norm(cfg, x + a, lp["ln2"])
        probs = jax.nn.softmax((h2 @ lp["moe"]["router"]).astype(
            jnp.float32), axis=-1)
        top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
        worst = min(worst, float(np.min(top[..., cfg.top_k - 1]
                                        - top[..., cfg.top_k])))
        x = jtr.block(cfg, lp, x, pos, None, None, None)[0]
    return worst


def _batch(cfg, seed=0, B=2, S=32):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("objective", ["ce", "accuracy", "f1"])
def test_forward_and_losses_match_jax(arch, objective):
    jcfg, tcfg, w = _pair(arch)
    batch = _batch(jcfg)
    jw = jax.tree.map(jnp.asarray, w)
    assert _margin(jcfg, jw, jnp.asarray(batch["tokens"])) > MARGIN
    tw = convert.params_from_jax(w)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jr = jtr.forward(jcfg, jw, tokens=jnp.asarray(batch["tokens"]))
    tr = ttr.forward(tcfg, tw, tokens=tb["tokens"])
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               atol=ATOL, rtol=0)
    assert abs(float(tr.aux_loss) - float(jr.aux_loss)) <= AUX_ATOL
    jl = jax_bundle(jcfg).loss_fn(objective)(
        jw, {k: jnp.asarray(v) for k, v in batch.items()})
    tl = bundle(tcfg).loss_fn(objective)(tw, tb)
    assert abs(float(tl) - float(jl)) < ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_default_selection_equal_jax(arch):
    t, j = all_archs()[arch], jax_archs()[arch]
    for tc, jc in ((t.cfg, j.cfg), (t.smoke_cfg, j.smoke_cfg)):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        for G in (0, 2):
            if G and tc.n_experts % G:
                continue
            assert default_selection(tc.replace(expert_groups=G)) == \
                jax_default_selection(jc.replace(expert_groups=G))
            assert bundle(tc.replace(expert_groups=G)).default_selection() \
                == jax_default_selection(jc.replace(expert_groups=G))
    want = {"mixtral-8x7b": (46.70e9, 12.88e9),
            "granite-moe-3b-a800m": (3.375e9, 0.959e9)}[arch]
    got = (t.cfg.n_params(), t.cfg.n_active_params())
    assert [round(v / 1e9, 3 if v < 10e9 else 2) for v in got] == \
        [round(v / 1e9, 3 if v < 10e9 else 2) for v in want]


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_moe_experts_masks_on_the_real_tree(phase):
    """moe_experts(2) on granite-smoke built with expert_groups=2: the
    router frozen, group ``phase % 2`` active, every other leaf active —
    JAX's mask on JAX's tree, leaf by leaf."""
    jcfg, tcfg, w = _pair("granite-moe-3b-a800m", n_experts=4,
                          expert_groups=2)
    tw = convert.params_from_jax(w)
    tmask = parse_selection("moe_experts(2)").leaf_mask(tw, phase)
    jmask = jax_parse_selection("moe_experts(2)").leaf_mask(w, phase)
    assert tuple(tmask) == tuple(jmask)
    from repro_torch.tree_utils import flatten_with_path
    for (path, _), m in zip(flatten_with_path(tw), tmask):
        if "router" in path:
            assert not m
        elif "eg" in path:
            assert m == (f"['eg{phase % 2}']" in path)
        else:
            assert m
    single = convert.params_from_jax(_pair("granite-moe-3b-a800m")[2])
    with pytest.raises(ValueError, match="grouped expert layout"):
        parse_selection("moe_experts(2)").leaf_mask(single, 0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_jax_trained_moe_ledger_replays_bitwise(backend):
    """JAX trains granite-smoke (4 experts in 2 groups) 3 MeZO steps under
    moe_experts(2) on ``xla`` or ``pallas-interpret``; the port replays the
    MZOL5 ledger to JAX's replay bitwise, the router and the groups
    inactive at every step at θ₀'s bits."""
    jcfg, tcfg, w = _pair("granite-moe-3b-a800m", n_experts=4,
                          expert_groups=2)
    jback = "pallas-interpret" if backend == "pallas" else "xla"
    opt = jzo.mezo(lr=1e-3, eps=1e-3, backend=jback,
                   selection="moe_experts(2)")
    led = JaxLedger(base_seed=2, grad_dtype="float32",
                    backend=opt.backend_name, selection=opt.selection_spec,
                    sel_phase=opt.selection_phase)
    jax_train(jax_bundle(jcfg).loss_fn(), jax.tree.map(jnp.asarray, w), opt,
              JaxPipeline(JaxSpec("lm", batch=2, seq=32, vocab=256, seed=4)),
              total_steps=3, ledger=led, seed=2, log_every=10)
    raw = led.to_bytes()
    assert raw[:5] == b"MZOL5"
    want = jax_replay(jax.tree.map(jnp.asarray, w), JaxLedger.from_bytes(raw),
                      jzo.mezo(backend=jback, selection="moe_experts(2)"))
    tled = TrajectoryLedger.from_bytes(raw)
    got = replay(convert.params_from_jax(w), tled,
                 composition_for_ledger(tled))
    wl = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want))
    gl = jax.tree_util.tree_leaves(convert.params_to_jax(got))
    w0 = jax.tree_util.tree_leaves(w)
    moved = 0
    for a, b, c in zip(wl, gl, w0):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
        moved += not np.array_equal(a, c)
    assert 0 < moved < len(w0)
    router = [lf for p, lf in _paths(got) if "router" in p]
    router0 = [lf for p, lf in _paths(convert.params_from_jax(w))
               if "router" in p]
    assert all(torch.equal(a, b) for a, b in zip(router, router0))


def _paths(tree):
    from repro_torch.tree_utils import flatten_with_path
    return flatten_with_path(tree)


# --------------------------------------------------------------------------- #
# Serving and the launcher
# --------------------------------------------------------------------------- #
def _prompts():
    tpl = [(7 * i) % 200 + 3 for i in range(40)]
    return [tpl + [50 + i] for i in range(3)] + [[3, 5, 7, 9] * 5]


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_paged_engine_greedy_ids_equal_jax(prefix_cache):
    """granite-smoke through the port's paged engine and JAX's, with JAX's
    weights: the greedy ids are equal (chunk prefill with its padded rows,
    K12's plain gather, decode groups of one token)."""
    jcfg, tcfg, w = _pair("granite-moe-3b-a800m")
    outs = []
    for eng_cls, req_cls, params in (
            (JaxEngine, JaxRequest, jax.tree.map(jnp.asarray, w)),
            (ServeEngine, Request, convert.params_from_jax(w))):
        kw = {} if eng_cls is JaxEngine else {"device": "cpu"}
        eng = eng_cls(jcfg if eng_cls is JaxEngine else tcfg, params,
                      slots=2, max_len=64, prefix_cache=prefix_cache, **kw)
        assert eng.paged
        ids = []
        for wave in (_prompts()[:2], _prompts()[2:]):
            reqs = [req_cls(i, p, max_new_tokens=5)
                    for i, p in enumerate(wave)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            ids += [r.out_ids for r in reqs]
        outs.append(ids)
    assert outs[0] == outs[1]


def test_mixtral_engine_refuses_loudly():
    """The paged engine refuses mixtral's window loudly, with JAX's
    message; the default picks the dense slab for it (and ``paged=False``
    for granite), where the engine's refusal stood before the dense-slab
    path was ported (``tests/test_torch_serve_slab.py`` serves both)."""
    cfg = all_archs()["mixtral-8x7b"].smoke_cfg
    params = bundle(cfg).init(0, device="cpu")
    jcfg = jax_archs()["mixtral-8x7b"].smoke_cfg
    with pytest.raises(ValueError, match="dense-slab") as te:
        ServeEngine(cfg, params, slots=2, max_len=64, paged=True,
                    device="cpu")
    with pytest.raises(ValueError) as je:
        JaxEngine(jcfg, None, slots=2, max_len=64, paged=True)
    assert str(te.value) == str(je.value)
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    assert not eng.paged and eng.cache["k"].shape[2] == cfg.sliding_window
    gcfg = all_archs()["granite-moe-3b-a800m"].smoke_cfg
    eng = ServeEngine(gcfg, bundle(gcfg).init(0, device="cpu"), paged=False,
                      device="cpu")
    assert not eng.paged and eng.pool is None


def test_train_cli_moe_family_two_steps(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    run = tmp_path / "run"
    train_cli.main(["--model-family", "moe", "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "32",
                    "--expert-groups", "2", "--select", "auto",
                    "--ckpt-dir", str(run)])
    out = capsys.readouterr().out
    assert "--select auto -> 'moe_experts(2)'" in out
    assert "mixtral-8x7b-smoke" in out and "done: 2 steps" in out
    raw = (run / "ledger.mzl").read_bytes()
    assert raw[:5] == b"MZOL5"
    with pytest.raises(SystemExit, match="frames"):
        train_cli.main(["--model-family", "encdec", "--smoke", "--device",
                        "cpu"])
    with pytest.raises(SystemExit, match="--expert-groups needs an MoE"):
        train_cli.main(["--smoke", "--device", "cpu", "--expert-groups",
                        "2"])
    gran = tmp_path / "gran"
    train_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device",
                    "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                    "--ckpt-dir", str(gran)])
    serve_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device",
                    "cpu", "--ledger", str(gran / "ledger.mzl"),
                    "--requests", "2", "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "replayed 2 ledger steps" in out and "paged KV" in out


@pytest.mark.parametrize("grouped", [False, True], ids=["single", "eg"])
def test_convert_round_trips_moe_trees(grouped):
    jcfg, _, w = _pair("mixtral-8x7b", expert_groups=2 if grouped else 0)
    back = convert.params_to_jax(convert.params_from_jax(w))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(w)
    for a, b in zip(jax.tree_util.tree_leaves(w),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tcfg = all_archs()["mixtral-8x7b"].smoke_cfg.replace(
        expert_groups=2 if grouped else 0)
    mine = bundle(tcfg).init(0, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(w)]
