"""Port parity: ``repro_torch.models.peft`` against ``repro.models.peft`` on
JAX-initialized LoRA and prefix trees carried across with ``convert``
(qwen2-0.5b smoke config, f32).

* the merged-tree losses (LoRA merge, prefix forward) equal JAX's within
  ``LOSS_ATOL`` (the two frameworks sum their matmuls in their own order);
* ``prefix_from_tokens`` harvests JAX's K/V for the same tokens within
  ``KV_ATOL``;
* the deprecated shims are bitwise the unified loss;
* under a ``peft`` selection, port MeZO steps leave every base leaf bitwise
  unchanged and move the PEFT leaves — ``_scale`` included (the reference
  quirk, ROADMAP Queue 3).
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.models import peft as jpeft
from repro_torch import convert, zo
from repro_torch.models import all_archs
from repro_torch.models import peft as tpeft
from repro_torch.tree_utils import flatten_with_path, tree_clone, tree_leaves

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

LOSS_ATOL = 1e-5
KV_ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_archs()["qwen2-0.5b"].smoke_cfg
    tcfg = all_archs()["qwen2-0.5b"].smoke_cfg
    w = jax_bundle(jcfg).init(jax.random.PRNGKey(0))
    lora = jpeft.init_lora(jcfg, jax.random.PRNGKey(1))
    # a nonzero B, so the merged delta is not zero
    lora["wq"]["b"] = jax.random.normal(jax.random.PRNGKey(3),
                                        lora["wq"]["b"].shape) * 0.05
    lora["wv"]["b"] = jax.random.normal(jax.random.PRNGKey(4),
                                        lora["wv"]["b"].shape) * 0.05
    prefix = jpeft.init_prefix_from_tokens(jcfg, w, jax.random.PRNGKey(2))
    jb = jax_lm_batch(4, 0, 2, 16, 256)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    to_t = lambda t: convert.params_from_jax(jax.tree.map(np.asarray, t))  # noqa: E731
    return jcfg, tcfg, (w, lora, prefix), (to_t(w), to_t(lora),
                                           to_t(prefix)), jb, tb


@pytest.mark.parametrize("mode", ["lora", "prefix"])
def test_merged_loss_matches_jax(setup, mode):
    jcfg, tcfg, (w, lora, prefix), (tw, tlora, tprefix), jb, tb = setup
    jtree = jpeft.peft_params(w, lora if mode == "lora" else prefix, mode)
    ttree = tpeft.peft_params(tw, tlora if mode == "lora" else tprefix, mode)
    want = float(jax.jit(jpeft.peft_loss_fn(jcfg, mode))(jtree, jb))
    got = float(tpeft.peft_loss_fn(tcfg, mode)(ttree, tb))
    assert abs(got - want) <= LOSS_ATOL
    # the prefix actually changes the loss (it is attended)
    if mode == "prefix":
        plain = float(jax_bundle(jcfg).loss_fn()(w, jb))
        assert abs(got - plain) > 100 * LOSS_ATOL


def test_merge_lora_matches_jax(setup):
    jcfg, _, (w, lora, _), (tw, tlora, _), _, _ = setup
    jm = jpeft.merge_lora(w, lora)["layers"]["attn"]
    tm = tpeft.merge_lora(tw, tlora)["layers"]["attn"]
    for t in ("wq", "wv", "wk"):
        np.testing.assert_allclose(tm[t].numpy(), np.asarray(jm[t]),
                                   rtol=0, atol=1e-6)
    assert tm["wk"] is tw["layers"]["attn"]["wk"]     # untargeted: shared


def test_prefix_from_tokens_matches_jax(setup):
    jcfg, tcfg, (w, _, prefix), (tw, _, _), _, _ = setup
    toks = jax.random.randint(jax.random.PRNGKey(2), (1, 5), 0,
                              jcfg.vocab_size)
    got = tpeft.prefix_from_tokens(tcfg, tw,
                                   torch.from_numpy(np.array(toks)))
    for name in ("pk", "pv"):
        assert got[name].shape == prefix[name].shape
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(prefix[name]), rtol=0,
                                   atol=KV_ATOL)
    g = torch.Generator().manual_seed(0)
    drawn = tpeft.init_prefix_from_tokens(tcfg, tw, g, m=3)
    assert drawn["pk"].shape == (tcfg.n_layers, 3, tcfg.kv_heads, tcfg.hd)


def test_shims_are_the_unified_loss(setup):
    _, tcfg, _, (tw, tlora, tprefix), _, tb = setup
    for mode, tree, shim in (("lora", tlora, tpeft.lora_loss_fn),
                             ("prefix", tprefix, tpeft.prefix_loss_fn)):
        unified = tpeft.peft_loss_fn(tcfg, mode)(
            tpeft.peft_params(tw, tree, mode), tb)
        assert torch.equal(shim(tcfg, tw)(tree, tb), unified)
    with pytest.raises(ValueError, match="unknown peft mode"):
        tpeft.peft_params(tw, tlora, "adapter")
    with pytest.raises(ValueError, match="unknown peft mode"):
        tpeft.peft_loss_fn(tcfg, "adapter")
    assert tpeft.peft_selection("lora").spec == "peft(lora)"


def test_init_shapes_match_jax(setup):
    jcfg, tcfg, (_, lora, _), _, _, _ = setup
    g = torch.Generator().manual_seed(0)
    tl = tpeft.init_lora(tcfg, g)
    jl = jpeft.init_lora(jcfg, jax.random.PRNGKey(1))
    assert [(p, tuple(x.shape), x.dtype) for p, x in flatten_with_path(tl)] \
        == [(jax.tree_util.keystr(p), tuple(x.shape),
             convert.params_from_jax({"x": np.asarray(x)})["x"].dtype)
            for p, x in jax.tree_util.tree_flatten_with_path(jl)[0]]
    assert float(tl["_scale"]) == float(jl["_scale"]) == 2.0
    assert not tl["wq"]["b"].any()
    tp = tpeft.init_prefix(tcfg, g, m=4)
    jp = jpeft.init_prefix(jcfg, jax.random.PRNGKey(1), m=4)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


@pytest.mark.parametrize("mode", ["lora", "prefix"])
def test_base_leaves_untouched_after_port_steps(setup, mode):
    _, tcfg, _, (tw, tlora, tprefix), _, tb = setup
    tree = tpeft.peft_params(tree_clone(tw), tree_clone(
        tlora if mode == "lora" else tprefix), mode)
    before = tree_clone(tree)
    opt = zo.mezo(lr=1e-3, eps=1e-3, weight_decay=0.1, backend="pallas",
                  selection=tpeft.peft_selection(mode))
    state = opt.init(tree, seed=4)
    step = opt.step_fn(tpeft.peft_loss_fn(tcfg, mode))
    for _ in range(2):
        tree, state, m = step(tree, state, tb)
        assert np.isfinite(float(m["loss"]))
    for a, b in zip(tree_leaves(tree["base"]), tree_leaves(before["base"])):
        assert torch.equal(a, b)
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(tree[mode]), tree_leaves(before[mode]))]
    assert all(moved)          # lora: _scale, A and B all move (f32)
