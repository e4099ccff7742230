"""Port parity of the hybrid family (``models/ssm.py`` and the
transformer's hybrid branch) against the JAX package, on the hymba-1.5b
smoke config in f32 on the CPU.

* ``ssm_scan`` in both modes at an odd length (identity padding of the
  last chunk), from zeros and from a given state, and ``ssm_decode_step``
  on JAX's parameters and input: y and the final state within
  ``SSM_ATOL``.  The chunk mode carries the chunk states with a loop where
  JAX runs a log-depth ``associative_scan``, so the two round in other
  orders: a tolerance, not bitwise;
* the hybrid forward's logits and final SSM state within ``ATOL``;
  ``loss_fn("ce" | "accuracy" | "f1")`` likewise;
* the config, ``n_params`` (JAX's analytic estimate, not the tree's
  count), ``sub_quadratic``, ``FAMILY_ARCHS`` and ``default_selection``
  equal JAX's; the leaf paths and shapes equal JAX's ``tree_flatten``;
* (``tests/test_torch_hybrid_ledger.py``: a hymba ledger JAX trains on
  ``xla`` and on ``pallas+z2`` replays bitwise in the port;)
* the prefix and LoRA forwards on the hybrid tree;
* the SWA ring decode far past the window against the full forward
  (``tests/test_smoke_archs.py``'s check), and its last logits against
  JAX's; an SSM state crosses ``convert`` both ways;
* ``launch.train --model-family hybrid`` in both scan modes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import FAMILY_ARCHS as JAX_FAMILY_ARCHS
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.models import default_selection as jax_default_selection
from repro.models import peft as jpeft
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.core import TrajectoryLedger
from repro_torch.models import FAMILY_ARCHS, all_archs, bundle
from repro_torch.models import peft as tpeft
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import default_selection
from repro_torch.tree_utils import flatten_with_path

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

ARCH = "hymba-1.5b"
SSM_ATOL = 2e-5      # one SSD layer: f32 einsums / chunk carry in two orders
ATOL = 1e-4          # the whole two-layer forward
RING_TOL = 5e-3      # tests/test_smoke_archs.py's ring-decode tolerance


def _cfgs(**replace):
    return (jax_archs()[ARCH].smoke_cfg.replace(**replace),
            all_archs()[ARCH].smoke_cfg.replace(**replace))


@pytest.fixture(scope="module")
def weights():
    """One smoke θ for both sides, as numpy (the port's seeded init: JAX's
    vmapped init costs seconds to compile and is not under test here)."""
    _, tcfg = _cfgs()
    return convert.params_to_jax(bundle(tcfg).init(0, device="cpu"))


def _ssm_inputs(S):
    """One SSM layer's leaves (the port's init, layer 0), u and a state,
    as numpy."""
    jcfg, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    p = {k: v[0].numpy() for k, v in tssm.ssm_params(tcfg, g, torch.float32,
                                                    1).items()}
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, jcfg.ssm_heads, jcfg.hd,
                              jcfg.ssm_state)).astype(np.float32)
    return jcfg, tcfg, p, u, h0


@pytest.mark.parametrize("mode", ["chunk", "fused_recurrent"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_ssm_scan_matches_jax(mode, with_state):
    """S = 45: one whole chunk of 32 and a last chunk padded with 19
    identity tokens."""
    jcfg, tcfg, p, u, h0 = _ssm_inputs(45)
    st = h0 if with_state else None
    yj, hj = jax.jit(lambda p, u, st: jssm.ssm_scan(jcfg, p, u, st,
                                                    mode=mode))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(u),
        None if st is None else jnp.asarray(st))
    yt, ht = tssm.ssm_scan(tcfg, convert.params_from_jax(p),
                           torch.from_numpy(u),
                           None if st is None else torch.from_numpy(st),
                           mode=mode)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=SSM_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=SSM_ATOL,
                               rtol=0)
    assert ht.dtype == torch.float32 and ht.shape == h0.shape


def test_ssm_decode_step_and_modes():
    """One token from a state (both modes take ``ssm_decode_step``), JAX's
    values; and chunk ≡ fused_recurrent within JAX's SCAN_PARITY_ATOL; an
    unknown mode raises as in JAX."""
    jcfg, tcfg, p, u, h0 = _ssm_inputs(48)
    tp = convert.params_from_jax(p)
    yj, hj = jssm.ssm_decode_step(jcfg, jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(u[:, :1]), jnp.asarray(h0))
    for mode in ("chunk", "fused_recurrent"):
        yt, ht = tssm.ssm_scan(tcfg, tp, torch.from_numpy(u[:, :1]),
                               torch.from_numpy(h0), mode=mode)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=SSM_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=SSM_ATOL,
                                   rtol=0)
    yc, hc = tssm.ssm_scan(tcfg, tp, torch.from_numpy(u), None, mode="chunk")
    yr, hr = tssm.ssm_scan(tcfg, tp, torch.from_numpy(u), None,
                           mode="fused_recurrent")
    np.testing.assert_allclose(yc.numpy(), yr.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(hc.numpy(), hr.numpy(), atol=1e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="scan mode"):
        tssm.ssm_scan(tcfg, tp, torch.from_numpy(u), mode="nope")


def _batch(cfg, seed=0, B=2, S=37):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


@pytest.mark.parametrize("mode", ["chunk", "fused_recurrent"])
def test_hybrid_forward_and_state_match_jax(weights, mode):
    jcfg, tcfg = _cfgs(scan_mode=mode)
    toks = _batch(jcfg)["tokens"]
    st = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (
        jcfg.n_layers, 2, jcfg.ssm_heads, jcfg.hd, jcfg.ssm_state)))
    jw, tw = jax.tree.map(jnp.asarray, weights), convert.params_from_jax(weights)
    jr = jtr.forward(jcfg, jw, tokens=jnp.asarray(toks),
                     ssm_state=jnp.asarray(st))
    tr = ttr.forward(tcfg, tw, tokens=torch.from_numpy(toks),
                     ssm_state=torch.from_numpy(st))
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tr.ssm_state.numpy(), np.asarray(jr.ssm_state),
                               atol=SSM_ATOL, rtol=0)
    # no state given: zeros in, none out (as JAX); the first two fields and
    # aux_loss by name as for the other families
    plain = ttr.forward(tcfg, tw, tokens=torch.from_numpy(toks))
    logits, cache = plain[:2]
    assert cache is None and plain.ssm_state is None
    assert plain.aux_loss is None
    zero = ttr.forward(tcfg, tw, tokens=torch.from_numpy(toks),
                       ssm_state=torch.zeros(st.shape))
    assert torch.equal(logits, zero.logits)


@pytest.fixture(scope="module")
def jax_logits(weights):
    """JAX's teacher-forcing logits of ``_batch(seed=1)`` (one forward for
    the three objectives)."""
    jcfg, _ = _cfgs()
    batch = _batch(jcfg, seed=1)
    return batch, np.asarray(jtr.forward(
        jcfg, jax.tree.map(jnp.asarray, weights),
        tokens=jnp.asarray(batch["tokens"])).logits)


def _jax_objective(jcfg, objective, logits, batch):
    """JAX's ``Bundle.loss_fn(objective)`` applied to given logits: its CE
    (``lm_loss``, no aux term for hybrid) or the nondiff metrics."""
    from repro.core import nondiff
    lg = jnp.asarray(logits)
    labels, mask = jnp.asarray(batch["labels"]), jnp.asarray(
        batch["loss_mask"])
    if objective == "ce":
        return jtr.lm_loss(jcfg, lg, labels, mask, 0.0)
    lg = lg[..., :jcfg.vocab_size]
    if objective == "accuracy":
        return nondiff.negative_accuracy(lg, labels, mask)
    keep = mask > 0
    pred = jnp.where(keep, jnp.argmax(lg, axis=-1), -1)
    return nondiff.negative_f1(pred, jnp.where(keep, labels, -1), pad_id=-1)


@pytest.mark.parametrize("objective", ["ce", "accuracy", "f1"])
def test_losses_match_jax(weights, jax_logits, objective):
    """``loss_fn(objective)`` on hybrid goes through the transformer as for
    dense: the port's loss against JAX's objective on JAX's logits."""
    jcfg, tcfg = _cfgs()
    batch, logits = jax_logits
    jl = _jax_objective(jcfg, objective, logits, batch)
    tl = bundle(tcfg).loss_fn(objective)(
        convert.params_from_jax(weights),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) < ATOL


def test_config_counts_and_defaults_equal_jax():
    t, j = all_archs()[ARCH], jax_archs()[ARCH]
    for tc, jc in ((t.cfg, j.cfg), (t.smoke_cfg, j.smoke_cfg)):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        assert tc.sub_quadratic == jc.sub_quadratic
        assert default_selection(tc) == jax_default_selection(jc) == "full"
        assert bundle(tc).default_selection() == "full"
    # JAX's analytic estimate, not the tree's element count (Queue 3)
    assert t.cfg.n_params() == 1_330_841_600
    shapes = jax.eval_shape(jax_bundle(j.cfg).init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == 21
    assert sum(int(np.prod(x.shape)) for x in leaves) == 1_433_039_264
    assert FAMILY_ARCHS == JAX_FAMILY_ARCHS
    assert FAMILY_ARCHS["hybrid"] == ARCH


def test_leaf_order_and_shapes_equal_jax(weights):
    """The port's own init has JAX's leaf paths in JAX's flatten order
    (attn, ln1, ln2, ln_ssm, mix, mlp, ssm), with JAX's shapes and dtypes;
    ``mix`` starts at 0.5, 0.5 in every layer."""
    _, tcfg = _cfgs()
    mine = flatten_with_path(bundle(tcfg).init(0, device="cpu"))
    theirs = jax.tree_util.tree_flatten_with_path(weights)[0]
    assert [p for p, _ in mine] == [jax.tree_util.keystr(k)
                                    for k, _ in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}"
    layer_keys = sorted({p.split("]")[1] + "]" for p, _ in mine
                         if p.startswith("['layers']")})
    assert layer_keys == ["['attn']", "['ln1']", "['ln2']", "['ln_ssm']",
                          "['mix']", "['mlp']", "['ssm']"]
    mix = dict(mine)["['layers']['mix']"]
    assert torch.equal(mix, torch.full((tcfg.n_layers, 2), 0.5))


@pytest.mark.parametrize("mode", ["prefix", "lora"])
def test_peft_forwards_on_hybrid(weights, mode):
    """The prefix forward's hybrid branch (the SSM side sees no prefix and
    a zero state): its logits against JAX's; LoRA on JAX's ``init_lora``
    tree: ``peft_loss_fn`` on the merged tree against JAX's."""
    jcfg, tcfg = _cfgs()
    key = jax.random.PRNGKey(8)
    if mode == "prefix":
        tree = jpeft.init_prefix(jcfg, key, m=3)
    else:
        tree = jpeft.init_lora(jcfg, key)
        # B starts at zero: give it values so the delta is not zero
        tree = jax.tree_util.tree_map_with_path(
            lambda p, x: (x + 0.05 if jax.tree_util.keystr(p).endswith(
                "['b']") else x), tree)
    tree = jax.tree.map(np.asarray, tree)
    batch = _batch(jcfg, seed=2, S=20)
    if mode == "lora":
        jl = jpeft.peft_loss_fn(jcfg, mode)(
            jpeft.peft_params(jax.tree.map(jnp.asarray, weights),
                              jax.tree.map(jnp.asarray, tree), mode),
            {k: jnp.asarray(v) for k, v in batch.items()})
        tl = tpeft.peft_loss_fn(tcfg, mode)(
            tpeft.peft_params(convert.params_from_jax(weights),
                              convert.params_from_jax(tree), mode),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(tl) - float(jl)) < ATOL
    else:
        jlg, _ = jpeft._forward_with_prefix(
            jcfg, jax.tree.map(jnp.asarray, weights),
            jax.tree.map(jnp.asarray, tree), {"tokens": batch["tokens"]})
        tlg, aux = tpeft._forward_with_prefix(
            tcfg, convert.params_from_jax(weights),
            convert.params_from_jax(tree),
            {"tokens": torch.from_numpy(batch["tokens"])})
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=ATOL,
                                   rtol=0)
        assert aux is None


def test_swa_ring_decode_far_past_window(weights):
    """Window 16: prefill 8 tokens, decode to position 40 through the
    registry (the ring wraps twice), the last logits against the full
    forward (whose mask limits to the window) within ``RING_TOL``, and
    against JAX's own prefill + decode chain within ``ATOL``."""
    jcfg, tcfg = _cfgs()
    T = 40
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(9), (1, T + 1),
                                         0, jcfg.vocab_size))
    tw, jw = convert.params_from_jax(weights), jax.tree.map(jnp.asarray,
                                                            weights)
    b = bundle(tcfg)
    full = ttr.forward(tcfg, tw, tokens=torch.from_numpy(toks)).logits
    _, (cache, state) = b.prefill_fn()(tw, {"tokens": torch.from_numpy(
        toks[:, :8])})
    assert cache["k"].shape[2] == tcfg.sliding_window
    jb = jax_bundle(jcfg)
    _, (jcache, jstate) = jax.jit(jb.prefill_fn())(jw, {
        "tokens": jnp.asarray(toks[:, :8])})
    dec, jdec = b.decode_fn(), jax.jit(jb.decode_fn())
    for t in range(8, T + 1):
        lg, (cache, state) = dec(tw, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "cache_pos": t,
            "cache": cache, "state": state})
        jlg, (jcache, jstate) = jdec(jw, {
            "token": jnp.asarray(toks[:, t:t + 1]), "cache_pos": jnp.int32(t),
            "cache": jcache, "state": jstate})
    V = tcfg.vocab_size
    np.testing.assert_allclose(lg[:, 0, :V].numpy(), full[:, T, :V].numpy(),
                               rtol=RING_TOL, atol=RING_TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                               rtol=0)
    assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                               atol=SSM_ATOL, rtol=0)


def test_ssm_state_crosses_convert(weights):
    """JAX's prefill state (a plain f32 array) into the port's decode, and
    the port's state back: JAX's next decode from either is the same
    within tolerance; ``init_ssm_state`` matches JAX's shape and dtype."""
    jcfg, tcfg = _cfgs()
    jw, tw = jax.tree.map(jnp.asarray, weights), convert.params_from_jax(weights)
    toks = _batch(jcfg, seed=3, B=1, S=9)["tokens"]
    _, (jcache, jstate) = jax_bundle(jcfg).prefill_fn()(
        jw, {"tokens": jnp.asarray(toks[:, :8])})
    st = convert.params_from_jax(np.asarray(jstate))
    assert st.dtype == torch.float32
    cache = convert.params_from_jax(jax.tree.map(np.asarray, jcache))
    lg, (_, st2) = bundle(tcfg).decode_fn()(tw, {
        "token": torch.from_numpy(toks[:, 8:9]), "cache_pos": 8,
        "cache": cache, "state": st})
    jlg, (_, jst2) = jax_bundle(jcfg).decode_fn()(jw, {
        "token": jnp.asarray(toks[:, 8:9]), "cache_pos": jnp.int32(8),
        "cache": jcache, "state": jstate})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL, rtol=0)
    back = convert.params_to_jax(st2)
    assert back.dtype == np.float32
    np.testing.assert_allclose(back, np.asarray(jst2), atol=SSM_ATOL, rtol=0)
    z = tssm.init_ssm_state(tcfg, 3)
    jz = jssm.init_ssm_state(jcfg, 3)
    assert tuple(z.shape) == jz.shape and z.dtype == torch.float32
    assert not bool(z.any())


@pytest.mark.parametrize("mode", ["chunk", "fused_recurrent"])
def test_train_cli_hybrid_family(tmp_path, capsys, mode):
    """``--model-family hybrid`` trains two steps in each scan mode and
    writes its ledger; ``launch.serve`` replays it and serves through the
    dense slab."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    run = tmp_path / "run"
    train_cli.main(["--model-family", "hybrid", "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "24",
                    "--scan-mode", mode, "--select", "auto",
                    "--ckpt-dir", str(run)])
    out = capsys.readouterr().out
    assert "hymba-1.5b-smoke" in out and "done: 2 steps" in out
    assert "--select auto -> 'full'" in out
    assert TrajectoryLedger.from_bytes(
        (run / "ledger.mzl").read_bytes()).steps == [0, 1]
    serve_cli.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                    "--ledger", str(run / "ledger.mzl"), "--requests", "2",
                    "--new-tokens", "12"])
    out = capsys.readouterr().out
    assert "replayed 2 ledger steps" in out and "dense slab" in out
    assert "a ring of the window 16" in out
