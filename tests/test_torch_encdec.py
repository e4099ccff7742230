"""Port parity of the encdec family (``models/encdec.py``, cross-attention,
``models/frontends.py``) and of the rest of the registry (``make_batch``,
``input_specs``, ``ShapeCell``) against the JAX package, on the smoke
configs in f32 on the CPU.

* ``encode`` and the teacher-forcing ``decode`` on JAX's batch and the
  same weights within ``ATOL``; ``prefill_fn`` + ``decode_fn`` step by step
  against teacher forcing (``tests/test_smoke_archs.py``'s tolerance) and
  against JAX's own chain within ``ATOL``;
* ``loss_fn("ce" | "accuracy" | "f1")`` on ``frames`` + ``tokens``;
* ``make_batch`` bitwise JAX's for every family (and the vision stub) in
  f32, and the stub normal in bf16 too;
* ``input_specs`` shapes and dtypes against JAX's ``ShapeDtypeStruct``s
  for every registered arch × its cells (``cells_for``), on the ``meta``
  device;
* ``n_params``, ``sinusoidal_embedding`` and the config equal JAX's;
  ``launch.train --model-family encdec`` exits naming the missing frames.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.models import encdec as jenc
from repro.models import frontends as jfront
from repro.models.common import sinusoidal_embedding as jax_sinusoidal
from repro.models.config import ALL_CELLS as JAX_CELLS
from repro.models.config import cells_for as jax_cells_for
from repro_torch import convert
from repro_torch.models import all_archs, bundle, family_arch
from repro_torch.models import encdec as tenc
from repro_torch.models import frontends as tfront
from repro_torch.models.common import sinusoidal_embedding
from repro_torch.models.config import ALL_CELLS, cells_for
from repro_torch.perturb.stream import prng_key

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

ARCH = "whisper-large-v3"
ATOL = 1e-4


def _cfgs(**replace):
    return (jax_archs()[ARCH].smoke_cfg.replace(**replace),
            all_archs()[ARCH].smoke_cfg.replace(**replace))


@pytest.fixture(scope="module")
def weights():
    """The port's seeded smoke θ as numpy for both sides."""
    return convert.params_to_jax(bundle(all_archs()[ARCH].smoke_cfg).init(
        0, device="cpu"))


@pytest.fixture(scope="module")
def jbatch():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jax_bundle(jcfg).make_batch(
        jax.random.PRNGKey(1), 2, 12))


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_encode_and_teacher_forcing_decode_match_jax(weights, jbatch):
    jcfg, tcfg = _cfgs()
    jw, tw = jax.tree.map(jnp.asarray, weights), convert.params_from_jax(weights)
    jenc_out = jax.jit(lambda w, f: jenc.encode(jcfg, w, f))(
        jw, jnp.asarray(jbatch["frames"]))
    tenc_out = tenc.encode(tcfg, tw, torch.from_numpy(jbatch["frames"]))
    np.testing.assert_allclose(tenc_out.numpy(), np.asarray(jenc_out),
                               atol=ATOL, rtol=0)
    jl = jax.jit(lambda w, f, t: jenc.forward_train(jcfg, w, f, t))(
        jw, jnp.asarray(jbatch["frames"]), jnp.asarray(jbatch["tokens"]))
    tl = tenc.forward_train(tcfg, tw, torch.from_numpy(jbatch["frames"]),
                            torch.from_numpy(jbatch["tokens"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    kv = tenc.precompute_cross_kv(tcfg, tw, tenc_out)
    assert tuple(kv["k"].shape) == (tcfg.n_layers, 2, 12, tcfg.kv_heads,
                                    tcfg.hd)


def test_incremental_decode_matches_teacher_forcing_and_jax(weights, jbatch):
    """``prefill_fn`` on the first token (a ``max_seq``-row cache and the
    cross K/V), then ``decode_fn`` token by token: the last logits against
    teacher forcing (JAX's own test's 2e-3) and against JAX's chain."""
    jcfg, tcfg = _cfgs()
    jw, tw = jax.tree.map(jnp.asarray, weights), convert.params_from_jax(weights)
    b, jb = bundle(tcfg), jax_bundle(jcfg)
    frames, toks = jbatch["frames"], jbatch["tokens"]
    S = toks.shape[1] - 1
    full = tenc.forward_train(tcfg, tw, torch.from_numpy(frames),
                              torch.from_numpy(toks))
    _, (cache, cross) = b.prefill_fn()(tw, {
        "frames": torch.from_numpy(frames), "tokens": torch.from_numpy(
            toks[:, :1])})
    assert cache["k"].shape[2] == tcfg.max_seq
    _, (jcache, jcross) = jax.jit(jb.prefill_fn())(jw, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :1])})
    jdec = jax.jit(jb.decode_fn())
    for t in range(1, S + 1):
        lg, cache = b.decode_fn()(tw, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "cache_pos": t,
            "cache": cache, "cross_kv": cross})
        jlg, jcache = jdec(jw, {"token": jnp.asarray(toks[:, t:t + 1]),
                                "cache_pos": jnp.int32(t), "cache": jcache,
                                "cross_kv": jcross})
    V = tcfg.vocab_size
    np.testing.assert_allclose(lg[:, 0, :V].numpy(), full[:, S, :V].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL, rtol=0)
    assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("objective", ["ce", "accuracy", "f1"])
def test_loss_fn_matches_jax(weights, jbatch, objective):
    jcfg, tcfg = _cfgs()
    jl = jax.jit(jax_bundle(jcfg).loss_fn(objective))(
        jax.tree.map(jnp.asarray, weights), jbatch)
    tl = bundle(tcfg).loss_fn(objective)(convert.params_from_jax(weights),
                                         _t(jbatch))
    assert abs(float(tl) - float(jl)) < ATOL
    if objective != "ce":
        assert -1.0 <= float(tl) <= 0.0


def _make_batch_cases():
    out = [pytest.param(f, None, id=f) for f in
           ("dense", "moe", "ssm", "hybrid", "encdec")]
    out.append(pytest.param("dense", "phi-3-vision-4.2b", id="vision_stub"))
    return out


@pytest.mark.parametrize("family,arch", _make_batch_cases())
def test_make_batch_bitwise_jax(family, arch):
    """``make_batch(key, 3, 7)`` in f32: frames / embeds, tokens, labels and
    the mask bit for bit JAX's, with JAX's dtypes."""
    tcfg = family_arch(family) if arch is None else all_archs()[arch].smoke_cfg
    jcfg = jax_archs()[tcfg.name.removesuffix("-smoke")].smoke_cfg
    want = jax_bundle(jcfg).make_batch(jax.random.PRNGKey(11), 3, 7)
    got = bundle(tcfg).make_batch(prng_key(11), 3, 7, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert np.array_equal(g.view(np.uint8), v.view(np.uint8)), k


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
def test_stub_normal_bf16(arch):
    """The stubs in bf16 (the full configs' dtype): JAX's eager
    ``normal(key, shape, bf16) * 0.02`` bit for bit — X1's bf16 table
    (the jitted graph of ``jax.random.normal``) times 0.02 rounded to bf16
    once, as JAX's weak-typed product; the frontends' functions are the
    registry's draw."""
    cfg = all_archs()[arch].smoke_cfg.replace(dtype="bfloat16")
    jcfg = jax_archs()[arch].smoke_cfg.replace(dtype="bfloat16")
    want = jax_bundle(jcfg).make_batch(jax.random.PRNGKey(3), 4, 33)
    got = bundle(cfg).make_batch(prng_key(3), 4, 33, device="cpu")
    name = "frames" if cfg.family == "encdec" else "embeds"
    assert got[name].dtype == torch.bfloat16
    assert np.array_equal(got[name].view(torch.int16).numpy().view(
        np.uint16), np.asarray(want[name]).view(np.uint16))
    k3 = jax.random.split(jax.random.PRNGKey(3), 3)[2]
    stub = (tfront.audio_stub_embeddings if cfg.family == "encdec"
            else tfront.vision_stub_embeddings)
    jstub = (jfront.audio_stub_embeddings if cfg.family == "encdec"
             else jfront.vision_stub_embeddings)
    from repro_torch.perturb.stream import split
    mine = stub(split(prng_key(3), 3)[2], 4, 33, cfg.d_model,
                torch.bfloat16, device="cpu")
    assert torch.equal(mine, got[name])
    theirs = np.asarray(jstub(k3, 4, 33, cfg.d_model, jnp.bfloat16))
    assert np.array_equal(theirs.view(np.uint16), np.asarray(
        want[name]).view(np.uint16))


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [(k + p, s) for k in sorted(tree)
                for p, s in _spec_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [(f"[{i}]" + p, s) for i, v in enumerate(tree)
                for p, s in _spec_leaves(v)]
    return [("", tree)]


@pytest.mark.parametrize("arch", sorted(jax_archs()))
def test_input_specs_match_jax(arch):
    """Every cell of ``cells_for``: the same tree of shapes and dtypes as
    JAX's ``ShapeDtypeStruct``s, on the ``meta`` device (nothing
    allocated)."""
    tcfg, jcfg = all_archs()[arch].cfg, jax_archs()[arch].cfg
    tcells, jcells = cells_for(tcfg), jax_cells_for(jcfg)
    assert [c.name for c in tcells] == [c.name for c in jcells]
    for tc, jc in zip(tcells, jcells):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        mine = _spec_leaves(bundle(tcfg).input_specs(tc))
        theirs = _spec_leaves(jax_bundle(jcfg).input_specs(jc))
        assert [p for p, _ in mine] == [p for p, _ in theirs], tc.name
        for (p, t), (_, j) in zip(mine, theirs):
            assert t.device.type == "meta", (tc.name, p)
            assert tuple(t.shape) == tuple(j.shape), (tc.name, p)
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype), \
                (tc.name, p)


def test_cells_counts_and_config_equal_jax():
    assert [dataclasses.asdict(c) for c in ALL_CELLS] == \
        [dataclasses.asdict(c) for c in JAX_CELLS]
    for arch in all_archs():
        t, j = all_archs()[arch], jax_archs()[arch]
        for tc, jc in ((t.cfg, j.cfg), (t.smoke_cfg, j.smoke_cfg)):
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
            assert tc.n_params() == jc.n_params()
            assert tc.sub_quadratic == jc.sub_quadratic
    shapes = jax.eval_shape(jax_bundle(jax_archs()[ARCH].cfg).init,
                            jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == 32
    assert sum(int(np.prod(x.shape)) for x in leaves) == 1_601_459_200
    assert all_archs()[ARCH].cfg.n_params() == 1_601_044_480
    _, tcfg = _cfgs()
    mine = [p for p, _ in _spec_leaves(bundle(tcfg).init(0, device="cpu"))]
    from repro_torch.tree_utils import flatten_with_path
    smoke = jax.eval_shape(jax_bundle(jax_archs()[ARCH].smoke_cfg).init,
                           jax.random.PRNGKey(0))
    assert [p for p, _ in flatten_with_path(bundle(tcfg).init(
        0, device="cpu"))] == [jax.tree_util.keystr(k) for k, _ in
                               jax.tree_util.tree_flatten_with_path(smoke)[0]]
    assert len(mine) == 32


@pytest.mark.parametrize("seq,d", [(12, 64), (1504, 1280)])
def test_sinusoidal_embedding_bitwise_jax(seq, d):
    got = sinusoidal_embedding(seq, d)
    want = np.asarray(jax_sinusoidal(seq, d))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_train_cli_encdec_exits_naming_frames():
    from repro_torch.launch import train as train_cli
    for argv in (["--model-family", "encdec"], ["--arch", ARCH]):
        with pytest.raises(SystemExit, match="frames"):
            train_cli.main(argv + ["--smoke", "--device", "cpu"])
