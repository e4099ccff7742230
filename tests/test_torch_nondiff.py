"""Port parity of the non-differentiable objectives (paper §3.3):

* ``core/nondiff``'s five functions equal JAX's exactly on shared numpy
  inputs (hypothesis over duplicates, pads, masks and all-pad rows, for
  batches of up to 8 rows; XLA:CPU sums a reduction of up to 32 elements
  left to right and computes a mean as the sum times 1/n, which the port
  writes out);
* ``Bundle.loss_fn("accuracy" | "f1")`` through the opt smoke forward (f32,
  a vocab that pads) equals JAX's — except where a position's top-two logit
  margin is under the forward tolerance, where the two argmaxes may
  differ: such positions are counted (none on these inputs);
* a port ``mezo`` spsa run on the accuracy objective writes JAX's ledger
  byte for byte and replays bitwise (replay ≡ replay ≡ JAX's replay of the
  same ledger, the live θ within JAX's own live-vs-replay bound); the
  fzoo run likewise writes JAX's ledger, and its replay is held to JAX's
  single-stream graph (the sequential per-stream fold) — JAX's jitted
  whole-ledger replay of a multi-stream record contracts otherwise, within
  1e-6, the graph behind the reference caveat
  ``test_accuracy_objective_trains_via_registry[fzoo-0.1]``.

The partitionable threefry layout is pinned on (the one the port
reproduces)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
torch = pytest.importorskip("torch")

from repro import zo as jzo
from repro.core import TrajectoryLedger as JaxLedger
from repro.core import nondiff as jnd
from repro.core import replay as jax_replay
from repro.data.pipeline import DataSpec as JaxSpec
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.train.loop import train as jax_train
from repro_torch import convert, zo
from repro_torch.core import TrajectoryLedger, nondiff, replay
from repro_torch.data import DataSpec, Pipeline
from repro_torch.models import OBJECTIVES, all_archs, bundle
from repro_torch.train import train

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

# the f32 forwards of the two frameworks agree within this (test_torch_model)
FWD_ATOL = 1e-4
# JAX's own bound between a live spsa run and its ledger's replay (f32)
LIVE_REPLAY_ATOL = 2e-6
# JAX's jitted replay of a multi-stream record against the per-stream fold
MULTI_REPLAY_ATOL = 1e-6
VOCAB = 250            # pads to 256: the [..., :V] slice matters
# positions of the batches below whose top-two margin is a near tie
NEAR_TIES = {"accuracy": 1, "f1": 0}


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _bits(t, j) -> bool:
    a, b = t.detach().numpy(), np.asarray(j)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


ids = st.integers(-1, 4)


@st.composite
def _pairs(draw):
    B = draw(st.integers(1, 8))
    T = draw(st.integers(1, 10))
    Tg = draw(st.integers(1, 10))
    p = np.array(draw(st.lists(ids, min_size=B * T, max_size=B * T)),
                 np.int32).reshape(B, T)
    g = np.array(draw(st.lists(ids, min_size=B * Tg, max_size=B * Tg)),
                 np.int32).reshape(B, Tg)
    pad = draw(st.sampled_from([0, -1]))
    if draw(st.booleans()):                    # an all-pad row on each side
        p[draw(st.integers(0, B - 1))] = pad
        g[draw(st.integers(0, B - 1))] = pad
    return p, g, pad


@settings(max_examples=80, deadline=None)
@given(_pairs())
def test_token_f1_and_negative_f1_equal_jax(case):
    p, g, pad = case
    tp, tg = torch.from_numpy(p), torch.from_numpy(g)
    assert _bits(nondiff.token_f1(tp, tg, pad),
                 jnd.token_f1(jnp.asarray(p), jnp.asarray(g), pad))
    assert _bits(nondiff.negative_f1(tp, tg, pad),
                 jnd.negative_f1(jnp.asarray(p), jnp.asarray(g), pad))


@st.composite
def _logits(draw):
    B = draw(st.integers(1, 6))
    T = draw(st.integers(1, 9))
    C = draw(st.integers(1, 7))
    # small integers: ties in the argmax (both take the first maximum)
    lg = np.array(draw(st.lists(st.integers(-3, 3), min_size=B * T * C,
                                max_size=B * T * C)),
                  np.float32).reshape(B, T, C)
    lab = np.array(draw(st.lists(st.integers(0, C - 1), min_size=B * T,
                                 max_size=B * T)), np.int32).reshape(B, T)
    mask = draw(st.sampled_from(["none", "random", "zeros"]))
    m = None
    if mask != "none":
        bits = draw(st.lists(st.booleans(), min_size=B * T, max_size=B * T))
        m = np.array(bits if mask == "random" else [False] * (B * T),
                     np.float32).reshape(B, T)
    return lg, lab, m


@settings(max_examples=150, deadline=None)
@given(_logits())
def test_negative_accuracy_equals_jax(case):
    lg, lab, m = case
    got = nondiff.negative_accuracy(
        torch.from_numpy(lg), torch.from_numpy(lab),
        None if m is None else torch.from_numpy(m))
    want = jnd.negative_accuracy(jnp.asarray(lg), jnp.asarray(lab),
                                 None if m is None else jnp.asarray(m))
    assert _bits(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_objective_wrappers_equal_jax(masked):
    rng = np.random.default_rng(4)
    lg = rng.standard_normal((3, 5, 6)).astype(np.float32)
    lab = rng.integers(0, 6, (3, 5)).astype(np.int32)
    gold = rng.integers(0, 4, (3, 4)).astype(np.int32)
    batch = {"logits": lg, "labels": lab, "gold_ids": gold}
    if masked:
        batch["loss_mask"] = (rng.random((3, 5)) < 0.5).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jacc = jnd.make_accuracy_objective(lambda p, b: b["logits"])
    tacc = nondiff.make_accuracy_objective(lambda p, b: b["logits"])
    assert _bits(tacc(None, tb), jacc(None, jb))
    jf1 = jnd.make_f1_objective(lambda p, b: jnp.argmax(b["logits"], -1))
    tf1 = nondiff.make_f1_objective(lambda p, b: torch.argmax(b["logits"],
                                                              -1))
    assert _bits(tf1(None, tb), jf1(None, jb))


# --------------------------------------------------------------------------- #
# Bundle.loss_fn(objective) through the opt smoke forward
# --------------------------------------------------------------------------- #
def _opt_pair():
    jcfg = jax_archs()["opt-13b"].smoke_cfg.replace(vocab_size=VOCAB)
    tcfg = all_archs()["opt-13b"].smoke_cfg.replace(vocab_size=VOCAB)
    w = jax.tree.map(np.asarray, jax_bundle(jcfg).init(jax.random.PRNGKey(0)))
    return jax_bundle(jcfg), bundle(tcfg), w


@pytest.mark.parametrize("objective,kind", [("accuracy", "prompt_cls"),
                                            ("f1", "span")])
def test_registry_objective_equals_jax(objective, kind):
    jb, tb, w = _opt_pair()
    assert OBJECTIVES == ("ce", "accuracy", "f1")
    batch = JaxPipeline(JaxSpec(kind, batch=8, vocab=VOCAB, seed=2)).batch(0)
    jbatch = {k: v for k, v in batch.items() if k in ("tokens", "labels",
                                                      "loss_mask")}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    jw = jax.tree.map(jnp.asarray, w)
    tw = convert.params_from_jax(w)
    # near ties: positions whose top-two logit margin (JAX's forward) is
    # under twice the forward tolerance, where the argmaxes may differ
    lg = np.asarray(jb.train_logits_fn()(jw, jbatch))[..., :VOCAB]
    top2 = np.sort(lg, axis=-1)[..., -2:]
    near = top2[..., 1] - top2[..., 0] < 2 * FWD_ATOL
    assert int(near.sum()) == NEAR_TIES[objective]
    tpred = tb.train_logits_fn()(tw, tbatch)[..., :VOCAB].argmax(-1).numpy()
    assert np.array_equal(tpred[~near], lg.argmax(-1)[~near])
    # on these inputs the near ties resolve alike too
    assert np.array_equal(tpred, lg.argmax(-1))
    assert tb.train_logits_fn()(tw, tbatch).shape[-1] == 256
    want = jb.loss_fn(objective)(jw, jbatch)
    got = tb.loss_fn(objective)(tw, tbatch)
    assert _bits(got, want)
    assert -1.0 <= float(got) <= 0.0
    with pytest.raises(ValueError, match="objective"):
        tb.loss_fn("rouge")


def test_padded_vocab_columns_never_win_the_argmax():
    _, tb, w = _opt_pair()
    tw = convert.params_from_jax(w)
    # the final norm's output is its bias (scale 0) = 1 at every position,
    # so a padded column of ones scores d = 64 against real columns' ~N(0, 1)
    tw["ln_f"]["scale"].zero_()
    tw["ln_f"]["bias"].fill_(1.0)
    tw["head"][:, VOCAB:] = 1.0
    batch = Pipeline(DataSpec("prompt_cls", batch=4, vocab=VOCAB, seed=1),
                     device="cpu").batch(0)
    lg = tb.train_logits_fn()(tw, batch)
    assert int(lg.argmax(-1).min()) >= VOCAB    # unsliced: padding wins
    for objective in ("accuracy", "f1"):
        v = float(tb.loss_fn(objective)(tw, batch))
        assert -1.0 <= v <= 0.0


# --------------------------------------------------------------------------- #
# A run on the accuracy objective: JAX's ledger, replayed bitwise
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("estimator", ["spsa", "fzoo"])
def test_accuracy_run_writes_jax_ledger_and_replays_bitwise(estimator):
    jcfg = jax_archs()["opt-13b"].smoke_cfg
    tcfg = all_archs()["opt-13b"].smoke_cfg
    w = jax.tree.map(np.asarray, jax_bundle(jcfg).init(jax.random.PRNGKey(0)))

    def make(m):
        return (m.mezo(lr=3e-2, eps=1e-1) if estimator == "spsa" else
                m.fzoo(lr=1e-1, eps=1e-1, batch_seeds=4))

    jopt, topt = make(jzo), make(zo)
    spec = dict(batch=8, vocab=256, seed=1)
    jled = JaxLedger(base_seed=0, grad_dtype="float32",
                     backend=jopt.backend_name, batch_seeds=jopt.batch_seeds)
    tled = TrajectoryLedger(base_seed=0, grad_dtype="float32",
                            backend=topt.backend_name,
                            batch_seeds=topt.batch_seeds)
    jres = jax_train(jax_bundle(jcfg).loss_fn("accuracy"),
                     jax.tree.map(jnp.asarray, w), jopt,
                     JaxPipeline(JaxSpec("prompt_cls", **spec)),
                     total_steps=6, ledger=jled, seed=0, log_every=1)
    tres = train(bundle(tcfg).loss_fn("accuracy"), convert.params_from_jax(w),
                 topt, Pipeline(DataSpec("prompt_cls", **spec),
                                device="cpu"),
                 total_steps=6, ledger=tled, seed=0, log_every=1)
    assert [float(v) for _, v in tres.losses] == \
        [float(v) for _, v in jres.losses]
    raw = tled.to_bytes()
    assert raw == jled.to_bytes()                # g's: discrete, equal
    assert np.any(np.asarray(tled.grads) != 0)   # the run saw a signal
    r1 = replay(convert.params_from_jax(w), tled, make(zo))
    r2 = replay(convert.params_from_jax(w), TrajectoryLedger.from_bytes(raw),
                make(zo))
    want = jax_replay(jax.tree.map(jnp.asarray, w),
                      JaxLedger.from_bytes(raw), make(jzo))
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want))
    live = jax.tree_util.tree_leaves(convert.params_to_jax(tres.params))
    got1 = jax.tree_util.tree_leaves(convert.params_to_jax(r1))
    got2 = jax.tree_util.tree_leaves(convert.params_to_jax(r2))
    for a, b, c, v in zip(got1, got2, want, live):
        assert a.tobytes() == b.tobytes()                     # replay ≡ replay
        if estimator == "spsa":
            assert a.tobytes() == c.tobytes()                 # ≡ JAX's
        else:
            assert np.max(np.abs(a - c)) <= MULTI_REPLAY_ATOL
        assert np.max(np.abs(a - v)) <= LIVE_REPLAY_ATOL      # live ≈ replay
