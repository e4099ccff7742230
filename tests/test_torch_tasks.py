"""Port parity of the synthetic tasks: JAX's key and uniform helpers
(``split``, ``uniform``, ``bernoulli``), ``PromptClassification`` (prompt
on and off, 2 and 3 classes, ``icl_batch``) and ``SpanExtraction``
batches, each bitwise JAX's at vocab 256 and 50 272; the ``prompt_cls``
and ``span`` pipeline kinds; and ``launch.train --objective accuracy|f1``
on the CPU for the smoke OPT and RoBERTa.  The partitionable threefry
layout is pinned on (the one the port reproduces)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.data import synthetic as jsyn
from repro.data.pipeline import DataSpec as JaxSpec
from repro.data.pipeline import Pipeline as JaxPipeline
from repro_torch.data import (DataSpec, Pipeline, PromptClassification,
                              SpanExtraction)
from repro_torch.data.synthetic import bernoulli, split, uniform
from repro_torch.perturb.stream import prng_key

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

VOCABS = [256, 50_272]


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _same(jbatch: dict, tbatch: dict) -> None:
    assert set(jbatch) == set(tbatch)
    for k, want in jbatch.items():
        got = tbatch[k]
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            got = got.numpy()
            assert got.dtype == want.dtype, k
            assert np.array_equal(got, want), k
        else:
            assert got == want, k


@pytest.mark.parametrize("seed", [0, 5, -7, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_split_is_jax_split(seed, n):
    want = [tuple(int(v) for v in k)
            for k in np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))]
    assert split(prng_key(seed), n) == want


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 77), (2, 5, 9)])
@pytest.mark.parametrize("p", [0.0, 0.3, 0.8, 1.0])
def test_uniform_and_bernoulli_are_jax_bitwise(shape, p):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    tkey = tuple(int(v) for v in np.asarray(key))
    u = uniform(tkey, shape)
    want = np.asarray(jax.random.uniform(key, shape))
    assert u.dtype == torch.float32
    assert np.array_equal(u.numpy().view(np.uint32), want.view(np.uint32))
    assert np.array_equal(bernoulli(tkey, p, shape).numpy(),
                          np.asarray(jax.random.bernoulli(key, p, shape)))


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("prompt", [True, False])
def test_prompt_classification_batches_are_jax_bitwise(vocab, n_classes,
                                                       prompt):
    kw = dict(vocab=vocab, n_classes=n_classes, seed=3, prompt=prompt)
    jt, tt = jsyn.PromptClassification(**kw), PromptClassification(**kw)
    assert tt.seq_len == jt.seq_len == 32
    for step in (0, 1, 9):
        _same(jt.batch_for_step(step, 7), tt.batch_for_step(step, 7))
    key = jax.random.PRNGKey(21)
    tkey = prng_key(21)
    _same(jt.sample(key, 5), tt.sample(tkey, 5))
    assert np.array_equal(tt.label_word(torch.arange(n_classes)).numpy(),
                          np.asarray(jt.label_word(jnp.arange(n_classes))))


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("k_shots", [0, 1, 4])
def test_icl_batch_is_jax_bitwise(vocab, k_shots):
    jt = jsyn.PromptClassification(vocab=vocab, seed=2)
    tt = PromptClassification(vocab=vocab, seed=2)
    _same(jt.icl_batch(jax.random.PRNGKey(9), 6, k_shots),
          tt.icl_batch(prng_key(9), 6, k_shots))


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("seed", [0, 4])
def test_span_extraction_batches_are_jax_bitwise(vocab, seed):
    jt = jsyn.SpanExtraction(vocab=vocab, seed=seed)
    tt = SpanExtraction(vocab=vocab, seed=seed)
    assert tt.seq_len == jt.seq_len == 30
    for step in (0, 3):
        _same(jt.batch_for_step(step, 9), tt.batch_for_step(step, 9))
    b = tt.batch_for_step(0, 9)
    gold = b["tokens"][:, -tt.span_len:]
    assert torch.equal(gold, b["gold_ids"])
    assert int(b["in_span"].sum()) == 9 * tt.span_len


def test_eval_accuracy_and_icl_equal_jax():
    """The label-word accuracy of both evaluations through the same logits
    function (a fixed random table indexed by the last token)."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((256, 256)).astype(np.float32)
    jt = jsyn.PromptClassification(seed=1)
    tt = PromptClassification(seed=1)

    def jlogits(params, batch):
        return jnp.asarray(table)[batch["tokens"]]

    def tlogits(params, batch):
        return torch.from_numpy(table)[batch["tokens"].long()]

    assert tt.eval_accuracy(None, tlogits, None, prng_key(3), n=64) == \
        jt.eval_accuracy(None, jlogits, None, jax.random.PRNGKey(3), n=64)
    assert tt.eval_icl(None, tlogits, None, prng_key(4), k_shots=2, n=32) \
        == jt.eval_icl(None, jlogits, None, jax.random.PRNGKey(4), k_shots=2,
                       n=32)


@pytest.mark.parametrize("kind", ["lm", "prompt_cls", "span"])
def test_pipeline_kinds_are_jax_bitwise(kind):
    kw = dict(batch=4, seq=16, vocab=256, seed=6)
    jp = JaxPipeline(JaxSpec(kind, **kw))
    tp = Pipeline(DataSpec(kind, **kw), device="cpu")
    assert tp.seq_len == jp.seq_len
    for step in (0, 2):
        jb, tb = jp.batch(step), tp.batch(step)
        _same(jb, tb)
        assert all(v.device.type == "cpu" for v in tb.values()
                   if isinstance(v, torch.Tensor))
    assert torch.equal(tp.batch(2)["tokens"], tp.batch(2)["tokens"])


@pytest.mark.parametrize("arch", ["opt-13b", "roberta-large"])
@pytest.mark.parametrize("objective", ["accuracy", "f1"])
def test_train_cli_trains_a_nondiff_objective_on_cpu(arch, objective,
                                                     capsys):
    from repro_torch.launch import train as train_cli
    train_cli.main(["--smoke", "--device", "cpu", "--arch", arch,
                    "--objective", objective, "--batch", "4", "--seq", "8",
                    "--steps", "2"])
    out = capsys.readouterr().out
    assert f"objective={objective}" in out and "done: 2 steps" in out
    assert "ledger: 2 entries" in out
    final = float(out.split("final loss ")[1].split()[0])
    assert -1.0 <= final <= 0.0          # −accuracy and −F1 lie in [−1, 0]


def test_train_cli_refuses_a_nondiff_objective_without_zo():
    from repro_torch.launch import train as train_cli
    with pytest.raises(SystemExit, match="non-differentiable"):
        train_cli.main(["--smoke", "--device", "cpu", "--objective", "f1",
                        "--optimizer", "sgd"])
    with pytest.raises(SystemExit, match="not a ported config"):
        train_cli.main(["--smoke", "--device", "cpu", "--arch",
                        "hymba-1.5b"])
