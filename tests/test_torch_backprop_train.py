"""The backprop baselines through the port's training stack, against JAX's:
``train.loop.train`` with ``Adam`` / SGD, its checkpoints, the step
program's pass-through and the launcher.

* 4 steps of ``train()`` on the qwen2-0.5b smoke config (f32, lm batches
  that are JAX's bits) give JAX's losses within 1e-5 and, under SGD, JAX's
  θ within 1e-5; under Adam all but 0.1 % of θ's elements within 1e-6 (an
  element whose gradient is near 0 has its step set by the gradient's
  sign, which the summation order can flip): the forwards and backwards
  are f32 sums in each framework's order, the update arithmetic is held
  separately (``test_torch_adam.py``).
* Resuming from a step-2 checkpoint equals the uninterrupted run, bitwise
  (θ, m, v, losses).
* A checkpoint JAX's ``CheckpointManager`` wrote for ``Adam`` (bf16 θ, so
  m and v are f32 after a step; SGD's ``()`` fields) restores in the port
  bitwise, and the port continues it.
* The protocol test of ``tests/test_zo_api.py`` for ``backprop_adam``.
* JAX's refusals with JAX's messages: a ledger with a backprop baseline, a
  non-local plan; ``StepProgram.meta`` is all None in both packages.
* ``launch.train --optimizer adam|sgd`` trains and resumes on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import exec as jexec
from repro.checkpoint.manager import CheckpointManager as JaxCkpt
from repro.core import TrajectoryLedger as JaxLedger
from repro.data.pipeline import DataSpec as JaxSpec
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.train.adam import Adam as JaxAdam
from repro.train.adam import AdamConfig as JaxAdamConfig
from repro.train.loop import train as jax_train
from repro_torch import convert
from repro_torch import exec as texec
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import TrajectoryLedger
from repro_torch.data import DataSpec, Pipeline
from repro_torch.models import all_archs, bundle
from repro_torch.train import Adam, AdamConfig, FailureInjector, train
from repro_torch.tree_utils import tree_leaves

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-5
ADAM_ATOL, ADAM_OUTLIERS = 1e-6, 1e-3
CONFIGS = {
    "adam": dict(lr=1e-3, total_steps=8),
    "sgd": dict(lr=1e-2, sgd=True, total_steps=8),
    "sgd_momentum": dict(lr=1e-2, sgd=True, momentum=0.9,
                         weight_decay=0.01, total_steps=8),
}


def _setup(dtype="float32"):
    jcfg = jax_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype=dtype)
    tcfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype=dtype)
    w = jax.tree.map(np.asarray, jax_bundle(jcfg).init(jax.random.PRNGKey(0)))
    jpipe = JaxPipeline(JaxSpec("lm", batch=4, seq=16, vocab=256, seed=5))
    tpipe = Pipeline(DataSpec("lm", batch=4, seq=16, vocab=256, seed=5),
                     device="cpu")
    return jcfg, tcfg, w, jpipe, tpipe


def _np(x) -> np.ndarray:
    return convert._to_numpy(x) if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _same(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_train_gives_jax_losses_and_params(kind):
    jcfg, tcfg, w, jpipe, tpipe = _setup()
    jres = jax_train(jax_bundle(jcfg).loss_fn(), jax.tree.map(jnp.asarray, w),
                     JaxAdam(JaxAdamConfig(**CONFIGS[kind])), jpipe,
                     total_steps=4, log_every=1)
    tres = train(bundle(tcfg).loss_fn(), convert.params_from_jax(w),
                 Adam(AdamConfig(**CONFIGS[kind])), tpipe, total_steps=4,
                 log_every=1)
    assert [s for s, _ in tres.losses] == [s for s, _ in jres.losses]
    for (_, a), (_, b) in zip(jres.losses, tres.losses):
        assert abs(a - b) < LOSS_ATOL, (jres.losses, tres.losses)
    gap = np.concatenate([np.abs(np.asarray(a) - b.numpy()).ravel()
                          for a, b in zip(jax.tree_util.tree_leaves(
                              jres.params), tree_leaves(tres.params))])
    if kind == "adam":
        # Adam divides each element's step by its gradient's RMS, so where a
        # gradient is near 0 the frameworks' f32 summation gap becomes a
        # step gap (up to 2η a step): all but a few elements hold
        eta = CONFIGS[kind]["lr"]
        assert gap.max() <= 2 * eta * 4
        assert np.mean(gap > ADAM_ATOL) < ADAM_OUTLIERS
    else:
        assert gap.max() < PARAM_ATOL
    assert int(tres.opt_state.step) == int(jres.opt_state.step) == 4


@pytest.mark.parametrize("kind", ["adam", "sgd_momentum"])
def test_resume_from_a_checkpoint_is_the_uninterrupted_run(tmp_path, kind):
    _, tcfg, w, _, tpipe = _setup()
    loss_fn = bundle(tcfg).loss_fn()

    def run(**kw):
        return train(loss_fn, convert.params_from_jax(w),
                     Adam(AdamConfig(**CONFIGS[kind])), tpipe,
                     total_steps=4, log_every=1, **kw)

    ref = run()
    ck = CheckpointManager(str(tmp_path / "run"), interval=2)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        run(ckpt=ck, injector=FailureInjector(fail_at_step=3))
    assert ck.steps() == [2]
    res = run(ckpt=CheckpointManager(str(tmp_path / "run"), interval=2))
    assert res.resumed_from == 2 and res.steps_run == 2
    assert res.losses == ref.losses[2:]
    got = tree_leaves((res.params, res.opt_state))
    want = tree_leaves((ref.params, ref.opt_state))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert _same(a, b)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_a_jax_written_checkpoint_restores(tmp_path, kind):
    """bf16 θ: JAX's m and v are f32 in its checkpoint after two steps, and
    SGD's () fields have no leaves; the port restores every leaf with JAX's
    bits and dtype, then continues from step 2."""
    jcfg, tcfg, w, jpipe, tpipe = _setup("bfloat16")
    run = str(tmp_path / "run")
    jres = jax_train(jax_bundle(jcfg).loss_fn(), jax.tree.map(jnp.asarray, w),
                     JaxAdam(JaxAdamConfig(**CONFIGS[kind])), jpipe,
                     total_steps=2, ckpt=JaxCkpt(run, interval=2))
    ck = CheckpointManager(run, interval=2)
    opt = Adam(AdamConfig(**CONFIGS[kind]))
    like = convert.params_from_jax(w)
    restored = ck.restore_latest(like, opt.init(like))
    assert restored["step"] == 2 and restored["meta"]["perturb_backend"] \
        is None
    got = tree_leaves((restored["params"], restored["opt_state"]))
    want = jax.tree_util.tree_leaves((jres.params, jres.opt_state))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert _same(a, b)
    if kind != "sgd":
        assert all(m.dtype == torch.float32
                   for m in tree_leaves(restored["opt_state"].m))
    res = train(bundle(tcfg).loss_fn(), convert.params_from_jax(w), opt,
                tpipe, total_steps=4, ckpt=ck, log_every=1)
    assert res.resumed_from == 2 and int(res.opt_state.step) == 4
    assert all(np.isfinite(loss) for _, loss in res.losses)


# --------------------------------------------------------------------------- #
# The protocol, the step program and the loop's refusals, as in JAX
# --------------------------------------------------------------------------- #
TARGET = {"a": np.linspace(-1, 1, 12).astype(np.float32),
          "b": np.arange(15, dtype=np.float32).reshape(3, 5) / 7}


def _protocol_loss(p, batch):
    return 0.5 * sum(torch.sum((x - torch.from_numpy(y)) ** 2) for x, y in
                     zip(tree_leaves(p), tree_leaves(TARGET)))


@pytest.mark.parametrize("config", [
    dict(lr=1e-2, total_steps=100),
    dict(lr=1e-2, sgd=True, momentum=0.9, total_steps=100)],
    ids=["backprop_adam", "backprop_sgd"])
def test_protocol_init_step_restore_roundtrip(config):
    """``tests/test_zo_api.py``'s protocol test on the port's baselines: a
    step counter that counts, ``restore`` that realigns it and touches
    nothing else, and a restored state that still steps."""
    opt = Adam(AdamConfig(**config))
    params = {k: torch.ones(v.shape) for k, v in TARGET.items()}
    state = opt.init(params, seed=0)
    assert int(state.step) == 0
    step = opt.step_fn(_protocol_loss)
    for k in range(3):
        params, state, metrics = step(params, state, None)
        assert int(state.step) == k + 1
        assert "loss" in metrics and "lr" in metrics
    restored = opt.restore(state, 11)
    assert int(restored.step) == 11
    for a, b in zip(tree_leaves(state)[1:], tree_leaves(restored)[1:]):
        assert torch.equal(a, b)
    _, s2, _ = step(params, restored, None)
    assert int(s2.step) == 12


def test_a_ledger_with_a_backprop_baseline_raises_jax_message():
    jcfg, tcfg, w, jpipe, tpipe = _setup()
    with pytest.raises(ValueError) as jerr:
        jax_train(jax_bundle(jcfg).loss_fn(), jax.tree.map(jnp.asarray, w),
                  JaxAdam(JaxAdamConfig()), jpipe, total_steps=1,
                  ledger=JaxLedger(base_seed=0, grad_dtype="float32"))
    with pytest.raises(ValueError) as terr:
        train(bundle(tcfg).loss_fn(), convert.params_from_jax(w),
              Adam(AdamConfig()), tpipe, total_steps=1,
              ledger=TrajectoryLedger(base_seed=0, grad_dtype="float32"))
    assert str(terr.value) == str(jerr.value)
    assert "ledger recording requires a ZO optimizer" in str(terr.value)


def test_step_program_passes_a_backprop_baseline_through_like_jax():
    jprog = jexec.StepProgram(JaxAdam(JaxAdamConfig()))
    tprog = texec.StepProgram(Adam(AdamConfig()))
    assert tprog.meta == jprog.meta
    assert set(tprog.meta.values()) == {None}
    assert not tprog.is_zo and tprog.opt.config == AdamConfig()
    with pytest.raises(ValueError) as jerr:
        jexec.StepProgram(JaxAdam(JaxAdamConfig()), jexec.seed_parallel(2))
    with pytest.raises(ValueError) as terr:
        texec.StepProgram(Adam(AdamConfig()), texec.seed_parallel(2))
    assert str(terr.value) == str(jerr.value)
    assert "not a seed-replayable ZO optimizer" in str(terr.value)


def test_sgd_state_round_trips_through_a_checkpoint(tmp_path):
    """SGD's () fields write no leaves and come back as (); momentum's m
    comes back in the dtype it was saved in."""
    _, tcfg, _, _, _ = _setup("bfloat16")
    params = bundle(tcfg).init(0, device="cpu")
    ck = CheckpointManager(str(tmp_path), interval=1)
    for config in (dict(sgd=True), dict(sgd=True, momentum=0.9)):
        opt = Adam(AdamConfig(**config))
        state = opt.init(params)
        step = opt.step_fn(bundle(tcfg).loss_fn())
        toks = torch.zeros((2, 8), dtype=torch.int32)
        params, state, _ = step(params, state, {"tokens": toks,
                                                "labels": toks})
        ck.maybe_save(1, params, state, meta={"perturb_backend": None},
                      force=True)
        back = ck.restore_latest(params, opt.init(params))["opt_state"]
        assert back.v == () and int(back.step) == 1
        if config.get("momentum"):
            assert all(a.dtype == torch.float32 and torch.equal(a, b)
                       for a, b in zip(tree_leaves(back.m),
                                       tree_leaves(state.m)))
        else:
            assert back.m == ()


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_train_cli_trains_and_resumes_on_cpu(tmp_path, capsys, optimizer):
    from repro_torch.launch import train as train_cli
    run = str(tmp_path / "run")
    base = ["--smoke", "--device", "cpu", "--optimizer", optimizer,
            "--batch", "4", "--seq", "16", "--ckpt-dir", run,
            "--ckpt-interval", "2"]
    train_cli.main(base + ["--steps", "3"])
    out = capsys.readouterr().out
    assert f"optimizer={optimizer}" in out and "device=cpu" in out
    assert "done: 3 steps (resumed from 0)" in out and "ledger" not in out
    train_cli.main(base + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "done: 2 steps (resumed from 3)" in out
    assert not os.path.exists(os.path.join(run, "ledger.mzl"))
