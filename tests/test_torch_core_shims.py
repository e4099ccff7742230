"""The deprecated optimizer shims and the legacy-config interop — the port
of ``repro.core.{mezo,mezo_adam,mezo_variants}``, ``zo.from_config``,
``zo.Optimizer`` and ``repro.core``'s lazy exports — against the port's
presets and the JAX package on the CPU.

What holds bitwise: every shim's steps against the preset it wraps (the
port's own ``zo.mezo`` / ``zo.mezo_adam`` / ``zo.mezo_rescaled``), a bare
config through ``exec.StepProgram`` and ``core.replay`` (the preset's
replay), a JAX-trained shim ledger replayed in the port through a bare
``MeZOConfig`` (JAX's replay), ``apply_projected_update`` against JAX's
jitted one, the jitted ``lr_at`` under every schedule, and a shim's
crash-and-resume against the preset's.  A replay is held to the trained θ
within ``REPLAY_ATOL``: the sequential chain restores θ through
θ − εz + εz, which rounds.  What holds within a tolerance: JAX's ``lr_at`` called outside
``jit`` divides by the step count where the jitted graph (and the port)
multiplies by its f32 reciprocal — within 2⁻²² of the base lr
(``EAGER_LR_TOL``; ROADMAP Queue 3);
and a whole JAX step against the port's (``LOSS_RTOL`` on the logged
loss): XLA fuses the user's loss into the step and contracts ℓ₊ − ℓ₋ into
an FMA, so g, and the trajectory, are held through the ledger instead.

The partitionable threefry layout is pinned on (the one the port
reproduces).
"""
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.core as jcore
from repro import zo as jzo
from repro.data.pipeline import DataSpec as JaxSpec
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.train.adam import Adam as JaxAdam
from repro.train.adam import AdamConfig as JaxAdamConfig
from repro.train.loop import train as jax_train
from repro_torch import convert, core, zo
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import (MeZO, MeZOAdam, MeZOAdamConfig, MeZOConfig,
                              MeZOVariant, MeZOVariantConfig,
                              TrajectoryLedger, apply_projected_update,
                              replay)
from repro_torch.data import DataSpec, Pipeline
from repro_torch.exec import StepProgram, as_step_program
from repro_torch.exec import plan as plan_mod
from repro_torch.perturb import StreamRef, get_backend
from repro_torch.perturb.stream import fold_in, prng_key
from repro_torch.train import Adam, AdamConfig, FailureInjector, train
from repro_torch.tree_utils import tree_leaves, tree_max_abs_diff

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

LOSS_RTOL = 1e-5
# a replayed θ against the live chain's (θ − εz + εz rounds in f32), as
# JAX's own crash-resume test holds it
REPLAY_ATOL = 1e-5
# t's one ulp (≤ 2⁻²⁴ for t < 1) carried through η = lr·(1 − t) (times up
# to π/2 through the cosine), plus the ops' own roundings: 2⁻²² of the
# base lr
EAGER_LR_TOL = 2.0 ** -22
SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _arrays(dtype=np.float32):
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal(12).astype(dtype),
            "b": rng.standard_normal((3, 5)).astype(dtype)}


def _params(dtype=torch.float32):
    """θ₀ drawn with numpy, brought across as JAX's arrays are."""
    return {k: v.to(dtype) for k, v in
            convert.params_from_jax(_arrays()).items()}


TARGET = {k: np.random.default_rng(1).standard_normal(v.shape).astype(
    np.float32) for k, v in _arrays().items()}


def loss_fn(p, batch):
    return 0.5 * sum(((p[k].float() - torch.from_numpy(TARGET[k])) ** 2)
                     .sum() for k in sorted(p))


def jax_loss(p, batch):
    return 0.5 * sum(jnp.sum((p[k] - TARGET[k]) ** 2) for k in sorted(p))


def _same(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.element_size() == 4
                           else x.view(torch.int16),
                           y.view(torch.int32) if y.element_size() == 4
                           else y.view(torch.int16))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _run(opt, state, steps, params=None, lf=loss_fn):
    p = _params() if params is None else params
    step = opt.step_fn(lf)
    metrics = []
    for _ in range(steps):
        p, state, m = step(p, state, None)
        metrics.append((float(m["projected_grad"]), float(m["lr"])))
    return p, metrics


# --------------------------------------------------------------------------- #
# repro.core's exports
# --------------------------------------------------------------------------- #
def test_core_all_equals_jax_and_every_name_resolves():
    assert core.__all__ == jcore.__all__
    assert dir(core) == sorted(set(jcore.__all__))
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    from repro_torch.core import perturb as cperturb
    from repro_torch.perturb import stream, xla
    assert core.perturb_params is cperturb.perturb is xla.perturb
    for name in ("leaf_key", "sample_leaf_z", "sample_z_tree",
                 "fused_restore_update", "perturb_jit", "_sphere_scale"):
        assert getattr(cperturb, name) is getattr(xla, name), name
    assert core.step_key is stream.step_key
    assert core.apply_rank1 is zo.apply_rank1
    assert core.Optimizer is zo.Optimizer
    assert core.MeZOState is core.MeZOAdamState is zo.ZOState
    assert core.nondiff.__name__ == "repro_torch.core.nondiff"
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        core.nope


@pytest.mark.parametrize("first", ["repro_torch.core", "repro_torch.zo"])
def test_either_package_imports_first_without_a_cycle(first):
    other = ({"repro_torch.core", "repro_torch.zo"} - {first}).pop()
    code = (f"import {first}; import {other}\n"
            "from repro_torch.core import MeZO, spsa_projected_grad, "
            "nondiff\n"
            "from repro_torch.zo import from_config, Optimizer\n"
            "import repro_torch.core as c\n"
            "assert isinstance(c.MeZO(c.MeZOConfig()), Optimizer)\n"
            "import sys; assert 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=SRC),
                         timeout=120)
    assert out.returncode == 0, out.stderr


# --------------------------------------------------------------------------- #
# The protocol and the init forms
# --------------------------------------------------------------------------- #
def test_optimizer_protocol_holds_for_every_optimizer():
    for opt in (zo.mezo(), MeZO(MeZOConfig()), MeZOAdam(MeZOAdamConfig()),
                MeZOVariant(MeZOVariantConfig()), Adam(AdamConfig()),
                Adam(AdamConfig(sgd=True, momentum=0.9)),
                StepProgram(MeZOConfig())):
        assert isinstance(opt, zo.Optimizer), type(opt).__name__
    assert not isinstance(object(), zo.Optimizer)
    assert not isinstance(MeZOConfig(), zo.Optimizer)


def test_init_takes_the_legacy_and_the_protocol_forms():
    shim, preset = MeZO(MeZOConfig()), zo.mezo()
    want = preset.init(_params(), seed=7)
    for got in (shim.init(7), shim.init(np.int64(7)),
                shim.init(None, seed=7), shim.init(_params(), seed=7),
                shim.init(seed=7, params=_params())):
        assert got == want
    assert shim.init() == preset.init(None, seed=0)
    adam = MeZOAdam(MeZOAdamConfig(window=4))
    assert adam.init(_params(), 9).base_key == prng_key(9)
    var = MeZOVariant(MeZOVariantConfig())
    assert var.init(_params(), seed=11).base_key == prng_key(11)


# --------------------------------------------------------------------------- #
# Shims ≡ presets
# --------------------------------------------------------------------------- #
SCHED = dict(lr=1e-3, eps=1e-3, weight_decay=0.01, clip_projected_grad=2.0,
             lr_schedule="linear", total_steps=200, warmup_steps=5)
PAIRS = {
    "mezo": (lambda: MeZO(MeZOConfig(**SCHED)), lambda: zo.mezo(**SCHED)),
    "n_spsa": (lambda: MeZO(MeZOConfig(lr=1e-3, n=3)),
               lambda: zo.mezo(lr=1e-3, n=3)),
    "one_point": (lambda: MeZO(MeZOConfig(lr=2e-4, eps=1e-2,
                                          estimator="one_point")),
                  lambda: zo.mezo(lr=2e-4, eps=1e-2, estimator="one_point")),
    "adam_ring": (lambda: MeZOAdam(MeZOAdamConfig(lr=1e-2, beta2=0.95,
                                                  window=8)),
                  lambda: zo.mezo_adam(lr=1e-2, beta2=0.95, window=8)),
    "adam_materialized": (
        lambda: MeZOAdam(MeZOAdamConfig(lr=1e-2, materialized=True)),
        lambda: zo.mezo_adam(lr=1e-2, materialized=True)),
    "momentum": (lambda: MeZOAdam(MeZOAdamConfig(lr=1e-2, window=8,
                                                 momentum_only=True)),
                 lambda: zo.mezo_adam(lr=1e-2, window=8, momentum_only=True)),
    "def6": (lambda: MeZOVariant(MeZOVariantConfig(lr=1e-3)),
             lambda: zo.mezo_rescaled(lr=1e-3)),
    "def7": (lambda: MeZOVariant(MeZOVariantConfig(
        lr=1e-3, modify_expectation=True)),
             lambda: zo.mezo_rescaled(lr=1e-3, modify_expectation=True)),
}


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_shim_steps_bitwise_like_its_preset(kind):
    make_shim, make_preset = PAIRS[kind]
    shim, preset = make_shim(), make_preset()
    assert shim.name == preset.name
    pa, ma = _run(shim, shim.init(_params(), seed=5), 8)
    pb, mb = _run(preset, preset.init(_params(), seed=5), 8)
    assert _same(pa, pb) and ma == mb
    assert not _same(pa, _params())


def test_variant_grad_norm_zo_recomposes_with_the_probe():
    """``init(params, loss_fn, batch)`` under ``d_source='grad_norm_zo'``
    builds the probe estimator: two steps bitwise
    ``zo.mezo_rescaled(..., probe_loss_fn=, probe_batch=)``;
    ``d_refresh_every`` is inert, as in JAX."""
    cfg = dict(lr=1e-3, d_source="grad_norm_zo")
    shim = MeZOVariant(MeZOVariantConfig(**cfg))
    pa, ma = _run(shim, shim.init(_params(), loss_fn, "probe", seed=3), 2)
    preset = zo.mezo_rescaled(probe_loss_fn=loss_fn, probe_batch="probe",
                              **cfg)
    pb, mb = _run(preset, preset.init(_params(), seed=3), 2)
    assert _same(pa, pb) and ma == mb
    inert = MeZOVariant(MeZOVariantConfig(d_refresh_every=1, **cfg))
    pc, mc = _run(inert, inert.init(_params(), loss_fn, "probe", seed=3), 2)
    assert _same(pa, pc) and ma == mc
    with pytest.raises(ValueError, match="pass loss_fn and batch"):
        MeZOVariant(MeZOVariantConfig(**cfg)).init(_params())


@pytest.mark.parametrize("schedule,warmup", [
    ("constant", 0), ("linear", 0), ("linear", 7), ("cosine", 7)])
def test_lr_at_equals_jax(schedule, warmup):
    """Bitwise JAX's ``lr_at`` under ``jit`` (the step count a constant,
    its division a product with the f32 reciprocal); JAX's op-by-op call
    divides, so t = step/total differs by up to one ulp of t (≤ 2⁻²⁴) and
    η by up to ``EAGER_LR_TOL`` × the base lr."""
    kw = dict(lr=3e-4, lr_schedule=schedule, total_steps=1000,
              warmup_steps=warmup)
    ours, theirs = MeZOConfig(**kw), jcore.MeZOConfig(**kw)
    jitted = jax.jit(theirs.lr_at)
    for step in range(0, 1100, 7):
        got = ours.lr_at(step)
        assert got.dtype == np.float32
        assert got == np.float32(jitted(step))
        eager = np.float32(theirs.lr_at(step))
        assert abs(float(got) - float(eager)) <= EAGER_LR_TOL * kw["lr"]


# --------------------------------------------------------------------------- #
# from_config / as_zo_optimizer
# --------------------------------------------------------------------------- #
def _duck(**extra):
    """A config-like object with MeZOConfig's fields and no class."""
    fields = dict(lr=1e-3, eps=1e-3, n=1, dist="gaussian", weight_decay=0.0,
                  estimator="spsa", lr_schedule="constant", total_steps=0,
                  warmup_steps=0, sequential_perturb=True,
                  clip_projected_grad=0.0)
    fields.update(extra)
    return types.SimpleNamespace(**fields)


BRANCHES = {
    "mezo": (dict(backend="pallas", selection="block_cyclic(2)"),
             lambda: zo.mezo(lr=1e-3, backend="pallas",
                             selection="block_cyclic(2)")),
    "mezo_adam": (dict(beta1=0.9, beta2=0.999, adam_eps=1e-8,
                       materialized=False, window=4, momentum_only=False,
                       backend="xla"),
                  lambda: zo.mezo_adam(lr=1e-3, window=4, backend="xla")),
    "mezo_rescaled": (dict(d_source="param_norm", modify_expectation=False,
                           d_probe_eps=1e-4, backend="pallas",
                           selection="leaves(b)"),
                      lambda: zo.mezo_rescaled(lr=1e-3, backend="pallas",
                                               selection="leaves(b)")),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_from_config_dispatches_as_jax(branch):
    """Duck typing in JAX's order (``d_source`` → rescaled, ``beta1`` →
    adam, else mezo), ``backend`` / ``selection`` read when present: the
    composition JAX builds (name, estimator, stream id, selection), and two
    steps bitwise the preset built directly."""
    extra, make = BRANCHES[branch]
    cfg = _duck(**extra)
    got, want = zo.from_config(cfg), jzo.from_config(cfg)
    assert got.name == want.name == branch
    assert got.estimator.name == want.estimator.name
    assert got.backend_name == want.backend_name
    assert got.selection_spec == want.selection_spec
    preset = make()
    pa, ma = _run(got, got.init(_params(), seed=1), 2)
    pb, mb = _run(preset, preset.init(_params(), seed=1), 2)
    assert _same(pa, pb) and ma == mb


def test_as_zo_optimizer_takes_configs_and_refuses_as_jax():
    opt = zo.as_zo_optimizer(MeZOConfig(lr=1e-3))
    assert isinstance(opt, zo.ZOOptimizer) and opt.name == "mezo"
    assert zo.as_zo_optimizer(opt) is opt
    assert zo.as_zo_optimizer(MeZOAdamConfig()).name == "mezo_adam"
    assert zo.as_zo_optimizer(MeZOVariantConfig()).name == "mezo_rescaled"
    for ours, theirs in ((object(), object()),
                         (Adam(AdamConfig()), JaxAdam(JaxAdamConfig()))):
        with pytest.raises(AttributeError) as want:
            jzo.as_zo_optimizer(theirs)
        with pytest.raises(AttributeError) as got:
            zo.as_zo_optimizer(ours)
        assert str(got.value) == str(want.value)
        assert "has no attribute 'lr'" in str(got.value)


def test_a_ledger_with_a_backprop_baseline_keeps_its_refusal():
    pipe = Pipeline(DataSpec("lm", batch=2, seq=4, vocab=11, seed=1),
                    device="cpu")
    with pytest.raises(ValueError, match="ledger recording requires"):
        train(loss_fn, _params(), Adam(AdamConfig(lr=1e-3)), pipe,
              total_steps=2, ledger=TrajectoryLedger(base_seed=0))


def test_a_bare_config_drives_step_program_and_replay():
    """On the qwen2 smoke config: ``MeZO`` through the loop with a ledger
    ≡ ``zo.mezo`` (θ and ledger bytes); then ``StepProgram(config)``,
    ``as_step_program(config, local())`` and ``core.replay(θ₀, ledger,
    config)`` with a bare ``MeZOConfig`` — bitwise the preset's replay,
    within ``REPLAY_ATOL`` of the trained θ (the sequential chain restores
    θ through θ − εz + εz, which rounds)."""
    from repro_torch.models import all_archs, bundle
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    b = bundle(cfg)
    lf = b.loss_fn()
    pipe = Pipeline(DataSpec("lm", batch=2, seq=16, vocab=cfg.vocab_size,
                             seed=3), device="cpu")
    conf = MeZOConfig(lr=1e-2, eps=1e-3)
    runs = {}
    for name, opt in (("shim", MeZO(conf)),
                      ("preset", zo.mezo(lr=1e-2, eps=1e-3))):
        led = TrajectoryLedger(base_seed=0, grad_dtype="float32",
                               backend="xla")
        res = train(lf, b.init(0, device="cpu"), opt, pipe, total_steps=3,
                    ledger=led)
        runs[name] = (res.params, led)
    assert _same(runs["shim"][0], runs["preset"][0])
    assert runs["shim"][1].to_bytes() == runs["preset"][1].to_bytes()
    rep = replay(b.init(0, device="cpu"), runs["shim"][1], conf)
    assert _same(rep, replay(b.init(0, device="cpu"), runs["shim"][1],
                             zo.mezo(lr=1e-2, eps=1e-3)))
    # the live chain restores θ from θ − εz (+ εz), the replay writes from θ
    assert tree_max_abs_diff(rep, runs["shim"][0]) < REPLAY_ATOL
    for prog in (StepProgram(conf),
                 as_step_program(conf, plan_mod.local())):
        p = b.init(0, device="cpu")
        p, state, m = prog.step_fn(lf)(p, prog.init(p, seed=0),
                                       pipe.batch(0))
        assert state.step == 1 and np.isfinite(m["loss"])
        assert prog.meta["perturb_backend"] == "xla"


def test_a_jax_trained_shim_ledger_replays_bitwise_through_a_bare_config():
    """JAX's ``MeZO`` shim trains a toy f32 tree through JAX's loop; its
    ledger replays in the port through a bare ``MeZOConfig`` to JAX's
    replay through its own bare config, bit for bit (and within
    ``REPLAY_ATOL`` of JAX's trained θ).  The first logged loss is held to
    JAX's within ``LOSS_RTOL`` (the step's graphs differ: see the module
    docstring)."""
    kw = dict(lr=1e-2, eps=1e-3, weight_decay=0.01)
    jled = jcore.TrajectoryLedger(base_seed=0, grad_dtype="float32",
                                  backend="xla")
    jpipe = JaxPipeline(JaxSpec("lm", batch=2, seq=4, vocab=11, seed=1))
    jp0 = {k: jnp.asarray(v) for k, v in _arrays().items()}
    res = jax_train(jax_loss, jp0, jcore.MeZO(jcore.MeZOConfig(**kw)), jpipe,
                    total_steps=6, ledger=jled, donate=False, log_every=1)
    tled = TrajectoryLedger.from_bytes(jled.to_bytes())
    got = replay(_params(), tled, MeZOConfig(**kw))
    want = jcore.replay(jp0, jled, jcore.MeZOConfig(**kw))
    for k in got:
        assert np.array_equal(np.asarray(want[k]).view(np.int32),
                              got[k].numpy().view(np.int32))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(res.params[k]),
                                   atol=REPLAY_ATOL)
    shim = MeZO(MeZOConfig(**kw))
    _, _, m = shim.step_fn(loss_fn)(_params(), shim.init(0), None)
    np.testing.assert_allclose(float(m["loss"]), res.losses[0][1],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_apply_projected_update_against_backend_and_jax(dtype):
    """θ ← (1 − η·λ)·θ − η·g·z, with and without a d_tree: the backend's
    ``apply_rank1`` with (η·g, η·λ) bitwise, in place, and JAX's
    ``apply_projected_update`` under ``jit`` bitwise."""
    jt = {k: jnp.asarray(v).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                   else jnp.float32)
          for k, v in _arrays().items()}
    jk = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    tk = fold_in(prng_key(4), 2)
    g, lr, wd = np.float32(0.75), np.float32(1e-3), 0.01
    for d in (None, {"a": np.float32(0.8), "b": np.float32(1.9)}):
        p = _params(dtype)
        out = apply_projected_update(p, tk, g, lr, wd, d_tree=d)
        assert out["a"] is p["a"]                        # written in place
        want_be = get_backend("xla").apply_rank1(
            _params(dtype), StreamRef(tk),
            lr * g, lr * np.float32(wd), d_tree=d)
        assert _same(out, want_be)
        jd = None if d is None else {k: jnp.float32(v) for k, v in d.items()}
        want = jax.jit(lambda p, g_, lr_: jcore.apply_projected_update(
            p, jk, g_, lr_, wd, d_tree=jd))(jt, jnp.float32(g),
                                            jnp.float32(lr))
        for k in out:
            assert np.array_equal(
                np.asarray(want[k].astype(jnp.float32)).view(np.int32),
                out[k].float().numpy().view(np.int32))


def test_shim_crash_and_resume_equals_the_preset_resume(tmp_path):
    """A ``MeZO`` run that crashes at step 7 of 10 and resumes (checkpoint
    at 4 + the ledger tail) ends at the θ the preset's crash-and-resume
    ends at, bit for bit, and within ``REPLAY_ATOL`` of the uninterrupted
    run's (steps 4–6 are replayed, not rerun)."""
    pipe = Pipeline(DataSpec("lm", batch=2, seq=4, vocab=11, seed=1),
                    device="cpu")
    ends = {}
    for name, make in (("shim", lambda: MeZO(MeZOConfig(lr=1e-3))),
                       ("preset", lambda: zo.mezo(lr=1e-3))):
        ck = CheckpointManager(str(tmp_path / name), interval=4)
        led = TrajectoryLedger(base_seed=0, grad_dtype="float32")
        with pytest.raises(RuntimeError, match="injected failure"):
            train(loss_fn, _params(), make(), pipe, total_steps=10, ckpt=ck,
                  ledger=led, injector=FailureInjector(fail_at_step=7))
        led2 = TrajectoryLedger(base_seed=0, grad_dtype="float32")
        res = train(loss_fn, _params(), make(), pipe, total_steps=10,
                    ckpt=ck, ledger=led2)
        assert res.resumed_from == 7 and res.opt_state.step == 10
        ends[name] = res.params
    whole = train(loss_fn, _params(), MeZO(MeZOConfig(lr=1e-3)), pipe,
                  total_steps=10).params
    assert _same(ends["shim"], ends["preset"])
    assert tree_max_abs_diff(ends["shim"], whole) < REPLAY_ATOL
