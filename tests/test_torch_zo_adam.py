"""Port parity of the applier transforms: ``scale_by_zo_adam`` (materialized
m / v and the recomputed ring buffer of App. B.2), ``trace``, the
``mezo_adam`` preset, their refusals, and their state through a checkpoint
— against the JAX package on the qwen2-0.5b smoke config in f32.

The transforms are held on identical inputs: the same θ, the same g
history, the same z (the threefry stream is bitwise on both sides).  What
stays is arithmetic order: XLA:CPU contracts the moments' multiply-adds
into FMAs (``β·m + (1 − β)·ĝ``, the ``fori_loop`` body's
``m + c_j·z``, ``v + c_j·z·z``) and fuses the update
``θ − η·Δ − η·λ·θ``; the port rounds each op, so Δ = m̂/(√v̂ + ε) agrees
within ``DELTA_RTOL`` relative (a few f32 ulps of m and v, amplified by the
division where √v̂ is near ε), and θ within ``PARAM_ATOL`` after η·Δ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import exec as jexec
from repro import zo as jzo
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.perturb import step_key as jax_step_key
from repro.zo.base import TransformCtx as JaxCtx
from repro.zo.base import Updates as JaxUpdates
from repro_torch import convert
from repro_torch import exec as texec
from repro_torch import zo
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataSpec, Pipeline
from repro_torch.models import all_archs, bundle
from repro_torch.perturb import get_backend, step_key
from repro_torch.perturb.stream import prng_key
from repro_torch.train import train
from repro_torch.tree_utils import tree_leaves
from repro_torch.zo.base import TransformCtx, Updates

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

LR = 1e-3
DELTA_RTOL = 1e-4
PARAM_ATOL = 2e-6
LOSS_ATOL = 1e-5
G_HIST = [0.7, -1.3, 2.1]


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def weights():
    cfg = jax_archs()["qwen2-0.5b"].smoke_cfg
    with jax.threefry_partitionable(True):
        return jax.tree.map(np.asarray,
                            jax_bundle(cfg).init(jax.random.PRNGKey(0)))


def _transforms(kind: str, materialized: bool, mod):
    if kind == "trace":
        return mod.transforms.trace(decay=0.9, window=4,
                                    materialized=materialized)
    return mod.transforms.scale_by_zo_adam(
        materialized=materialized, window=4, weight_decay=0.01)


@pytest.mark.parametrize("materialized", [False, True],
                         ids=["recomputed", "materialized"])
@pytest.mark.parametrize("kind", ["adam", "trace"])
def test_applier_transform_matches_jax(weights, kind, materialized):
    """Three updates with the same g history, θ and z on both sides (JAX's
    update jitted, as in its step): θ within ``PARAM_ATOL`` after each, and
    the materialized m / v within ``DELTA_RTOL``."""
    jtf = jzo.chain(jzo.transforms.scale_by_schedule(LR),
                    _transforms(kind, materialized, jzo))
    ttf = zo.chain(zo.transforms.scale_by_schedule(LR),
                   _transforms(kind, materialized, zo))
    jp = jax.tree.map(jnp.asarray, weights)
    tp = convert.params_from_jax(weights)
    jstate, tstate = jtf.init(jp), ttf.init(tp)
    jbase, tbase = jax.random.PRNGKey(9), prng_key(9)

    @jax.jit
    def jstep(p, state, g, step):
        ctx = JaxCtx(step=step, base_key=jbase,
                     key=jax_step_key(jbase, step), seed_index=0, n_seeds=1,
                     eps=1e-3, dist="gaussian", restore=lambda: p,
                     backend="xla")
        u, state = jtf.update(JaxUpdates(g=g), state, ctx)
        return u.final_params, state

    for t, g in enumerate(G_HIST):
        jp, jstate = jstep(jp, jstate, jnp.float32(g), jnp.int32(t))
        ctx = TransformCtx(step=t, base_key=tbase, key=step_key(tbase, t),
                           seed_index=0, n_seeds=1, eps=1e-3,
                           dist="gaussian", restore=lambda p=tp: p,
                           backend=get_backend("xla"))
        u, tstate = ttf.update(Updates(g=np.float32(g)), tstate, ctx)
        tp = u.final_params
        for w, got in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
            assert np.allclose(np.asarray(w), got.numpy(), rtol=0,
                               atol=PARAM_ATOL)
    jg, jm, jv = jstate[1]
    tg, tm, tv = tstate[1]
    assert np.array_equal(np.asarray(jg), tg)               # the ring buffer
    if materialized:
        for a, b in zip(jax.tree_util.tree_leaves((jm, jv)),
                        tree_leaves((tm, tv))):
            a = np.asarray(a)
            assert np.allclose(a, b.numpy(), rtol=DELTA_RTOL,
                               atol=DELTA_RTOL * np.abs(a).max())
    else:
        assert tm == () and tv == ()


def test_mezo_adam_first_step_loss_matches_jax(weights):
    jcfg = jax_archs()["qwen2-0.5b"].smoke_cfg
    tcfg = all_archs()["qwen2-0.5b"].smoke_cfg
    jb = jax_lm_batch(3, 0, 4, 16, 256)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    jopt = jzo.mezo_adam(lr=LR, eps=1e-3, window=4, backend="xla")
    topt = zo.mezo_adam(lr=LR, eps=1e-3, window=4, backend="xla")
    jstate = jopt.init(None, seed=5)
    _, _, jm = jax.jit(jopt.step_fn(jax_bundle(jcfg).loss_fn()))(
        jax.tree.map(jnp.asarray, weights), jstate, jb)
    tp = convert.params_from_jax(weights)
    before = [p.clone() for p in tree_leaves(tp)]
    tp, tstate, tm = topt.step_fn(bundle(tcfg).loss_fn())(
        tp, topt.init(tp, seed=5), tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert tstate.tf_state[-1][0][0] == np.float32(tm["projected_grad"])
    assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                     before))


@pytest.mark.parametrize("case", ["n_spsa", "fzoo", "scalar_decay",
                                  "selection"])
def test_applier_refusals_match_jax(case):
    """The compositions JAX refuses at construction, refused with its
    message."""
    def build(mod):
        adam = mod.transforms.scale_by_zo_adam()
        sched = mod.transforms.scale_by_schedule(LR)
        if case == "n_spsa":
            return mod.ZOOptimizer(mod.estimators.n_spsa(2, backend="xla"),
                                   mod.chain(sched, adam))
        if case == "fzoo":
            return mod.ZOOptimizer(mod.estimators.fzoo(2, backend="xla"),
                                   mod.chain(sched, adam))
        if case == "scalar_decay":
            return mod.ZOOptimizer(
                mod.estimators.spsa(backend="xla"),
                mod.chain(sched, mod.transforms.add_weight_decay(0.1), adam))
        return mod.mezo_adam(backend="xla", selection="leaves(wq)")

    with pytest.raises(ValueError) as jerr:
        build(jzo)
    with pytest.raises(ValueError) as terr:
        build(zo)
    assert str(terr.value) == str(jerr.value).replace("repro.select",
                                                      "repro_torch.select")


def test_applier_replay_and_group_plan_refusals_match_jax(weights):
    jopt, topt = jzo.mezo_adam(backend="xla"), zo.mezo_adam(backend="xla")
    with pytest.raises(ValueError, match="applier"):
        jopt.replay_update(jax.tree.map(jnp.asarray, weights),
                           jax.random.PRNGKey(0), 1.0, 1e-3)
    with pytest.raises(ValueError, match="applier"):
        topt.replay_update(convert.params_from_jax(weights), prng_key(0),
                           1.0, 1e-3)
    for mod, opt in ((jexec, jopt), (texec, topt)):
        with pytest.raises(ValueError, match="run appliers under the local "
                                             "plan"):
            mod.StepProgram(opt, mod.seed_parallel(2))
        mod.StepProgram(opt, mod.seed_parallel(1))     # one group is local


@pytest.mark.parametrize("materialized", [False, True],
                         ids=["recomputed", "materialized"])
def test_adam_state_rides_through_a_checkpoint(tmp_path, materialized):
    """2 steps, a checkpoint, a resume to 4: θ, the g ring buffer and the
    materialized m / v equal an uninterrupted 4-step run, bitwise."""
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    loss_fn = bundle(cfg).loss_fn()
    pipe = Pipeline(DataSpec("lm", batch=2, seq=8, vocab=cfg.vocab_size,
                             seed=1), device="cpu")

    def opt():
        return zo.mezo_adam(lr=LR, window=3, materialized=materialized,
                            backend="xla")

    straight = train(loss_fn, bundle(cfg).init(0, device="cpu"), opt(), pipe,
                     total_steps=4)
    ck = CheckpointManager(str(tmp_path), interval=2)
    train(loss_fn, bundle(cfg).init(0, device="cpu"), opt(), pipe,
          total_steps=2, ckpt=ck)
    resumed = train(loss_fn, bundle(cfg).init(0, device="cpu"), opt(), pipe,
                    total_steps=4, ckpt=ck)
    assert resumed.resumed_from == 2
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        assert torch.equal(a, b)
    g1, m1, v1 = resumed.opt_state.tf_state[-1]
    g2, m2, v2 = straight.opt_state.tf_state[-1]
    assert np.array_equal(g1, g2) and np.all(g1 != 0)     # the last 3 g
    for a, b in zip(tree_leaves((m1, v1)), tree_leaves((m2, v2))):
        assert torch.equal(a, b)
    assert (len(tree_leaves(m1)) > 0) == materialized
