"""The port's bounded-staleness async workers (``repro_torch.distributed.
async_zo``) and the engine's async building blocks, on the CPU in f32:

* JAX's five tests of ``tests/test_async_zo.py`` on the port;
* the async tests of ``tests/test_exec.py`` (staleness 0 against the
  seed-parallel step, order invariance), ``tests/test_select.py`` (a
  block-cyclic selection; the selection stamp at one worker) and
  ``tests/test_zo_api.py`` (the refusals of stateful and Definition-6
  estimators);
* contributions made by JAX's workers, consumed by the port's from the same
  θ₀ (``convert``), give θ bitwise JAX's workers' on ``xla`` and on
  ``pallas`` (JAX's through ``pallas-interpret``), in f32 and in bf16;
  ``contributions_to_ledger`` writes identical ledger bytes both ways;
* the write-path grep of ``tests/test_exec.py``.

Where JAX needs a tolerance between a worker and the seed-parallel step
because its jits fuse differently, the port is held tighter where its
writes are the same sequence (see each test).  The partitionable threefry
layout is pinned on (the one the port reproduces).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import zo as jzo
from repro.core.trajectory import TrajectoryLedger as JaxLedger
from repro.distributed import async_zo as jasync
from repro_torch import convert, select, zo
from repro_torch import exec as zexec
from repro_torch.core import MeZOConfig, TrajectoryLedger, replay
from repro_torch.core.mezo import apply_projected_update
from repro_torch.core.perturb import step_key
from repro_torch.distributed import async_zo, collectives
from repro_torch.distributed.async_zo import (AsyncZOWorker, Contribution,
                                              contributions_to_ledger,
                                              run_sync_equivalent)
from repro_torch.distributed.collectives import (apply_seed_parallel_update,
                                                 seed_parallel_grads)
from repro_torch.exec import StepProgram
from repro_torch.perturb.stream import fold_in, prng_key
from repro_torch.select import SelectionMismatchError
from repro_torch.tree_utils import tree_clone, tree_leaves, tree_max_abs_diff

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _normal(seed: int, n: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def quad(t):
    return lambda p, b: 0.5 * torch.sum((p["w"] - t) ** 2)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# --------------------------------------------------------------------------- #
# tests/test_async_zo.py on the port
# --------------------------------------------------------------------------- #
def test_staleness_zero_workers_stay_identical():
    t = _normal(0, 16)
    loss_fn = quad(t)
    cfg = MeZOConfig(lr=5e-3, eps=1e-3)
    p0 = {"w": torch.zeros(16)}
    ws = [AsyncZOWorker(w, 3, p0, loss_fn, cfg, base_seed=1)
          for w in range(3)]
    for _ in range(10):
        run_sync_equivalent(ws, lambda w, s: None)
    for w in ws[1:]:
        assert tree_max_abs_diff(w.params, ws[0].params) == 0.0
    assert float(loss_fn(ws[0].params, None)) < float(loss_fn(p0, None))
    assert torch.equal(p0["w"], torch.zeros(16))    # the caller's tree


def test_stale_application_order_invariance():
    t = _normal(1, 16)
    loss_fn = quad(t)
    cfg = MeZOConfig(lr=1e-3, eps=1e-3)
    p0 = {"w": torch.zeros(16)}
    a = AsyncZOWorker(0, 2, p0, loss_fn, cfg, base_seed=2, max_staleness=10)
    b = AsyncZOWorker(1, 2, p0, loss_fn, cfg, base_seed=2, max_staleness=10)
    ca0, cb0, ca1, cb1 = (a.produce(None), b.produce(None),
                          a.produce(None), b.produce(None))
    for cb in (ca0, cb0, ca1, cb1):
        a.consume(cb)
    for cb in (cb1, ca1, cb0, ca0):
        b.consume(cb)
    assert tree_max_abs_diff(a.params, b.params) < 1e-6


def test_bounded_staleness_drops_old():
    cfg = MeZOConfig(lr=1e-3, eps=1e-3)
    w = AsyncZOWorker(0, 2, {"w": torch.zeros(8)}, quad(torch.ones(8)), cfg,
                      max_staleness=2)
    for _ in range(5):
        w.produce(None)
    old = Contribution(step=0, worker=1, projected_grad=1.0, lr=1e-3)
    assert not w.consume(old)      # step 0 is > 2 stale at step 5
    fresh = Contribution(step=4, worker=1, projected_grad=1.0, lr=1e-3)
    assert w.consume(fresh)
    assert not w.consume(fresh)    # dedup


def test_async_converges_with_delay():
    t = _normal(3, 12)
    loss_fn = quad(t)
    cfg = MeZOConfig(lr=4e-3, eps=1e-3)
    p0 = {"w": torch.zeros(12)}
    ws = [AsyncZOWorker(w, 2, p0, loss_fn, cfg, base_seed=5, max_staleness=4)
          for w in range(2)]
    pending = []
    for _ in range(400):
        newly = [w.produce(None) for w in ws]
        for cb in pending:             # deliver LAST round's contributions
            for w in ws:
                w.consume(cb)
        pending = newly
    l0 = float(loss_fn(p0, None))
    assert float(loss_fn(ws[0].params, None)) < 0.05 * l0


def test_seed_parallel_matches_manual_nspsa():
    """seed-parallel grads + update == sequential n-SPSA at the same seeds
    on the same batch slices (bitwise here: both write through the xla
    backend's sequential apply_rank1 fold)."""
    t = _normal(4, 10)

    def loss_fn(p, b):
        scale = 1.0 if b is None else torch.mean(b)
        return 0.5 * scale * torch.sum((p["w"] - t) ** 2)

    p0 = {"w": torch.zeros(10)}
    base = prng_key(9)
    batches = torch.stack([torch.full((2,), 1.0), torch.full((2,), 2.0)])
    gs = seed_parallel_grads(loss_fn, p0, batches, base, 0, 1e-3, n_groups=2)
    assert gs.shape == (2,) and gs.dtype == np.float32
    assert torch.equal(p0["w"], torch.zeros(10))   # evaluated on copies
    p1 = apply_seed_parallel_update(tree_clone(p0), base, 0, gs, 1e-3,
                                    n_groups=2)
    skey0 = step_key(base, 0)
    p_manual = tree_clone(p0)
    for g in range(2):
        p_manual = apply_projected_update(p_manual, fold_in(skey0, g), gs[g],
                                          np.float32(1e-3 / 2))
    assert tree_max_abs_diff(p1, p_manual) < 1e-7


def test_legacy_helpers_warn_as_jax():
    p0 = {"w": torch.zeros(4)}
    with pytest.warns(UserWarning, match="unfolded step key"):
        gs = seed_parallel_grads(quad(torch.ones(4)), p0, torch.ones(1, 2),
                                 prng_key(0), 0, 1e-3, n_groups=1)
    with pytest.warns(UserWarning) as rec:
        apply_seed_parallel_update(p0, prng_key(0), 0, gs, 1e-3, n_groups=1,
                                   weight_decay=0.1)
    assert len(rec) == 2 and "η·λ once per step" in str(rec[1].message)


# --------------------------------------------------------------------------- #
# tests/test_exec.py / test_select.py / test_zo_api.py async tests
# --------------------------------------------------------------------------- #
def make_opt(estimator, backend="xla", selection=None, lr=1e-3, eps=1e-3):
    if estimator == "spsa":
        return zo.mezo(lr=lr, eps=eps, backend=backend, selection=selection)
    return zo.fzoo(lr=lr, eps=eps, batch_seeds=3, backend=backend,
                   selection=selection)


@pytest.fixture()
def problem():
    t = _normal(0, 16)

    def loss_fn(p, b):
        scale = 1.0 if b is None else torch.mean(b)
        return 0.5 * scale * torch.sum((p["w"] - t) ** 2)

    return loss_fn, {"w": torch.zeros(16)}, torch.linspace(0.5, 1.5, 8)


def run_plan(opt, plan, loss_fn, params, batch, steps=4, seed=3):
    prog = StepProgram(opt, plan)
    p = tree_clone(params)
    state = prog.init(p, seed=seed)
    step = prog.step_fn(loss_fn)
    for _ in range(steps):
        p, state, _ = step(p, state, batch)
    return p


def _rounds(ws, batch, n, rounds=4):
    per = batch.shape[0] // n
    contribs = []
    for _ in range(rounds):
        cs = [w.produce(batch[w.w * per:(w.w + 1) * per]) for w in ws]
        contribs += cs
        for w in ws:
            for cb in cs:
                w.consume(cb)
    return contribs


@pytest.mark.parametrize("estimator", ["spsa", "fzoo"])
def test_async_staleness0_matches_seed_parallel(problem, estimator):
    """Workers are bitwise equal.  Against the seed-parallel step on the
    full batch: fzoo evaluates at θ itself in both (its views are copies),
    and on ``xla`` ``affine_many`` is the sequential ``apply_rank1`` fold a
    worker applies — bitwise.  Sequential spsa restores θ between the
    seed-parallel groups through θ+εz−2εz+εz, which rounds, so later
    groups see a θ a few f32 ulps off: JAX's 1e-6.  The assembled ledger's
    replay applies the recorded g through the same fold: bitwise."""
    loss_fn, params, batch = problem
    n = 2
    ws = [AsyncZOWorker(w, n, params, loss_fn, make_opt(estimator),
                        base_seed=3) for w in range(n)]
    contribs = _rounds(ws, batch, n)
    assert _same(ws[0].params, ws[1].params)
    p_sp = run_plan(make_opt(estimator), zexec.seed_parallel(n), loss_fn,
                    params, batch)
    if estimator == "fzoo":
        assert _same(ws[0].params, p_sp)
    else:
        assert tree_max_abs_diff(ws[0].params, p_sp) < 1e-6
    led = TrajectoryLedger(base_seed=3, grad_dtype="float32")
    assert contributions_to_ledger(led, contribs, n_workers=n) == (4, 0)
    assert (led.n_groups, led.exec_plan) == (n, "async_worker")
    assert len(led) == 4
    rec = replay(tree_clone(params), led, make_opt(estimator))
    assert _same(rec, ws[0].params)


def test_async_order_invariance_on_engine(problem):
    loss_fn, params, _ = problem
    a = AsyncZOWorker(0, 2, params, loss_fn, make_opt("spsa"), base_seed=2,
                      max_staleness=10)
    b = AsyncZOWorker(1, 2, params, loss_fn, make_opt("spsa"), base_seed=2,
                      max_staleness=10)
    cs = [a.produce(None), b.produce(None), a.produce(None), b.produce(None)]
    for cb in cs:
        a.consume(cb)
    for cb in reversed(cs):
        b.consume(cb)
    assert tree_max_abs_diff(a.params, b.params) < 1e-6


@pytest.fixture()
def sel_problem():
    """tests/test_select.py's problem: two leaves, so block_cyclic(2)
    perturbs one a step."""
    t = _normal(0, 16)

    def loss_fn(p, b):
        scale = 1.0 if b is None else torch.mean(b)
        return scale * (0.5 * torch.sum((p["w"] - t) ** 2)
                        + 0.1 * torch.sum(p["v"] ** 2))

    params = {"v": torch.ones(8), "w": torch.zeros(16)}
    return loss_fn, params, torch.linspace(0.5, 1.5, 8)


def test_async_staleness0_selection_matches_seed_parallel(sel_problem):
    loss_fn, params, batch = sel_problem
    n = 2
    sel = select.block_cyclic(2)

    def mk():
        return make_opt("spsa", selection=sel)

    ws = [AsyncZOWorker(w, n, params, loss_fn, mk(), base_seed=3)
          for w in range(n)]
    contribs = _rounds(ws, batch, n)
    assert _same(ws[0].params, ws[1].params)
    p_sp = run_plan(mk(), zexec.seed_parallel(n), loss_fn, params, batch)
    assert tree_max_abs_diff(ws[0].params, p_sp) < 1e-6
    led = TrajectoryLedger(base_seed=3, grad_dtype="float32")
    recorded, skipped = contributions_to_ledger(led, contribs, n_workers=n,
                                                selection=sel.spec)
    assert (recorded, skipped) == (4, 0) and led.selection == sel.spec
    rec = replay(tree_clone(params),
                 TrajectoryLedger.from_bytes(led.to_bytes()), mk())
    assert _same(rec, ws[0].params)


def test_contributions_to_ledger_stamps_selection_at_one_worker(
        sel_problem):
    loss_fn, params, _ = sel_problem
    sel = select.block_cyclic(2)

    def mk():
        return make_opt("spsa", selection=sel)
    w = AsyncZOWorker(0, 1, params, loss_fn, mk(), base_seed=3)
    contribs = []
    for _ in range(3):
        c = w.produce(None)
        contribs.append(c)
        w.consume(c)
    led = TrajectoryLedger(base_seed=3, grad_dtype="float32")
    recorded, skipped = contributions_to_ledger(led, contribs, n_workers=1,
                                                selection=sel.spec)
    assert (recorded, skipped) == (3, 0)
    assert led.selection == sel.spec
    rec = replay(tree_clone(params),
                 TrajectoryLedger.from_bytes(led.to_bytes()), mk())
    assert _same(rec, w.params)
    with pytest.raises(SelectionMismatchError):
        replay(tree_clone(params), TrajectoryLedger.from_bytes(led.to_bytes()),
               make_opt("spsa"))


def test_incomplete_round_is_skipped(problem):
    loss_fn, params, _ = problem
    ws = [AsyncZOWorker(w, 2, params, loss_fn, make_opt("spsa"))
          for w in range(2)]
    cs = [ws[0].produce(None), ws[1].produce(None), ws[0].produce(None)]
    led = TrajectoryLedger(base_seed=0, grad_dtype="float32")
    assert contributions_to_ledger(led, cs, n_workers=2) == (1, 1)


def test_async_worker_rejects_stateful_estimator():
    with pytest.raises(ValueError, match="stateless"):
        AsyncZOWorker(0, 2, {"w": torch.zeros(4)}, quad(torch.ones(4)),
                      zo.mezo(lr=1e-3, eps=1e-2, estimator="one_point"))


def test_async_rejects_definition6_rescaled():
    opt6 = zo.mezo_rescaled(lr=1e-3, eps=1e-3, d_source="param_norm")
    with pytest.raises(ValueError, match="Definition 6"):
        AsyncZOWorker(0, 2, {"w": torch.ones(4)}, quad(torch.ones(4)), opt6)
    opt7 = zo.mezo_rescaled(lr=1e-3, eps=1e-3, d_source="param_norm",
                            modify_expectation=True)
    AsyncZOWorker(0, 2, {"w": torch.ones(4)}, quad(torch.ones(4)), opt7)


def test_async_plan_has_no_step_fn_and_seed_key_needs_n_workers():
    prog = StepProgram(make_opt("spsa"), zexec.async_worker(2))
    with pytest.raises(ValueError, match="AsyncZOWorker"):
        prog.step_fn(quad(torch.ones(4)))
    with pytest.raises(TypeError):
        async_zo.worker_seed_key(prng_key(0), 0, 1)
    assert async_zo.worker_seed_key(prng_key(0), 3, 1, 2) == \
        fold_in(step_key(prng_key(0), 3), 1)
    assert async_zo.worker_seed_key(prng_key(0), 3, 0, 1) == \
        step_key(prng_key(0), 3)


# --------------------------------------------------------------------------- #
# JAX's contributions consumed by the port's workers
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def smoke():
    """Three leaves of qwen2-0.5b's smoke shapes (a matrix, a bias, a norm
    scale; values from numpy) and a cheap JAX loss over them: the parity
    under test is the port's writes of JAX's contributions, not the forward
    (and JAX compiles a threefry graph per leaf)."""
    rng = np.random.default_rng(0)
    weights = {"wq": rng.standard_normal((2, 64, 128), np.float32),
               "bq": rng.standard_normal((2, 128), np.float32),
               "ln_f": rng.standard_normal(64, np.float32)}

    def loss_fn(p, b):
        sq = sum(jnp.mean(jnp.square(x.astype(jnp.float32) - 0.25))
                 for x in jax.tree_util.tree_leaves(p))
        return jnp.mean(b) * sq

    return weights, loss_fn, np.linspace(0.5, 1.5, 4, dtype=np.float32)


def _jax_rounds(weights, loss_fn, batch, jopt_fn, n, rounds):
    per = batch.shape[0] // n
    ws = [jasync.AsyncZOWorker(w, n, jax.tree.map(jnp.asarray, weights),
                               loss_fn, jopt_fn(), base_seed=7)
          for w in range(n)]
    contribs = []
    for _ in range(rounds):
        cs = [w.produce(jnp.asarray(batch[w.w * per:(w.w + 1) * per]))
              for w in ws]
        contribs += cs
        for w in ws:
            for cb in cs:
                w.consume(cb)
    return ws[0].params, contribs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend,estimator", [("xla", "spsa"),
                                               ("pallas", "spsa"),
                                               ("xla", "fzoo"),
                                               ("pallas", "fzoo")])
def test_jax_contributions_consumed_by_port_bitwise(smoke, backend,
                                                    estimator, dtype):
    """Bitwise, but for fzoo's f32 writes: JAX compiles one contribution's
    coefficient arithmetic and its B streams into ONE fused graph (on
    ``pallas-interpret`` too), which XLA:CPU contracts differently from a
    one-stream write; the port writes the B streams as its one-stream
    forms (X1's ``axpbz`` on ``xla``, K3's chain on ``pallas``).  Those f32
    values lie within one f32 ulp of the leaf's largest |θ| per
    contribution applied (ROADMAP Queue 3); bf16 is bitwise."""
    weights, loss_fn, batch = smoke
    if dtype == "bfloat16":
        weights = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)),
            weights)
    jbackend = "pallas-interpret" if backend == "pallas" else backend
    n, rounds = 2, 2

    def jopt():
        if estimator == "spsa":
            return jzo.mezo(lr=1e-3, eps=1e-3, backend=jbackend)
        return jzo.fzoo(lr=1e-3, eps=1e-3, batch_seeds=2, backend=jbackend)

    def topt():
        if estimator == "spsa":
            return zo.mezo(lr=1e-3, eps=1e-3, backend=backend)
        return zo.fzoo(lr=1e-3, eps=1e-3, batch_seeds=2, backend=backend)

    j_params, j_contribs = _jax_rounds(weights, loss_fn, batch, jopt, n,
                                       rounds)
    p0 = convert.params_from_jax(weights)
    ws = [AsyncZOWorker(w, n, p0, None, topt(), base_seed=7)
          for w in range(n)]
    for c in j_contribs:
        # the wire: JAX's Python floats, as they are
        tc = Contribution(c.step, c.worker, c.projected_grad, c.lr)
        for w in ws:
            assert w.consume(tc)
    want = convert.params_from_jax(jax.tree.map(np.asarray, j_params))
    assert _same(ws[0].params, ws[1].params)
    if (estimator, dtype) == ("fzoo", "float32"):
        # one ulp per contribution applied
        for a, b in zip(tree_leaves(ws[0].params), tree_leaves(want)):
            ulp = torch.finfo(torch.float32).eps * b.abs().max()
            assert (a - b).abs().max() <= len(j_contribs) * ulp
    else:
        assert _same(ws[0].params, want)
    # the ledger both ways, from the same contributions
    j_led = JaxLedger(base_seed=7, grad_dtype="float32",
                      backend=jopt().backend_name)
    t_led = TrajectoryLedger(base_seed=7, grad_dtype="float32",
                             backend=topt().backend_name)
    assert jasync.contributions_to_ledger(j_led, j_contribs, n_workers=n) \
        == (rounds, 0)
    t_contribs = [Contribution(c.step, c.worker, c.projected_grad, c.lr)
                  for c in j_contribs]
    assert contributions_to_ledger(t_led, t_contribs, n_workers=n) == \
        (rounds, 0)
    assert t_led.to_bytes() == j_led.to_bytes()


def test_wire_g_round_trips_f32():
    g = np.float32(np.random.default_rng(0).standard_normal(257))
    for x in g:
        assert np.float32(float(x)) == x


# --------------------------------------------------------------------------- #
# The write-path grep (tests/test_exec.py)
# --------------------------------------------------------------------------- #
def test_distributed_modules_route_through_backend_only():
    for mod in (collectives, async_zo):
        src = inspect.getsource(mod)
        assert "core.perturb" not in src, mod.__name__
        assert "apply_rank1(" not in src, mod.__name__
        assert ".perturb(" not in src, mod.__name__
