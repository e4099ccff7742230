"""Port fault tolerance: crash at step k, resume from the newest checkpoint
plus the ledger tail, against the uninterrupted run — within the
tolerances JAX's own tests use (``tests/test_fault_tolerance.py``,
``tests/test_fzoo.py``); checkpoints in the JAX package's file layout,
loadable by either package; the msgpack subset byte-identical to
``msgpack.packb``; resume refusals with JAX's error types."""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint.io import load_tree as jax_load_tree
from repro.checkpoint.io import save_tree as jax_save_tree
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro_torch import convert, zo
from repro_torch.checkpoint import msgpack_lite
from repro_torch.checkpoint.io import load_meta, load_tree, save_tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import TrajectoryLedger, replay
from repro_torch.data import DataSpec, Pipeline
from repro_torch.exec import PlanMismatchError, StepProgram, seed_parallel
from repro_torch.models import all_archs, bundle
from repro_torch.perturb import BackendMismatchError
from repro_torch.train import FailureInjector, train
from repro_torch.tree_utils import tree_leaves

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist


def max_abs_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.fixture(scope="module")
def jax_weights():
    cfg = jax_archs()["qwen2-0.5b"].smoke_cfg
    return jax.tree.map(np.asarray, jax_bundle(cfg).init(jax.random.PRNGKey(0)))


@pytest.fixture()
def setup(tmp_path, jax_weights):
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    loss_fn = bundle(cfg).loss_fn()
    pipe = Pipeline(DataSpec("lm", batch=4, seq=16, vocab=cfg.vocab_size,
                             seed=9), device="cpu")
    return (lambda: convert.params_from_jax(jax_weights)), loss_fn, pipe, \
        str(tmp_path)


MAKERS = {
    "spsa": (lambda: zo.mezo(lr=1e-4, eps=1e-3, backend="pallas"), 1e-6,
             1e-6),
    # fzoo's 1/σ step normalization amplifies ulp differences through
    # continued live steps in JAX (test_fzoo.py: 1e-6 at the recovery point,
    # 2e-3 at the end); in the port live ≡ replay, so both hold bitwise too
    "fzoo": (lambda: zo.fzoo(lr=2e-6, eps=1e-3, batch_seeds=4,
                             weight_decay=0.01, backend="pallas"), 1e-6,
             2e-3),
}


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_crash_resume_matches_uninterrupted_run(setup, kind):
    fresh, loss_fn, pipe, tmp = setup
    make, tol_rec, tol_end = MAKERS[kind]
    T, crash = 10, 7
    ref = train(loss_fn, fresh(), make(), pipe, total_steps=T)
    ref7 = train(loss_fn, fresh(), make(), pipe, total_steps=crash)

    ck = CheckpointManager(os.path.join(tmp, "run"), interval=4)
    led = TrajectoryLedger(base_seed=0, grad_dtype="float32")
    with pytest.raises(RuntimeError, match="injected failure"):
        train(loss_fn, fresh(), make(), pipe, total_steps=T, ckpt=ck,
              ledger=led, injector=FailureInjector(fail_at_step=crash))
    saved = ck.load_ledger()
    assert saved.backend == "pallas+z2" and len(saved) == crash
    meta = load_meta(ck._path(4))
    assert meta["perturb_backend"] == "pallas+z2" and meta["step"] == 4
    assert meta["batch_seeds"] == make().batch_seeds

    # recovery point: ckpt@4 + ledger tail -> params at the crash step
    rec, rec_step = ck.recover_via_ledger(
        ck.restore_latest(fresh())["params"], 4, make())
    assert rec_step == crash
    assert max_abs_diff(rec, ref7.params) < tol_rec

    led2 = TrajectoryLedger(base_seed=0, grad_dtype="float32")
    res = train(loss_fn, fresh(), make(), pipe, total_steps=T, ckpt=ck,
                ledger=led2)
    assert res.resumed_from == crash and res.opt_state.step == T
    assert len(led2) == T and led2.steps == list(range(T))
    assert max_abs_diff(res.params, ref.params) < tol_end
    if kind == "fzoo":
        for a, b in zip(tree_leaves(res.params), tree_leaves(ref.params)):
            assert torch.equal(a, b)


def test_ledger_recovery_needs_no_forward_passes(setup):
    fresh, loss_fn, pipe, tmp = setup
    ck = CheckpointManager(os.path.join(tmp, "r2"), interval=100)
    led = TrajectoryLedger(base_seed=0, grad_dtype="float32")
    r = train(loss_fn, fresh(), zo.mezo(lr=1e-4, backend="pallas"), pipe,
              total_steps=6, ckpt=ck, ledger=led)
    assert len(ck.load_ledger()) == 6
    recovered, head = ck.recover_via_ledger(fresh(), 0,
                                            zo.mezo(backend="pallas"))
    assert head == 6
    assert max_abs_diff(recovered, r.params) < 1e-6


def test_resume_refusals_match_jax(setup):
    fresh, loss_fn, pipe, tmp = setup
    ck = CheckpointManager(os.path.join(tmp, "r3"), interval=2)
    train(loss_fn, fresh(), zo.fzoo(lr=1e-6, batch_seeds=2, backend="pallas"),
          pipe, total_steps=2, ckpt=ck,
          ledger=TrajectoryLedger(base_seed=0, grad_dtype="float32"))
    with pytest.raises(ValueError, match="batch_seeds=2"):
        train(loss_fn, fresh(), zo.fzoo(lr=1e-6, batch_seeds=3,
                                        backend="pallas"),
              pipe, total_steps=3, ckpt=ck)
    with pytest.raises(PlanMismatchError, match="n_groups"):
        train(loss_fn, fresh(),
              StepProgram(zo.fzoo(lr=1e-6, batch_seeds=2, backend="pallas"),
                          seed_parallel(2)), pipe, total_steps=3, ckpt=ck)
    led = TrajectoryLedger(base_seed=0, grad_dtype="float32",
                           backend="xla")
    led.append(0, 1.0, 1e-3)
    with pytest.raises(BackendMismatchError, match="'xla' perturbation"):
        train(loss_fn, fresh(), zo.mezo(backend="pallas"), pipe,
              total_steps=1, ledger=led)


def test_checkpoint_rotation_and_dtypes(tmp_path):
    ck = CheckpointManager(str(tmp_path), interval=1, keep=2)
    for s in range(1, 6):
        ck.maybe_save(s, {"w": torch.ones(4) * s})
    assert ck.steps() == [4, 5]
    tree = {"a": torch.ones(3, 3, dtype=torch.bfloat16),
            "b": torch.arange(5, dtype=torch.int32),
            "c": {"d": torch.tensor(2.5)}}
    path = str(tmp_path / "t.mz")
    save_tree(path, tree, {"step": 7})
    back, meta = load_tree(path, tree)
    assert meta == {"step": 7}
    for k in ("a", "b"):
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k])
    assert float(back["c"]["d"]) == 2.5
    with pytest.raises(FileNotFoundError):
        load_meta(str(tmp_path / "missing.mz"))


def test_optimizer_state_round_trips(tmp_path, setup):
    fresh, loss_fn, pipe, _ = setup
    opt = zo.mezo(estimator="one_point", backend="pallas")
    p = fresh()
    step = opt.step_fn(loss_fn)
    s = opt.init(p, seed=3)
    p, s, _ = step(p, s, pipe.batch(0))
    path = str(tmp_path / "s.mz")
    save_tree(path, {"params": p, "opt_state": s})
    back, _ = load_tree(path, {"params": fresh(), "opt_state": opt.init(seed=9)})
    assert back["opt_state"] == s
    assert type(back["opt_state"].est_state) is type(s.est_state)


def test_params_checkpoint_loads_in_both_packages(tmp_path, jax_weights):
    """A params checkpoint (bf16 and f32 leaves) written by either package
    loads in the other bitwise — and both write the same bytes."""
    jtree = jax.tree.map(jnp.asarray, jax_weights)
    jtree["layers"]["mlp"]["w1"] = jtree["layers"]["mlp"]["w1"].astype(
        jnp.bfloat16)
    ttree = convert.params_from_jax(jax.tree.map(np.asarray, jtree))
    meta = {"step": 12, "perturb_backend": "pallas+z2", "batch_seeds": 8,
            "exec_plan": "local", "n_groups": 1, "selection": "full",
            "sel_phase": 0}
    jp, tp = str(tmp_path / "j.mz"), str(tmp_path / "t.mz")
    jax_save_tree(jp, {"params": jtree}, meta)
    save_tree(tp, {"params": ttree}, meta)
    with open(jp, "rb") as f1, open(tp, "rb") as f2:
        assert f1.read() == f2.read()
    got, got_meta = load_tree(jp, {"params": convert.params_from_jax(
        jax_weights)})
    assert got_meta == meta
    want, _ = jax_load_tree(tp, {"params": jtree})
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype and bool(jnp.array_equal(a, b))


@pytest.mark.parametrize("obj", [
    {"leaves": [{"path": "['embed']", "dtype": "bfloat16",
                 "shape": [151936, 896], "offset": 0, "nbytes": 272269312}],
     "meta": {"step": 12, "perturb_backend": "pallas+z2", "n": None,
              "flag": True, "lr": 1e-5}},
    [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, -1, -32, -33,
     -128, -129, -32768, -32769, -2**31, -2**31 - 1],
    {"s": "x" * 31, "t": "y" * 32, "u": "z" * 256, "v": "w" * 70000,
     "b": b"\x00\x01", "list": list(range(16)), "map": {str(i): i
                                                        for i in range(16)}},
], ids=["index", "ints", "sizes"])
def test_msgpack_subset_writes_what_msgpack_writes(obj):
    raw = msgpack.packb(obj)
    assert msgpack_lite.packb(obj) == raw
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw)


def test_replay_through_core_replay_uses_the_engine(setup):
    """``core.replay`` drives MZOL3 / MZOL4 ledgers through the engine: the
    replay plan adopts the ledger's n_groups."""
    fresh, loss_fn, pipe, _ = setup
    for prog, magic in (
            (zo.fzoo(lr=1e-6, batch_seeds=2, backend="pallas"), b"MZOL3"),
            (StepProgram(zo.mezo(lr=1e-4, backend="pallas"),
                         seed_parallel(2)), b"MZOL4")):
        led = TrajectoryLedger(base_seed=1, grad_dtype="float32")
        res = train(loss_fn, fresh(), prog, pipe, total_steps=2, ledger=led,
                    seed=1)
        assert led.to_bytes()[:5] == magic
        base = prog.opt if isinstance(prog, StepProgram) else prog
        r = replay(fresh(), TrajectoryLedger.from_bytes(led.to_bytes()),
                   type(base)(base.estimator, base.transform))
        assert max_abs_diff(r, res.params) < 1e-6
