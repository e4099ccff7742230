"""Port parity of selected training: JAX-written MZOL5 ledgers replayed in
the port, the ledger bytes both ways, the refusals, and the launchers.

JAX trains the qwen2-0.5b smoke config (f32) for three steps under each
selection (``pallas-interpret``, weight decay 0.1) and writes the ledger;
the port replays it from the same weights (``convert``):

* bitwise to JAX's own replay for single-stream ledgers (spsa: K1 / K7);
* within ``MULTI_ATOL`` for multi-stream ledgers (fzoo, seed_parallel):
  JAX's replay folds the streams in one jitted graph that XLA:CPU
  contracts differently from the sequential fold the port's K3 / K9 equal
  (ROADMAP Queue 3); sphere's ‖z‖² is also summed in another order (K10).

Every ledger's bytes parse and re-serialize identically in both packages; a
port-trained ledger of the same composition carries JAX's header and
replays to the port's live θ (bitwise for fzoo, within JAX's own
live-vs-replay tolerance for the sequential spsa chain, whose live θ ± εz
round-trips round in f32); replay under another selection refuses with
``SelectionMismatchError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import exec as jexec
from repro import select as jsel
from repro import zo as jzo
from repro.core import TrajectoryLedger as JaxLedger
from repro.core import replay as jax_replay
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.models import peft as jax_peft
from repro_torch import convert
from repro_torch import exec as texec
from repro_torch import select as tsel
from repro_torch import zo
from repro_torch.core import TrajectoryLedger, replay
from repro_torch.data import DataSpec, Pipeline
from repro_torch.models import all_archs, bundle
from repro_torch.models import peft as tpeft
from repro_torch.select import SelectionMismatchError
from repro_torch.serve.tenants import composition_for_ledger
from repro_torch.train import train
from repro_torch.tree_utils import tree_leaves

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

MULTI_ATOL = 1e-6          # JAX's own live-vs-replay tolerance (f32)
STEPS = 3
SEED = 2
ROWS = "rows(block=1,k=4)"

# name: (selection, estimator, n_groups, dist, peft mode)
CASES = {
    "rows": (ROWS, "spsa", 1, "gaussian", None),
    "rows-offset": (("rows", 1, 4, 2), "spsa", 1, "gaussian", None),
    "fzoo4-rows": (ROWS, "fzoo", 1, "gaussian", None),
    "fzoo4-sphere-rows": (ROWS, "fzoo", 1, "sphere", None),
    "sp2-rows": (ROWS, "spsa", 2, "gaussian", None),
    "block_cyclic3": ("block_cyclic(3)", "spsa", 1, "gaussian", None),
    "leaves-attn": ("leaves(\\['attn'\\])", "spsa", 1, "gaussian", None),
    "peft-lora": ("peft(lora)", "spsa", 1, "gaussian", "lora"),
}


def _selection(pkg, sel):
    if isinstance(sel, tuple):
        kind, block, k, offset = sel
        return getattr(pkg, kind)(block, k, phase_offset=offset)
    return sel


def _jax_opt(case):
    sel, est, _, dist, _ = CASES[case]
    sel = _selection(jsel, sel)
    if est == "fzoo":
        return jzo.fzoo(lr=1e-6, eps=1e-3, batch_seeds=4, dist=dist,
                        weight_decay=0.1, backend="pallas-interpret",
                        selection=sel)
    return jzo.mezo(lr=1e-3, eps=1e-3, weight_decay=0.1,
                    backend="pallas-interpret", selection=sel)


def _port_opt(case, selection=None):
    sel, est, _, dist, _ = CASES[case]
    sel = _selection(tsel, sel) if selection is None else selection
    if est == "fzoo":
        return zo.fzoo(lr=1e-6, eps=1e-3, batch_seeds=4, dist=dist,
                       weight_decay=0.1, backend="pallas", selection=sel)
    return zo.mezo(lr=1e-3, eps=1e-3, weight_decay=0.1, backend="pallas",
                   selection=sel)


def _multi_stream(case) -> bool:
    _, est, n_groups, _, _ = CASES[case]
    return est == "fzoo" or n_groups > 1


@pytest.fixture(scope="module")
def base():
    cfg = jax_archs()["qwen2-0.5b"].smoke_cfg
    return cfg, jax.tree.map(np.asarray,
                             jax_bundle(cfg).init(jax.random.PRNGKey(0)))


def _weights(base, case):
    """The case's θ₀ as numpy: the smoke tree, or the LoRA-merged tree."""
    cfg, w = base
    mode = CASES[case][4]
    if mode is None:
        return w
    lora = jax.tree.map(np.asarray, jax_peft.init_lora(
        cfg, jax.random.PRNGKey(1)))
    # a nonzero B, so the first step's loss depends on A as well
    lora["wq"]["b"] = np.full_like(lora["wq"]["b"], 0.01)
    return jax_peft.peft_params(w, lora, mode)


_JAX_RUNS: dict = {}


def _jax_run(base, case):
    """(θ₀ numpy, JAX ledger bytes, JAX replay θ) — computed once."""
    if case in _JAX_RUNS:
        return _JAX_RUNS[case]
    cfg, _ = base
    w = _weights(base, case)
    mode = CASES[case][4]
    loss = (jax_peft.peft_loss_fn(cfg, mode) if mode
            else jax_bundle(cfg).loss_fn())
    n_groups = CASES[case][2]
    prog = jexec.StepProgram(_jax_opt(case), jexec.seed_parallel(n_groups)
                             if n_groups > 1 else None)
    meta = prog.meta
    led = JaxLedger(base_seed=SEED, grad_dtype="float32",
                    backend=meta["perturb_backend"],
                    batch_seeds=meta["batch_seeds"],
                    exec_plan=meta["exec_plan"], n_groups=meta["n_groups"],
                    selection=meta["selection"], sel_phase=meta["sel_phase"])
    state = prog.init(None, seed=SEED)
    step = jax.jit(prog.step_fn(loss))
    p = jax.tree.map(jnp.asarray, w)
    for t in range(STEPS):
        p, state, m = step(p, state, jax_lm_batch(4, t, 4, 16, 256))
        g = m.get("projected_grads")
        led.append(t, np.asarray(g) if g is not None
                   else float(m["projected_grad"]), float(m["lr"]))
    raw = led.to_bytes()
    replayed = jax_replay(jax.tree.map(jnp.asarray, w),
                          JaxLedger.from_bytes(raw), _jax_opt(case))
    _JAX_RUNS[case] = (w, raw, [np.asarray(x) for x in
                                jax.tree_util.tree_leaves(replayed)])
    return _JAX_RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_replays_jax_ledger(base, case):
    w, raw, want = _jax_run(base, case)
    led = TrajectoryLedger.from_bytes(raw)
    assert raw[:5] == b"MZOL5" and led.to_bytes() == raw
    got = replay(convert.params_from_jax(w), led, _port_opt(case))
    for g, j in zip(tree_leaves(got), want):
        g = g.numpy()
        if _multi_stream(case):
            np.testing.assert_allclose(g, j, rtol=0, atol=MULTI_ATOL)
        else:
            assert np.array_equal(g.view(np.uint32), j.view(np.uint32))
    # the header alone rebuilds a composition that replays it identically
    again = replay(convert.params_from_jax(w), led, _rebuilt(led, case))
    for a, b in zip(tree_leaves(got), tree_leaves(again)):
        assert torch.equal(a, b)


def _rebuilt(led, case):
    """``composition_for_ledger``'s composition with the case's lr / wd
    (the header records the selection and coordinates, not the chain)."""
    comp = composition_for_ledger(led)
    opt = _port_opt(case, selection=comp.selection)
    assert (comp.selection_spec, comp.selection_phase, comp.batch_seeds) == \
        (opt.selection_spec, opt.selection_phase, opt.batch_seeds)
    return opt


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_ledger_bytes_and_live_replay(base, case):
    """A port-trained ledger of the same composition has JAX's header and
    round-trips through JAX's reader byte for byte; the port's live θ equals
    its replay (bitwise for the multi-stream fold, within JAX's tolerance
    for the sequential spsa chain); unselected leaves never move."""
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    w, raw, _ = _jax_run(base, case)
    mode = CASES[case][4]
    loss = (tpeft.peft_loss_fn(cfg, mode) if mode
            else bundle(cfg).loss_fn())
    n_groups = CASES[case][2]
    opt = _port_opt(case)
    prog = texec.StepProgram(opt, texec.seed_parallel(n_groups)
                             if n_groups > 1 else None)
    led = TrajectoryLedger(base_seed=SEED, grad_dtype="float32")
    pipe = Pipeline(DataSpec("lm", batch=4, seq=16, vocab=256, seed=4),
                    device="cpu")
    p0 = convert.params_from_jax(w)
    res = train(loss, convert.params_from_jax(w), prog, pipe,
                total_steps=STEPS, ledger=led, seed=SEED)
    mine = led.to_bytes()
    jled = JaxLedger.from_bytes(raw)
    assert JaxLedger.from_bytes(mine).to_bytes() == mine
    back = TrajectoryLedger.from_bytes(mine)
    assert (back.backend, back.batch_seeds, back.exec_plan, back.n_groups,
            back.selection, back.sel_phase) == (
        jled.backend, jled.batch_seeds, jled.exec_plan, jled.n_groups,
        jled.selection, jled.sel_phase)
    rep = replay(convert.params_from_jax(w), back, _port_opt(case))
    for a, b in zip(tree_leaves(rep), tree_leaves(res.params)):
        if CASES[case][1] == "fzoo":
            # fzoo's update and its replay make the same affine_many call
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) < MULTI_ATOL
    # leaves no phase of the run selected are bitwise θ₀
    sel = opt.selection
    touched = np.zeros(len(tree_leaves(p0)), bool)
    for t in range(STEPS):
        touched |= np.asarray(sel.leaf_mask(p0, sel.phase_at(t)))
    for hit, a, b in zip(touched, tree_leaves(res.params), tree_leaves(p0)):
        if not hit:
            assert torch.equal(a, b)
    assert touched.any() and (mode is None or not touched.all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_under_another_selection_refuses(base, case):
    _, raw, _ = _jax_run(base, case)
    led = TrajectoryLedger.from_bytes(raw)
    other = tsel.block_cyclic(2) if CASES[case][0] != "block_cyclic(2)" \
        else tsel.rows(1, 4)
    w = _weights(base, case)
    with pytest.raises(SelectionMismatchError, match="parameter selection"):
        replay(convert.params_from_jax(w), led,
               _port_opt(case, selection=other))
    if CASES[case][0] == ROWS:
        with pytest.raises(SelectionMismatchError, match="phase offset"):
            replay(convert.params_from_jax(w), led,
                   _port_opt(case, selection=tsel.rows(1, 4, 1)))


def test_rows_k1_is_full_bitwise(base):
    """rows(block=R, k=1) selects everything: spsa and fzoo steps are
    bitwise the full-tree steps (the whole-leaf kernels run)."""
    cfg, w = base
    loss = bundle(all_archs()["qwen2-0.5b"].smoke_cfg).loss_fn()
    pipe = Pipeline(DataSpec("lm", batch=4, seq=16, vocab=256, seed=4),
                    device="cpu")
    for make in (lambda s: zo.mezo(lr=1e-3, backend="pallas", selection=s),
                 lambda s: zo.fzoo(lr=1e-6, batch_seeds=2, backend="pallas",
                                   selection=s)):
        outs = []
        for s in (None, "rows(block=3,k=1)"):
            outs.append(train(loss, convert.params_from_jax(w), make(s), pipe,
                              total_steps=2, seed=1).params)
        for a, b in zip(*map(tree_leaves, outs)):
            assert torch.equal(a, b)


def test_seed_parallel_1_is_local_bitwise_under_rows(base):
    _, w = base
    loss = bundle(all_archs()["qwen2-0.5b"].smoke_cfg).loss_fn()
    batch = Pipeline(DataSpec("lm", batch=4, seq=16, vocab=256, seed=4),
                     device="cpu").batch(0)
    outs = []
    for plan in (texec.local(), texec.seed_parallel(1)):
        prog = texec.StepProgram(_port_opt("rows"), plan)
        p = convert.params_from_jax(w)
        s = prog.init(p, seed=3)
        step = prog.step_fn(loss)
        for _ in range(2):
            p, s, _ = step(p, s, batch)
        outs.append(p)
    for a, b in zip(*map(tree_leaves, outs)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# The launchers
# --------------------------------------------------------------------------- #
def test_train_cli_rows_trains_resumes_and_refuses_another_selection(
        tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    run = str(tmp_path / "run")
    argv = ["--smoke", "--device", "cpu", "--backend", "pallas", "--batch",
            "4", "--seq", "8", "--ckpt-dir", run, "--ckpt-interval", "2"]
    train_cli.main(argv + ["--select", ROWS, "--steps", "3"])
    out = capsys.readouterr().out
    assert f"parameter selection: {ROWS}" in out
    assert "done: 3 steps (resumed from 0)" in out
    train_cli.main(argv + ["--select", ROWS, "--steps", "5"])
    assert "done: 2 steps (resumed from 3)" in capsys.readouterr().out
    led = TrajectoryLedger.from_bytes((tmp_path / "run" / "ledger.mzl")
                                      .read_bytes())
    assert led.to_bytes()[:5] == b"MZOL5" and led.selection == ROWS
    assert led.steps == [0, 1, 2, 3, 4]
    with pytest.raises(SelectionMismatchError):
        train_cli.main(argv + ["--select", "rows(block=1,k=2)", "--steps",
                               "7"])
    train_cli.main(["--smoke", "--device", "cpu", "--backend", "pallas",
                    "--batch", "2", "--seq", "8", "--steps", "1", "--select",
                    "auto"])
    assert "--select auto -> 'full'" in capsys.readouterr().out


def test_serve_cli_replays_a_rows_ledger(base, tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    _, raw, _ = _jax_run(base, "rows")
    path = tmp_path / "rows.mzl"
    path.write_bytes(raw)
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "2",
                    "--new-tokens", "2", "--ledger", str(path)])
    out = capsys.readouterr().out
    assert f"replayed {STEPS} ledger steps" in out
    assert "2 requests / 4 tokens" in out
