"""The port's architecture-axis conformance matrix — the counterpart of
``tests/test_zoo_conformance.py``'s ``test_family_conformance``: every
registry family (dense, moe, ssm, encdec, hybrid) × estimator (spsa, fzoo)
× backend (``xla``, ``pallas``) on the smoke configs in f32 on the CPU,
through the port alone, on real model forwards:

* ``seed_parallel(1)`` ≡ ``local`` bitwise;
* the ledger round-trips through its bytes (the selection kept) and
  replays to the live θ within 2e-6; two replays are bitwise equal.

moe runs its grouped expert layout under ``moe_experts(2)``, the
registry's default (router frozen, one group a step, an MZOL5 ledger).
The batch is the registry's ``make_batch`` (frames and tokens for encdec).
The fzoo × ``xla`` cells carry JAX's ``slow`` mark, as in JAX.  This file
holds the dense, moe and ssm cells; ``test_torch_zoo_conformance_more.py``
runs the same test on the encdec and hybrid cells (the plain ``xla``
stream's f32 writes make a cell seconds long on the CPU).
"""
import pytest
torch = pytest.importorskip("torch")

from repro_torch import exec as zexec
from repro_torch import zo
from repro_torch.core import TrajectoryLedger, replay
from repro_torch.exec import StepProgram
from repro_torch.models import bundle, family_arch
from repro_torch.perturb.stream import prng_key
from repro_torch.tree_utils import tree_clone, tree_leaves

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

FAMILIES = ("dense", "moe", "ssm", "encdec", "hybrid")
BACKENDS = ("xla", "pallas")
STEPS, SEED, BATCH, SEQ = 2, 3, 2, 8
MOE_GROUPS = 2
REPLAY_ATOL = 2e-6      # JAX's live-vs-replay bound (one f32 ulp of g·lr)


def _family_setup(fam):
    cfg = family_arch(fam)
    sel = None
    if fam == "moe":
        cfg = cfg.replace(expert_groups=MOE_GROUPS)
        sel = f"moe_experts({MOE_GROUPS})"
    b = bundle(cfg)
    params = b.init(0, device="cpu")
    batch = b.make_batch(prng_key(1), BATCH, SEQ, device="cpu")
    return b.loss_fn(), params, batch, sel


def _make_opt(estimator, backend, sel):
    if estimator == "spsa":
        return zo.mezo(lr=1e-4, eps=1e-3, backend=backend, selection=sel)
    return zo.fzoo(lr=1e-4, eps=1e-3, batch_seeds=2, backend=backend,
                   selection=sel)


def _run_plan(opt, plan, loss_fn, params, batch, ledger=None):
    prog = StepProgram(opt, plan)
    p = tree_clone(params)
    state = prog.init(p, seed=SEED)
    step = prog.step_fn(loss_fn)
    for i in range(STEPS):
        p, state, m = step(p, state, batch)
        if ledger is not None:
            g = m.get("projected_grads")
            ledger.append(i, g if g is not None else float(m["projected_grad"]),
                          float(m["lr"]))
    return p


def _ledger_for(prog):
    meta = prog.meta
    return TrajectoryLedger(base_seed=SEED, grad_dtype="float32",
                            backend=meta["perturb_backend"],
                            batch_seeds=meta["batch_seeds"],
                            exec_plan=meta["exec_plan"],
                            n_groups=meta["n_groups"],
                            selection=meta["selection"],
                            sel_phase=meta["sel_phase"])


def _max_diff(a, b) -> float:
    return max((float((x.float() - y.float()).abs().max())
                for x, y in zip(tree_leaves(a), tree_leaves(b))), default=0.0)


def _cells(families=FAMILIES[:3]):
    out = []
    for fam in families:
        for est in ("spsa", "fzoo"):
            for bk in BACKENDS:
                marks = ([pytest.mark.slow]
                         if (est == "fzoo" and bk == "xla") else [])
                out.append(pytest.param(fam, est, bk,
                                        id=f"{fam}-{est}-{bk}", marks=marks))
    return out


@pytest.mark.parametrize("fam,estimator,backend", _cells())
def test_family_conformance(fam, estimator, backend):
    check_family_conformance(fam, estimator, backend)


def check_family_conformance(fam, estimator, backend):
    loss_fn, params, batch, sel = _family_setup(fam)
    led = _ledger_for(StepProgram(_make_opt(estimator, backend, sel),
                                  zexec.local()))
    p_live = _run_plan(_make_opt(estimator, backend, sel), zexec.local(),
                       loss_fn, params, batch, ledger=led)
    p_sp1 = _run_plan(_make_opt(estimator, backend, sel),
                      zexec.seed_parallel(1), loss_fn, params, batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_live),
                                                 tree_leaves(p_sp1)))
    assert _max_diff(p_live, params) > 0.0          # the steps moved θ
    led2 = TrajectoryLedger.from_bytes(led.to_bytes())
    assert led2.selection == led.selection and len(led2) == STEPS
    rec = replay(tree_clone(params), led2, _make_opt(estimator, backend, sel))
    assert _max_diff(rec, p_live) < REPLAY_ATOL
    rec2 = replay(tree_clone(params), led2, _make_opt(estimator, backend, sel))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(rec),
                                                 tree_leaves(rec2)))
