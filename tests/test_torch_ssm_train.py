"""Port parity of the ssm family's paths: training, ledger replay and
serving, on the rwkv6-3b smoke config in f32.

* JAX trains the smoke model (``mezo`` spsa, ``pallas-interpret``, weight
  decay 0.1) for three steps and writes the ledger; the port replays it from
  the same weights (``convert``) bitwise equal to JAX's own replay — K1 does
  not know the family.
* The first step's loss equals JAX's within the forward tolerance.
* The port's non-paged engine emits JAX's ``ServeEngine`` greedy ids on the
  same weights and refuses as JAX refuses (``paged=True`` on a recurrent
  family, an over-long prompt).
* ``launch.train --model-family ssm`` trains and resumes on the CPU and
  takes ``--scan-mode``; ``launch.serve --arch rwkv6-3b`` replays a ledger
  and serves it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import zo as jzo
from repro.core import TrajectoryLedger as JaxLedger
from repro.core import replay as jax_replay
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch import zo
from repro_torch.core import TrajectoryLedger, replay
from repro_torch.models import all_archs, bundle
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree_utils import tree_leaves

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

LOSS_ATOL = 1e-5
STEPS = 3
SEED = 2


@pytest.fixture(scope="module")
def weights():
    """The smoke model with a nonzero decay LoRA, logit and bonus, so the
    recurrence is data-dependent."""
    cfg = jax_archs()["rwkv6-3b"].smoke_cfg
    w = jax.tree.map(np.asarray, jax_bundle(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    tm = w["layers"]["tm"]
    for name, scale in (("w_lora_b", 0.5), ("w0", 1.0), ("u", 1.0)):
        tm[name] = (rng.standard_normal(tm[name].shape)
                    * scale).astype(np.float32)
    return w


def _jax_opt():
    return jzo.mezo(lr=1e-3, eps=1e-3, weight_decay=0.1,
                    backend="pallas-interpret")


def _port_opt():
    return zo.mezo(lr=1e-3, eps=1e-3, weight_decay=0.1, backend="pallas")


@pytest.fixture(scope="module")
def jax_run(weights):
    """(ledger bytes, JAX replay leaves, first-step loss) of a 3-step JAX
    run on batches of 4 × 16 tokens."""
    cfg = jax_archs()["rwkv6-3b"].smoke_cfg
    opt = _jax_opt()
    led = JaxLedger(base_seed=SEED, grad_dtype="float32",
                    backend=opt.backend_name)
    state = opt.init(None, seed=SEED)
    step = jax.jit(opt.step_fn(jax_bundle(cfg).loss_fn()))
    p = jax.tree.map(jnp.asarray, weights)
    losses = []
    for t in range(STEPS):
        p, state, m = step(p, state, jax_lm_batch(4, t, 4, 16, 256))
        led.append(t, float(m["projected_grad"]), float(m["lr"]))
        losses.append(float(m["loss"]))
    raw = led.to_bytes()
    replayed = jax_replay(jax.tree.map(jnp.asarray, weights),
                          JaxLedger.from_bytes(raw), _jax_opt())
    return raw, [np.asarray(x) for x in jax.tree_util.tree_leaves(replayed)], \
        losses[0]


def test_port_replays_jax_ssm_ledger_bitwise(weights, jax_run):
    raw, want, _ = jax_run
    led = TrajectoryLedger.from_bytes(raw)
    assert led.backend == "pallas+z2" and led.steps == list(range(STEPS))
    assert led.to_bytes() == raw
    got = replay(convert.params_from_jax(weights), led, _port_opt())
    leaves = tree_leaves(got)
    assert len(leaves) == len(want) == 26
    for g, w in zip(leaves, want):
        assert np.array_equal(g.numpy().view(np.uint32), w.view(np.uint32))


def test_first_step_loss_matches_jax(weights, jax_run):
    cfg = all_archs()["rwkv6-3b"].smoke_cfg
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in jax_lm_batch(4, 0, 4, 16, 256).items()}
    opt = _port_opt()
    p = convert.params_from_jax(weights)
    _, state, m = opt.step_fn(bundle(cfg).loss_fn())(p, opt.init(p, seed=SEED),
                                                     batch)
    assert abs(float(m["loss"]) - jax_run[2]) <= LOSS_ATOL
    assert state.step == 1 and np.isfinite(float(m["projected_grad"]))


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #
def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 255, int(rng.integers(3, 30)))]
            for _ in range(5)]


def _serve(engine, request_cls, prompts, n_new=6):
    reqs = [request_cls(i, p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [r.out_ids for r in reqs]


def test_engine_greedy_ids_match_jax(weights):
    jcfg = jax_archs()["rwkv6-3b"].smoke_cfg
    tcfg = all_archs()["rwkv6-3b"].smoke_cfg
    prompts = _prompts()
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, weights), slots=3,
                     max_len=64)
    teng = ServeEngine(tcfg, convert.params_from_jax(weights), slots=3,
                       max_len=64, device="cpu")
    want = _serve(jeng, JaxRequest, prompts)
    got = _serve(teng, Request, prompts)
    assert not jeng.paged and not teng.paged and teng.pool is None
    assert got == want and all(len(ids) == 6 for ids in got)
    st = teng.prefix_stats()
    assert st["prefill_tokens_computed"] == st["prefill_tokens_submitted"] \
        == sum(map(len, prompts))
    assert st["prefill_batches"] == len(prompts)


def test_engine_refusals_match_jax(weights):
    jcfg = jax_archs()["rwkv6-3b"].smoke_cfg
    tcfg = all_archs()["rwkv6-3b"].smoke_cfg
    jw, tw = jax.tree.map(jnp.asarray, weights), convert.params_from_jax(weights)
    with pytest.raises(ValueError) as je:
        JaxEngine(jcfg, jw, slots=2, max_len=32, paged=True)
    with pytest.raises(ValueError) as te:
        ServeEngine(tcfg, tw, slots=2, max_len=32, paged=True, device="cpu")
    assert str(te.value) == str(je.value)
    jeng = JaxEngine(jcfg, jw, slots=2, max_len=32)
    teng = ServeEngine(tcfg, tw, slots=2, max_len=32, device="cpu")
    long_prompt = list(range(1, 33))
    with pytest.raises(ValueError) as je:
        jeng.submit(JaxRequest(0, long_prompt))
    with pytest.raises(ValueError) as te:
        teng.submit(Request(0, long_prompt))
    assert str(te.value) == str(je.value)
    dense = all_archs()["qwen2-0.5b"].smoke_cfg
    with pytest.raises(NotImplementedError, match="other-families slice"):
        ServeEngine(dense, None, paged=False, device="cpu")
    with pytest.raises(NotImplementedError, match="other-families slice"):
        ServeEngine(dense.replace(sliding_window=8), None, device="cpu")


# --------------------------------------------------------------------------- #
# The launchers
# --------------------------------------------------------------------------- #
def test_train_cli_trains_and_resumes_ssm_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    run = str(tmp_path / "run")
    base = ["--model-family", "ssm", "--smoke", "--device", "cpu",
            "--backend", "pallas", "--batch", "2", "--seq", "16",
            "--ckpt-dir", run, "--ckpt-interval", "2"]
    train_cli.main(base + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "rwkv6-3b-smoke" in out and "done: 2 steps (resumed from 0)" in out
    train_cli.main(base + ["--steps", "3", "--scan-mode", "fused_recurrent"])
    assert "done: 1 steps (resumed from 2)" in capsys.readouterr().out
    path = tmp_path / "run" / "ledger.mzl"
    led = TrajectoryLedger.from_bytes(path.read_bytes())
    assert led.backend == "pallas+z2" and led.steps == [0, 1, 2]
    train_cli.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                    "--backend", "pallas", "--batch", "2", "--seq", "8",
                    "--steps", "1", "--select", "auto"])
    assert "--select auto -> 'full'" in capsys.readouterr().out
    serve_cli.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                    "--ledger", str(path), "--requests", "3",
                    "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "replayed 3 ledger steps" in out and "recurrent state" in out
    assert "3 requests / 9 tokens" in out
