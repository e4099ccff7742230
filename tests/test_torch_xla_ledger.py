"""Ledgers of the default ``xla`` stream both ways, on the qwen2-0.5b smoke
config (f32, and cast to bf16, qwen2's dtype):

* a JAX-written ``xla`` ledger — MZOL2, and an MZOL1 one, whose format
  predates backend records and implies ``xla`` — replays in the port
  bitwise equal to ``repro.core.replay`` from the same θ₀ (``convert``);
* a JAX-trained ledger (JAX's training loop on its default backend)
  replays in the port bitwise;
* a port-trained ledger is byte-identical in format (JAX reads and
  rewrites it to the same bytes) and replays in JAX bitwise;
* resuming across backends raises ``BackendMismatchError``, as in JAX.

The partitionable threefry layout is pinned on (the one the port
reproduces).
"""
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import zo as jzo
from repro.core import TrajectoryLedger as JaxLedger
from repro.core import replay as jax_replay
from repro.data.pipeline import DataSpec as JaxSpec
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.serve.tenants import composition_for_ledger as jax_composition
from repro.train.loop import train as jax_train
from repro_torch import convert, zo
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import TrajectoryLedger, replay
from repro_torch.data import DataSpec, Pipeline
from repro_torch.models import all_archs, bundle
from repro_torch.perturb import BackendMismatchError
from repro_torch.serve.tenants import composition_for_ledger
from repro_torch.train import train

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

LOSS_ATOL = 1e-5


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


def _as(weights, dtype: str):
    if dtype == "float32":
        return weights
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(
        jnp.bfloat16)), weights)


def _records():
    return [(0, 0.7, 1e-2), (1, -1.3, 1e-2), (5, 2.1, 5e-3)]


def _raw(magic: str) -> bytes:
    if magic == "MZOL2":
        led = JaxLedger(base_seed=3, grad_dtype="float32", backend="xla")
        for s, g, lr in _records():
            led.append(s, g, lr)
        return led.to_bytes()
    steps, grads, lrs = zip(*_records())
    return (b"MZOL1\x00" + struct.pack("<qi", 3, 0)
            + struct.pack("<q", len(steps))
            + np.asarray(steps, np.int64).tobytes()
            + np.asarray(grads, np.float32).tobytes()
            + np.asarray(lrs, np.float32).tobytes())


def _same(jtree, ttree) -> None:
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jtree))
    got = jax.tree_util.tree_leaves(convert.params_to_jax(ttree))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        assert np.array_equal(w.view(np.uint8), g.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("magic", ["MZOL1", "MZOL2"])
def test_jax_written_xla_ledger_replays_bitwise(weights, magic, dtype):
    raw = _raw(magic)
    assert raw[:5] == magic.encode()
    w = _as(weights, dtype)
    jled, tled = JaxLedger.from_bytes(raw), TrajectoryLedger.from_bytes(raw)
    assert jled.backend == tled.backend == "xla"
    want = jax_replay(jax.tree.map(jnp.asarray, w), jled,
                      jax_composition(jled))
    got = replay(convert.params_from_jax(w), tled,
                 composition_for_ledger(tled))
    _same(want, got)
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want)),
        jax.tree_util.tree_leaves(w))]
    assert all(moved)


def test_jax_trained_ledger_replays_bitwise_in_the_port(weights):
    """JAX's own training loop on its default backend: its ledger replays
    in the port to JAX's replay, bitwise; the port's first-step loss on the
    same (now identical) batches matches JAX's."""
    jcfg = jax_archs()["qwen2-0.5b"].smoke_cfg
    led = JaxLedger(base_seed=2, grad_dtype="float32", backend="xla")
    jres = jax_train(jax_bundle(jcfg).loss_fn(),
                     jax.tree.map(jnp.asarray, weights),
                     jzo.mezo(lr=1e-3, eps=1e-3), JaxPipeline(JaxSpec(
                         "lm", batch=4, seq=16, vocab=256, seed=4)),
                     total_steps=3, ledger=led, seed=2, log_every=1)
    raw = led.to_bytes()
    want = jax_replay(jax.tree.map(jnp.asarray, weights),
                      JaxLedger.from_bytes(raw), jzo.mezo())
    tled = TrajectoryLedger.from_bytes(raw)
    got = replay(convert.params_from_jax(weights), tled,
                 composition_for_ledger(tled))
    _same(want, got)
    tcfg = all_archs()["qwen2-0.5b"].smoke_cfg
    tres = train(bundle(tcfg).loss_fn(), convert.params_from_jax(weights),
                 zo.mezo(lr=1e-3, eps=1e-3), Pipeline(DataSpec(
                     "lm", batch=4, seq=16, vocab=256, seed=4),
                     device="cpu"), total_steps=1, seed=2, log_every=1)
    assert abs(tres.losses[0][1] - float(jres.losses[0][1])) <= LOSS_ATOL


def test_port_written_xla_ledger_is_jax_format_and_replays_in_jax(weights):
    tcfg = all_archs()["qwen2-0.5b"].smoke_cfg
    led = TrajectoryLedger(base_seed=2, grad_dtype="float32")
    train(bundle(tcfg).loss_fn(), convert.params_from_jax(weights),
          zo.mezo(lr=1e-3, eps=1e-3, weight_decay=0.1), Pipeline(DataSpec(
              "lm", batch=4, seq=16, vocab=256, seed=4), device="cpu"),
          total_steps=3, ledger=led, seed=2)
    raw = led.to_bytes()
    assert raw[:5] == b"MZOL2" and led.backend == "xla"
    jled = JaxLedger.from_bytes(raw)
    assert jled.to_bytes() == raw and jled.backend == "xla"
    assert jled.content_hash() == led.content_hash()
    want = jax_replay(jax.tree.map(jnp.asarray, weights), jled,
                      jzo.mezo(weight_decay=0.1))
    got = replay(convert.params_from_jax(weights), led,
                 zo.mezo(weight_decay=0.1))
    _same(want, got)


@pytest.mark.parametrize("first,then", [("xla", "pallas"),
                                        ("pallas", "xla")])
def test_resume_across_backends_raises(tmp_path, first, then):
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    loss_fn = bundle(cfg).loss_fn()
    pipe = Pipeline(DataSpec("lm", batch=2, seq=8, vocab=cfg.vocab_size,
                             seed=1), device="cpu")
    ck = CheckpointManager(str(tmp_path), interval=1)
    train(loss_fn, bundle(cfg).init(0, device="cpu"),
          zo.mezo(backend=first), pipe, total_steps=2, ckpt=ck,
          ledger=TrajectoryLedger(base_seed=0, grad_dtype="float32"))
    recorded = zo.mezo(backend=first).backend_name      # the stream id
    with pytest.raises(BackendMismatchError,
                       match=re.escape(f"recorded under the {recorded!r}")):
        train(loss_fn, bundle(cfg).init(0, device="cpu"),
              zo.mezo(backend=then), pipe, total_steps=3, ckpt=ck,
              ledger=TrajectoryLedger(base_seed=0, grad_dtype="float32"))


def test_train_cli_defaults_run_xla_and_serve(tmp_path, capsys):
    """``launch.train`` with JAX's defaults (no ``--backend``) trains on the
    ``xla`` stream and writes an MZOL2 ledger that ``launch.serve``
    replays; ``--optimizer mezo-adam`` trains without a ledger, as JAX's
    launcher does, and resumes from its checkpoint."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    run = tmp_path / "run"
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "8"]
    train_cli.main(base + ["--steps", "2", "--ckpt-dir", str(run)])
    assert "done: 2 steps" in capsys.readouterr().out
    raw = (run / "ledger.mzl").read_bytes()
    assert raw[:5] == b"MZOL2"
    assert TrajectoryLedger.from_bytes(raw).backend == "xla"
    serve_cli.main(["--smoke", "--device", "cpu", "--ledger",
                    str(run / "ledger.mzl"), "--requests", "2",
                    "--new-tokens", "2"])
    assert "replayed 2 ledger steps" in capsys.readouterr().out
    adam = tmp_path / "adam"
    args = base + ["--optimizer", "mezo-adam", "--ckpt-dir", str(adam),
                   "--ckpt-interval", "1"]
    train_cli.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "optimizer=mezo-adam" in out and "ledger:" not in out
    assert not (adam / "ledger.mzl").exists()
    train_cli.main(args + ["--steps", "3"])
    assert "done: 1 steps (resumed from 2)" in capsys.readouterr().out
