"""Port hygiene: ``src/repro_torch`` and ``chip_smoke.py`` import neither
JAX nor the JAX package; entry points run on the card unless the caller
asks for the CPU, and never fall back to it quietly; the serving launcher
works end to end on the CPU, replaying a JAX-written ledger."""
import ast
import pathlib

import pytest
import torch

from repro.core import TrajectoryLedger as JaxLedger
from repro_torch.launch import serve as serve_cli
from repro_torch.models import all_archs, bundle
from repro_torch.serve.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    assert len(PORT_FILES) > 20
    bad = {str(p.relative_to(ROOT)): sorted(r & {"jax", "jaxlib", "repro"})
           for p in PORT_FILES
           if _imported_roots(p) & {"jax", "jaxlib", "repro"}}
    assert not bad, bad


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bundle(cfg).init(0)
    params = bundle(cfg).init(0, device="cpu")
    assert params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--smoke"])


def test_serve_cli_replays_a_jax_ledger_on_cpu(tmp_path, capsys):
    led = JaxLedger(base_seed=1, grad_dtype="float32", backend="pallas+z2")
    led.append(0, 0.5, 1e-3)
    led.append(1, -0.25, 1e-3)
    path = tmp_path / "run.mzl"
    path.write_bytes(led.to_bytes())
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                    "--new-tokens", "3", "--ledger", str(path)])
    out = capsys.readouterr().out
    assert "replayed 2 ledger steps" in out and "backend=pallas+z2" in out
    assert "3 requests / 9 tokens" in out
    with pytest.raises(SystemExit, match="tenants slice"):
        serve_cli.main(["--smoke", "--device", "cpu", "--tenants", "2"])


# --------------------------------------------------------------------------- #
# The training launcher, the default backend, composition_for_ledger
# --------------------------------------------------------------------------- #
def test_train_cli_needs_the_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.launch import train as train_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--backend", "pallas", "--steps", "1"])


def test_train_cli_trains_and_resumes_on_cpu(tmp_path, capsys):
    from repro_torch.core import TrajectoryLedger
    from repro_torch.launch import train as train_cli
    run = str(tmp_path / "run")
    base = ["--smoke", "--device", "cpu", "--backend", "pallas",
            "--batch", "4", "--seq", "16", "--ckpt-dir", run,
            "--ckpt-interval", "2"]
    train_cli.main(base + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "done: 3 steps (resumed from 0)" in out and "device=cpu" in out
    train_cli.main(base + ["--steps", "5"])
    assert "done: 2 steps (resumed from 3)" in capsys.readouterr().out
    led = TrajectoryLedger.from_bytes((tmp_path / "run" / "ledger.mzl")
                                      .read_bytes())
    assert led.backend == "pallas+z2" and led.steps == [0, 1, 2, 3, 4]
    train_cli.main(["--smoke", "--device", "cpu", "--backend", "pallas",
                    "--estimator", "fzoo", "--batch-seeds", "2",
                    "--exec-plan", "seed_parallel", "--n-groups", "2",
                    "--batch", "4", "--seq", "8", "--steps", "2"])
    assert "exec plan: seed_parallel(n_groups=2)" in capsys.readouterr().out


@pytest.mark.parametrize("argv,slice_name", [
    ([], "backend pallas"),
    (["--backend", "pallas", "--optimizer", "mezo-adam"], "mezo_adam"),
    (["--backend", "pallas", "--optimizer", "adam"], "backprop"),
    (["--backend", "pallas", "--select", "block_cyclic(2)"], "Slice C"),
    (["--backend", "pallas", "--objective", "accuracy"], "objectives"),
    (["--backend", "pallas", "--model-family", "moe"], "Slice D"),
], ids=["xla", "mezo-adam", "adam", "select", "objective", "family"])
def test_train_cli_refuses_later_slices(argv, slice_name):
    from repro_torch.launch import train as train_cli
    with pytest.raises(SystemExit, match=slice_name):
        train_cli.main(["--smoke", "--device", "cpu"] + argv)


@pytest.mark.parametrize("env", [None, "pallas", "xla"],
                         ids=["unset", "env-pallas", "env-xla"])
@pytest.mark.parametrize("spec", [None, "pallas", "xla", "nope"])
def test_backend_resolution_matches_jax(monkeypatch, env, spec):
    """``get_backend`` resolves as JAX's does — None → $REPRO_BACKEND, else
    "xla" — and refuses loudly where JAX would build the unported xla
    stream."""
    from repro.perturb import get_backend as jax_get_backend
    from repro_torch.perturb import get_backend
    if env is None:
        monkeypatch.delenv("REPRO_BACKEND", raising=False)
    else:
        monkeypatch.setenv("REPRO_BACKEND", env)
    try:
        want = jax_get_backend(spec).name
    except KeyError:
        with pytest.raises(KeyError, match="unknown perturbation backend"):
            get_backend(spec)
        return
    if want == "xla":
        with pytest.raises(NotImplementedError, match="backend='pallas'"):
            get_backend(spec)
    else:
        got = get_backend(spec)
        assert got.name == want and got.stream_id == jax_get_backend(
            spec).stream_id
        assert get_backend(spec) is got                # one cached instance


def test_pallas_interpret_is_refused_with_a_pointer_to_the_cpu(monkeypatch):
    from repro_torch import zo
    from repro_torch.perturb import get_backend
    with pytest.raises(ValueError, match="device='cpu'"):
        get_backend("pallas-interpret")
    monkeypatch.setenv("REPRO_BACKEND", "pallas-interpret")
    with pytest.raises(ValueError, match="device='cpu'"):
        zo.mezo()


def test_composition_for_ledger_rebuilds_like_jax():
    from repro.serve.tenants import composition_for_ledger as jax_comp
    from repro_torch.core import TrajectoryLedger
    from repro_torch.serve.tenants import composition_for_ledger
    for kw, streams in ((dict(batch_seeds=4), 4),
                        (dict(n_groups=2, exec_plan="seed_parallel"), 2),
                        (dict(batch_seeds=2, n_groups=2,
                              exec_plan="seed_parallel"), 4),
                        ({}, 1)):
        led = TrajectoryLedger(base_seed=0, backend="pallas+z2", **kw)
        led.append(0, [0.5] * streams if streams > 1 else 0.5, 1e-3)
        jled = JaxLedger.from_bytes(led.to_bytes())
        t, j = composition_for_ledger(led), jax_comp(jled)
        assert (t.name, t.estimator.name, t.batch_seeds, t.backend_name) == \
            (j.name, j.estimator.name, j.batch_seeds, j.backend_name)
    led = TrajectoryLedger(base_seed=0, backend="pallas+z2",
                           selection="block_cyclic(2)")
    with pytest.raises(NotImplementedError, match="selection slice"):
        composition_for_ledger(led)
