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
