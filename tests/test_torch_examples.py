"""The port's examples (``repro_torch.examples``) run to their end on the
CPU at a few steps, printing JAX's lines; ``train_100m --smoke`` under a
rows selection probes JAX's count of frozen elements and writes JAX's
ledger byte size, JAX's own example run beside it."""
import importlib.util
import pathlib
import re
import sys

import pytest
torch = pytest.importorskip("torch")

from repro_torch.examples import (mezo_peft, nondiff_accuracy, quickstart,
                                  serve_batch, train_100m)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_quickstart(capsys):
    quickstart.main(["--steps", "3", "--batch", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("zero-shot accuracy: ", "MeZO step     0  loss ",
                 "MeZO accuracy after 3 steps: ",
                 "FT(Adam) accuracy after 20 steps: "):
        assert line in out, out


def test_nondiff_accuracy(capsys, monkeypatch):
    monkeypatch.setattr(nondiff_accuracy, "STEPS", 3)
    monkeypatch.setattr(nondiff_accuracy, "BATCH", 16)
    nondiff_accuracy.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0  batch-accuracy " in out and "final accuracy: " in out


def test_mezo_peft(capsys, monkeypatch):
    monkeypatch.setattr(mezo_peft, "STEPS", 2)
    monkeypatch.setattr(mezo_peft, "BATCH", 8)
    mezo_peft.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("full", "block_cyc4", "lora", "prefix"):
        assert re.search(rf"^{name} +tuned=", out, re.M), out
    assert "base tree bitwise-frozen by the selection" in out


def test_serve_batch(capsys, monkeypatch):
    monkeypatch.setattr(serve_batch, "N_TENANTS", 3)
    monkeypatch.setattr(serve_batch, "N_REQUESTS", 6)
    serve_batch.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "trained 3 LoRA tenants" in out
    assert re.search(r"served 6 requests / 3 tenants / \d+ tokens", out), out
    assert "ledger records replayed: " in out


def _run_jax_example(argv, capsys, monkeypatch) -> str:
    spec = importlib.util.spec_from_file_location(
        "jax_train_100m", ROOT / "examples" / "train_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train_100m.py", *argv])
    mod.main()
    return capsys.readouterr().out


def test_train_100m_smoke_as_jax(tmp_path, capsys, monkeypatch):
    argv = ["--smoke", "--steps", "3", "--select", "rows(block=16,k=4)"]
    train_100m.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                            "--device", "cpu"])
    got = capsys.readouterr().out
    want = _run_jax_example(argv + ["--ckpt-dir", str(tmp_path / "jax")],
                            capsys, monkeypatch)
    for pattern in (r"frozen-row probe: (\d+) unselected elements "
                    r"bitwise-frozen across (\d+) leaves",
                    r"ledger: (\d+) scalar entries = (\d+) bytes",
                    r"selection (\S+): ([\d.]+) MB perturbed",
                    r"model lm-smoke: ([\d.]+) M params",
                    r"ran (\d+) steps \(resumed from (\d+)\)"):
        g, w = re.search(pattern, got), re.search(pattern, want)
        assert g and w and g.groups() == w.groups(), (pattern, got, want)
