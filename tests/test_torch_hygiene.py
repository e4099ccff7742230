"""Port hygiene: ``src/repro_torch`` and ``chip_smoke.py`` import neither
JAX nor the JAX package; entry points run on the card unless the caller
asks for the CPU, and never fall back to it quietly; the serving launcher
works end to end on the CPU, replaying a JAX-written ledger."""
import ast
import pathlib

import pytest
torch = pytest.importorskip("torch")

from repro.core import TrajectoryLedger as JaxLedger
from repro_torch.launch import serve as serve_cli
from repro_torch.models import all_archs, bundle
from repro_torch.serve.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
PORT_TESTS = sorted((ROOT / "tests").glob("test_torch_*.py"))


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


def _imports_torch(node) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name.split(".")[0] in ("torch", "repro_torch")
                   for a in node.names)
    return (isinstance(node, ast.ImportFrom) and node.level == 0
            and node.module.split(".")[0] in ("torch", "repro_torch"))


def _is_torch_skip(node) -> bool:
    """``torch = pytest.importorskip("torch")``"""
    return (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Attribute)
            and node.value.func.attr == "importorskip"
            and [ast.literal_eval(a) for a in node.value.args] == ["torch"])


def test_port_tests_skip_without_torch():
    """Every port test module skips at collection where torch is missing
    (CI's JAX legs install no torch): ``pytest.importorskip("torch")``
    comes before any statement that imports torch or repro_torch."""
    assert len(PORT_TESTS) >= 29
    late = []
    for path in PORT_TESTS:
        for node in ast.parse(path.read_text()).body:
            if _is_torch_skip(node):
                break
            if _imports_torch(node):
                late.append(path.name)
                break
        else:
            late.append(path.name)
    assert not late, late


def _unused_imports(path: pathlib.Path) -> list:
    """Names an import binds in ``path`` that the file never reads — what
    ruff's F401 reports — except explicit re-exports (``import x as x``,
    ``from m import x as x``, a name in ``__all__``) and statements marked
    ``# noqa: F401``."""
    text = path.read_text()
    tree = ast.parse(text, filename=str(path))
    lines = text.splitlines()
    exported = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            exported.update(ast.literal_eval(node.value))
    bound = {}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if any("noqa: F401" in ln
               for ln in lines[node.lineno - 1:node.end_lineno]):
            continue
        for a in node.names:
            if a.name == "*" or a.asname == a.name:
                continue
            bound[a.asname or a.name.split(".")[0]] = node.lineno
    read = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    return [f"{path.relative_to(ROOT)}:{line} {name}"
            for name, line in sorted(bound.items(), key=lambda kv: kv[1])
            if name not in read and name not in exported]


def test_no_unused_imports_in_the_port():
    """CI lints ``src`` and ``tests`` with ruff's F401 (a fatal rule): no
    module of the port and no port test imports a name it never uses."""
    files = [p for p in PORT_FILES if p.name != "chip_smoke.py"] + PORT_TESTS
    bad = [hit for p in files for hit in _unused_imports(p)]
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


def test_no_refusal_names_the_selection_slice():
    """Selections are ported: no refusal in the port points at the
    selection slice any more."""
    hits = [str(p.relative_to(ROOT)) for p in PORT_FILES
            if "selection slice" in p.read_text()
            or "Slice C" in p.read_text()]
    assert not hits, hits


def test_no_text_says_the_port_is_dense_only():
    """Every family is ported: no docstring or refusal in the port says it
    carries the dense family only or defers a family to a later slice, and
    the registry's refusal of an unknown family names the five."""
    hits = [str(p.relative_to(ROOT)) for p in PORT_FILES
            if "dense family only" in p.read_text()
            or "other-families slice" in p.read_text()]
    assert not hits, hits
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(family="nope")
    with pytest.raises(ValueError, match="dense, moe, ssm, hybrid, encdec"):
        bundle(cfg)


@pytest.mark.parametrize("name", [
    "src/repro_torch/models/moe.py", "src/repro_torch/configs/mixtral_8x7b.py",
    "src/repro_torch/configs/granite_moe_3b_a800m.py",
    "tests/test_torch_moe.py", "tests/test_torch_threefry_original.py",
    "src/repro_torch/models/ssm.py", "src/repro_torch/models/encdec.py",
    "src/repro_torch/models/frontends.py",
    "src/repro_torch/configs/hymba_1_5b.py",
    "src/repro_torch/configs/whisper_large_v3.py",
    "tests/test_torch_hybrid.py", "tests/test_torch_hybrid_ledger.py",
    "tests/test_torch_serve_slab.py", "tests/test_torch_encdec.py",
    "tests/test_torch_zoo_conformance.py",
    "tests/test_torch_zoo_conformance_more.py",
    "src/repro_torch/serve/tenants/store.py",
    "src/repro_torch/serve/tenants/cache.py",
    "src/repro_torch/serve/tenants/compact.py",
    "src/repro_torch/serve/tenants/synth.py",
    "tests/test_torch_tenants.py", "tests/test_torch_tenants_parity.py",
    "tests/test_torch_tenants_decode.py",
    "src/repro_torch/core/mezo.py", "src/repro_torch/core/mezo_adam.py",
    "src/repro_torch/core/mezo_variants.py",
    "src/repro_torch/core/perturb.py",
    "tests/test_torch_core_shims.py", "tests/test_torch_core_functional.py",
    "src/repro_torch/distributed/__init__.py",
    "src/repro_torch/distributed/sharding.py",
    "src/repro_torch/distributed/collectives.py",
    "src/repro_torch/distributed/async_zo.py",
    "src/repro_torch/launch/mesh.py", "tests/test_torch_sharding.py",
    "tests/test_torch_shard_hints.py", "tests/test_torch_async_zo.py",
    "tests/test_torch_distributed.py",
    "src/repro_torch/analysis/__init__.py",
    "src/repro_torch/analysis/costs.py", "src/repro_torch/analysis/flops.py",
    "src/repro_torch/analysis/report.py",
    "src/repro_torch/analysis/roofline.py",
    "src/repro_torch/launch/dryrun.py",
    "src/repro_torch/examples/__init__.py",
    "src/repro_torch/examples/quickstart.py",
    "src/repro_torch/examples/mezo_peft.py",
    "src/repro_torch/examples/nondiff_accuracy.py",
    "src/repro_torch/examples/serve_batch.py",
    "src/repro_torch/examples/train_100m.py",
    "tests/test_torch_analysis.py", "tests/test_torch_dryrun.py",
    "tests/test_torch_examples.py"])
def test_new_modules_are_under_the_hygiene_checks(name):
    """The moe modules, the original-layout tests, the tenants modules and
    tests, the shims' modules and tests, the distribution modules and
    tests, and the analysis, dry-run and example modules and their tests
    are among the files the checks above walk, import no JAX (modules) and
    no unused name."""
    path = ROOT / name
    assert path in PORT_FILES + PORT_TESTS
    if name.startswith("src/"):
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not _unused_imports(path)


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
    # multi-tenant mode serves (no longer refused): 2 tenants, each cold
    # once (one record replayed each), every other request a cache hit
    serve_cli.main(["--smoke", "--device", "cpu", "--tenants", "2",
                    "--tenant-steps", "1", "--requests", "4",
                    "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "trained 2 LoRA tenants" in out
    assert "2 ledger records replayed" in out and "cache hit rate" in out


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


SEED_PARALLEL_NOTICE = ("[train] --seed-parallel is deprecated; use "
                        "--exec-plan seed_parallel --n-groups N")


def test_train_cli_takes_jax_deprecated_seed_parallel_alias(capsys):
    """``--seed-parallel N`` is JAX's deprecated alias for ``--exec-plan
    seed_parallel --n-groups N``: its notice, then the plan."""
    from repro_torch.launch import train as train_cli
    train_cli.main(["--smoke", "--device", "cpu", "--seed-parallel", "2",
                    "--batch", "4", "--seq", "8", "--steps", "2"])
    out = capsys.readouterr().out
    assert SEED_PARALLEL_NOTICE in out
    assert "exec plan: seed_parallel(n_groups=2)" in out
    assert out.index(SEED_PARALLEL_NOTICE) < out.index("exec plan:")
    assert "done: 2 steps (resumed from 0)" in out


def test_train_cli_seed_parallel_alias_refuses_as_jax(capsys):
    """With a non-ZO optimizer the alias prints its notice, then JAX's
    refusal of the plan (the alias is read where JAX reads it)."""
    from repro_torch.launch import train as train_cli
    with pytest.raises(SystemExit, match="seed-replayable"):
        train_cli.main(["--smoke", "--device", "cpu", "--optimizer", "adam",
                        "--seed-parallel", "2", "--steps", "1"])
    assert SEED_PARALLEL_NOTICE in capsys.readouterr().out


@pytest.mark.parametrize("argv,slice_name", [
    (["--backend", "pallas-interpret"], "JAX's CPU interpreter"),
    (["--optimizer", "mezo-adam", "--exec-plan", "seed_parallel",
      "--n-groups", "2"], "seed-replayable"),
    # the backprop baseline is ported: --optimizer adam trains
    (["--backend", "pallas", "--optimizer", "adam", "--steps", "1",
      "--batch", "2", "--seq", "8"], None),
    (["--backend", "pallas", "--optimizer", "mezo-adam", "--select",
      "rows(block=1,k=4)"], "requires --optimizer mezo"),
    (["--backend", "pallas", "--objective", "accuracy", "--optimizer",
      "adam"], "non-differentiable"),
    # encdec: the lm stream carries no frames (JAX's launcher: KeyError)
    (["--backend", "pallas", "--model-family", "encdec"], "frames"),
], ids=["xla", "mezo-adam", "adam", "select", "objective", "family"])
def test_train_cli_refuses_later_slices(argv, slice_name, capsys):
    from repro_torch.launch import train as train_cli
    if slice_name is None:
        train_cli.main(["--smoke", "--device", "cpu"] + argv)
        assert "done: 1 steps (resumed from 0)" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit, match=slice_name):
        train_cli.main(["--smoke", "--device", "cpu"] + argv)


@pytest.mark.parametrize("env", [None, "pallas", "xla"],
                         ids=["unset", "env-pallas", "env-xla"])
@pytest.mark.parametrize("spec", [None, "pallas", "xla", "nope"])
def test_backend_resolution_matches_jax(monkeypatch, env, spec):
    """``get_backend`` resolves as JAX's does — None → $REPRO_BACKEND, else
    "xla" — to a backend with JAX's stream id."""
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
    got = get_backend(spec)
    assert got.name == want and got.stream_id == jax_get_backend(
        spec).stream_id
    assert get_backend(spec) is got                    # one cached instance


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
    for spec, phase in (("block_cyclic(2)", 0), ("rows(block=1,k=4)", 3),
                        ("peft(lora)", 0), (r"leaves(\['attn'\])", 0)):
        for bs in (1, 4):
            led = TrajectoryLedger(base_seed=0, backend="pallas+z2",
                                   batch_seeds=bs, selection=spec,
                                   sel_phase=phase)
            led.append(0, [0.5] * bs if bs > 1 else 0.5, 1e-3)
            jled = JaxLedger.from_bytes(led.to_bytes())
            t, j = composition_for_ledger(led), jax_comp(jled)
            assert (t.selection_spec, t.selection_phase, t.batch_seeds,
                    t.estimator.name) == (j.selection_spec, j.selection_phase,
                                          j.batch_seeds, j.estimator.name)
            assert tuple(t.selection) == tuple(j.selection)
