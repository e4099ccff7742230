"""The port's packages export JAX's public names.  For every package of
``repro`` whose ``__init__`` gives an ``__all__`` or imports names
explicitly, ``repro_torch``'s package of the same name must import each of
them, save a listed set that ROADMAP Queue 1 still owes (each entry names
its item).  JAX's names are read from its source with ``ast``, so no JAX
module is imported."""
import ast
import importlib
import pathlib

import pytest
torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

#: JAX names the port does not export yet, with the Queue 1 item that owes
#: them (ROADMAP.md): none since item 12 (distribution) was ported
OWED: dict = {}


def _jax_packages() -> list:
    return sorted(str(p.parent.relative_to(SRC / "repro")).replace("/", ".")
                  for p in (SRC / "repro").rglob("__init__.py")
                  if p.parent != SRC / "repro")


def jax_public_names(package: str) -> set:
    """``repro.<package>``'s public names from its source: ``__all__``
    (evaluated from the module's top-level assignments alone, which is how
    ``repro.core`` builds it), else the names it imports explicitly."""
    path = SRC / "repro" / package.replace(".", "/") / "__init__.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    assigns = [n for n in tree.body if isinstance(n, ast.Assign)]
    if any(isinstance(t, ast.Name) and t.id == "__all__"
           for n in assigns for t in n.targets):
        ns: dict = {}
        exec(compile(ast.Module(body=assigns, type_ignores=[]), str(path),
                     "exec"), {"__builtins__": {"sorted": sorted}}, ns)
        return set(ns["__all__"])
    return {a.asname or a.name for n in tree.body
            if isinstance(n, ast.ImportFrom) and n.module != "__future__"
            for a in n.names}


def test_the_owed_names_are_jax_names_of_real_packages():
    """Every listed entry is a name JAX exports, so the list shrinks as
    items land and cannot hide a typo."""
    pkgs = _jax_packages()
    for package, (names, item) in OWED.items():
        assert package in pkgs, package
        assert item in (9, 10, 11, 12), (package, item)
        assert names <= jax_public_names(package), (
            package, names - jax_public_names(package))


@pytest.mark.parametrize("package", _jax_packages())
def test_port_exports_jax_public_names(package):
    want = jax_public_names(package)
    owed, _ = OWED.get(package, (set(), None))
    if want <= owed:
        return
    mod = importlib.import_module(f"repro_torch.{package}")
    missing = sorted(n for n in want - owed if not hasattr(mod, n))
    assert not missing, f"repro_torch.{package} lacks {missing}"
    exported = getattr(mod, "__all__", None)
    if exported is not None:
        assert not (want - owed) - set(exported), sorted(
            (want - owed) - set(exported))
    # an owed name the port now has is taken off the list
    assert not sorted(n for n in owed if hasattr(mod, n)), (
        f"repro_torch.{package} now has "
        f"{sorted(n for n in owed if hasattr(mod, n))}: drop them from OWED")


def test_queue3_names_import():
    from repro_torch.kernels.paged import paged_gather, paged_gather_ref
    from repro_torch.kernels.paged.gather import paged_gather_plain
    from repro_torch.models import (ALL_CELLS, DECODE_32K, LONG_500K,
                                    PREFILL_32K, TRAIN_4K, ShapeCell,
                                    cells_for, default_selection)
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.engine import ServeEngine as Engine
    from repro_torch.zo import ZOLossFn, apply_rank1, apply_rank1_batch
    from repro_torch.zo.updates import apply_rank1 as rank1
    assert ServeEngine is Engine and apply_rank1 is rank1
    assert paged_gather_ref is paged_gather_plain and callable(paged_gather)
    assert ALL_CELLS == (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
    assert all(isinstance(c, ShapeCell) for c in ALL_CELLS)
    assert callable(cells_for) and callable(default_selection)
    assert callable(apply_rank1_batch) and ZOLossFn is not None
    assert Request is not None


#: JAX module → (the port's module, {JAX name: the port's name, or None
#: where the port has none}) — the deliberate differences, each with its
#: reason
MODULES = {
    "analysis.flops": ("analysis.flops", {}),
    "analysis.report": ("analysis.report", {}),
    # the roofline's link term is NVLink's, not a TPU's ICI; the dry run's
    # counts come from a trace, not from a compiled executable
    "analysis.roofline": ("analysis.roofline", {"ICI_BW": "LINK_BW",
                                                "from_compiled": "from_trace"}),
    # an eager trace runs every layer: no loop-trip calibration compiles
    "launch.dryrun": ("launch.dryrun", {"calibrate_loop_costs": None}),
}


def jax_module_names(module: str) -> set:
    """A JAX module's public top-level names (functions, classes and
    assigned names not starting with ``_``), read from its source."""
    path = SRC / "repro" / (module.replace(".", "/") + ".py")
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", sorted(MODULES))
def test_port_modules_pair_jax_module_names(module):
    """``repro_torch.<module>`` has every public name of JAX's module of the
    same path, save the listed renames and drops."""
    port_module, renamed = MODULES[module]
    names = jax_module_names(module)
    assert set(renamed) <= names, set(renamed) - names
    mod = importlib.import_module(f"repro_torch.{port_module}")
    missing = sorted(renamed.get(n, n) for n in names
                     if renamed.get(n, n) is not None
                     and not hasattr(mod, renamed.get(n, n)))
    assert not missing, f"repro_torch.{port_module} lacks {missing}"
    assert not [n for n, to in renamed.items()
                if to is None and hasattr(mod, n)]
