"""Render the dry-run JSONL into the roofline tables — the port of
``repro.analysis.report``: the same schema, so either package's records
render alike (``python -m repro_torch.analysis.report [mesh]``)."""
from __future__ import annotations

import json
from collections import OrderedDict


def load_latest(path: str, mesh: str | None = None, tag: str | None = None) -> dict:
    latest: "OrderedDict[tuple, dict]" = OrderedDict()
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if mesh and r.get("mesh") != mesh:
                continue
            if (r.get("tag") or "") != (tag or ""):
                continue
            latest[(r["arch"], r["cell"], r["mesh"])] = r
    return latest


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(path: str = "results/dryrun.jsonl", mesh: str = "single",
                   tag: str | None = None) -> str:
    rows = []
    header = ("| arch | cell | compute | memory | collective | bottleneck "
              "| MODEL_FLOPs | useful | roofline |")
    sep = "|---|---|---|---|---|---|---|---|---|"
    for (arch, cell, _), r in load_latest(path, mesh, tag).items():
        if r["status"] != "ok":
            rows.append(f"| {arch} | {cell} | — | — | — | FAILED | — | — | — |")
            continue
        rows.append(
            f"| {arch} | {cell} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['bottleneck']} | {r['model_flops']:.2e} | "
            f"{r['useful_ratio']:.3f} | {r['roofline_fraction']:.3f} |")
    return "\n".join([header, sep] + rows)


def pick_hillclimb_cells(path: str = "results/dryrun.jsonl") -> dict:
    """worst roofline fraction / most collective-bound / paper-representative."""
    recs = [r for r in load_latest(path, "single").values()
            if r["status"] == "ok"]
    worst = min(recs, key=lambda r: r["roofline_fraction"] or 1.0)
    colls = [r for r in recs if r["collective_s"] > 0]
    most_coll = max(colls, key=lambda r: r["collective_s"] /
                    max(r["step_s"], 1e-12)) if colls else None
    return {"worst": (worst["arch"], worst["cell"]),
            "most_collective": (most_coll["arch"], most_coll["cell"])
            if most_coll else None}


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else "single"
    print(roofline_table(mesh=mesh))
    print()
    print(pick_hillclimb_cells())
