"""Roofline terms from a traced dry run (no card needed) — the port of
``repro.analysis.roofline``.

    compute term    = FLOPs_per_rank / PEAK_FLOPS
    memory term     = HBM_bytes_per_rank / HBM_BW
    collective term = per-rank link bytes / LINK_BW

The dry run (``repro_torch.launch.dryrun``) traces one rank's program over
DTensors on a fake process group, so every count is per rank directly.
Collective bytes come from the trace's collective records: per-rank link
traffic ≈ factor · bytes with the standard ring factors (all-reduce 2×,
all-gather / reduce-scatter / all-to-all / permute 1×), as JAX reads them
from its compiled HLO.

Hardware model: NVIDIA H100 SXM 80GB HBM3 at its 700 W limit (NVIDIA's
data sheet, dense) — 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
on the CUDA cores, 3.35 TB/s HBM, 450 GB/s each way over NVLink 4.  A card
held below 700 W runs slower under load.  The link term is one card's
NVLink: a mesh that spans hosts is bounded by the hosts' network, which a
single link term does not see (as JAX's ICI term does not see DCN).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

import torch

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
F32_FLOPS = 67e12            # f32 on the CUDA cores (the z kernels' ALU)
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, NVLink 4, each way

CARD = "NVIDIA H100 SXM 80GB HBM3 at 700 W"

_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}


def _shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of one tensor of ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype, device="meta").element_size()


def collective_stats(records: Iterable) -> dict:
    """Per-rank link-byte estimate + op counts from a trace's collective
    records, each ``(kind, bytes)`` with ``kind`` one of JAX's HLO names
    (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``) and ``bytes`` the local result's.  JAX's dict:
    per kind its count and its factored bytes, ``total_bytes`` and
    ``total_count``."""
    stats: dict = {k: {"count": 0, "bytes": 0} for k in _FACTOR}
    for kind, nbytes in records:
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += int(nbytes * _FACTOR[kind])
    stats["total_bytes"] = sum(v["bytes"] for k, v in stats.items()
                               if isinstance(v, dict))
    stats["total_count"] = sum(v["count"] for k, v in stats.items()
                               if isinstance(v, dict))
    return stats


@dataclasses.dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    link_bytes_per_chip: float
    model_flops: int
    model_flops_6nd: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    step_s: float = 0.0
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0
    collectives: Optional[dict] = None
    memory_analysis: Optional[dict] = None

    def finalize(self) -> "Roofline":
        self.compute_s = self.flops_per_chip / PEAK_FLOPS
        self.memory_s = self.hbm_bytes_per_chip / HBM_BW
        self.collective_s = self.link_bytes_per_chip / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        # overlap model: perfectly-overlapped roofline step = max of terms
        self.step_s = max(terms.values())
        total_flops = self.flops_per_chip * self.chips
        self.useful_ratio = (self.model_flops / total_flops
                             if total_flops else 0.0)
        ideal_s = self.model_flops / (self.chips * PEAK_FLOPS)
        self.roofline_fraction = ideal_s / self.step_s if self.step_s else 0.0
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def from_trace(arch: str, cell: str, mesh_name: str, chips: int, trace,
               model_fl: dict) -> Roofline:
    """A ``Roofline`` from a dry run's per-rank trace (``launch.dryrun.
    Trace``: ``flops``, ``hbm_bytes``, ``collectives`` — the records
    ``collective_stats`` reads — and ``memory``)."""
    coll = collective_stats(trace.collectives)
    return Roofline(arch=arch, cell=cell, mesh=mesh_name, chips=chips,
                    flops_per_chip=float(trace.flops),
                    hbm_bytes_per_chip=float(trace.hbm_bytes),
                    link_bytes_per_chip=float(coll["total_bytes"]),
                    model_flops=model_fl["model_flops"],
                    model_flops_6nd=model_fl["model_flops_6nd"],
                    collectives=coll,
                    memory_analysis=dict(trace.memory)).finalize()
