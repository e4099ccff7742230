"""The port's roofline machinery (``repro_torch.analysis``) against JAX's
``repro.analysis``: ``tests/test_analysis.py``'s five tests with the H100's
peaks (NVIDIA H100 SXM 80GB HBM3 at 700 W: 989e12 bf16 flop/s, 3.35e12
HBM bytes/s, 450e9 NVLink bytes/s), ``model_flops`` integer for integer
over every arch × cell × optimizer, and the report rendering the same
JSONL identically."""
import json

import pytest
torch = pytest.importorskip("torch")

from repro.analysis import flops as jflops
from repro.analysis import report as jreport
from repro.analysis.roofline import collective_stats as jcollective_stats
from repro.models import all_archs as jall_archs
from repro.models.config import ALL_CELLS as JALL_CELLS

from repro_torch.analysis import flops as flops_lib
from repro_torch.analysis import report
from repro_torch.analysis.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           Roofline, _shape_bytes,
                                           collective_stats)
from repro_torch.models import all_archs
from repro_torch.models.config import (ALL_CELLS, DECODE_32K,
                                       PREFILL_32K, TRAIN_4K)

#: the ops of ``tests/test_analysis.py``'s HLO text, as a trace's records
#: (kind, local result bytes)
RECORDS = [("all-reduce", 16 * 4096 * 512 * 4), ("all-gather", 128 * 256 * 2),
           ("reduce-scatter", 64 * 4), ("all-to-all", 8 * 8 * 4),
           ("collective-permute", 4 * 4), ("all-reduce", 32 * 4)]
HLO = """
  %all-reduce = f32[16,4096,512]{2,1,0} all-reduce(%add), channel_id=1, replica_groups=[2,4]<=[8]
  %ag = bf16[128,256]{1,0} all-gather(%p0), dimensions={0}
  %rs.1 = f32[64]{0} reduce-scatter(%x), dimensions={0}
  %a2a = f32[8,8]{1,0} all-to-all(%y), dimensions={0}
  %cp = u32[4]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %ar-start = f32[32]{0} all-reduce-start(%w), channel_id=2
  %ar-done = f32[32]{0} all-reduce-done(%ar-start)
  %not-a-collective = f32[9]{0} add(%a, %b)
"""


def test_shape_bytes():
    assert _shape_bytes((16, 4096, 512), torch.float32) == 16 * 4096 * 512 * 4
    assert _shape_bytes((128, 256), torch.bfloat16) == 128 * 256 * 2
    assert _shape_bytes((), torch.int32) == 4


def test_collective_stats_parsing():
    st = collective_stats(RECORDS)
    assert st["all-reduce"]["count"] == 2
    assert st["all-reduce"]["bytes"] == 2 * (16 * 4096 * 512 * 4) + 2 * 32 * 4
    assert st["all-gather"]["count"] == 1
    assert st["all-gather"]["bytes"] == 128 * 256 * 2
    assert st["reduce-scatter"]["count"] == 1
    assert st["all-to-all"]["count"] == 1
    assert st["collective-permute"]["count"] == 1
    assert st["total_count"] == 6
    # the same ops read from JAX's HLO text give JAX's dict, key for key
    assert st == jcollective_stats(HLO)


def test_roofline_terms_and_bottleneck():
    r = Roofline(arch="x", cell="train_4k", mesh="single", chips=256,
                 flops_per_chip=PEAK_FLOPS,          # exactly 1s of compute
                 hbm_bytes_per_chip=HBM_BW * 2,      # 2s of memory
                 link_bytes_per_chip=LINK_BW * 0.5,  # 0.5s of collectives
                 model_flops=int(PEAK_FLOPS * 256),
                 model_flops_6nd=0).finalize()
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.step_s == pytest.approx(2.0)
    assert r.roofline_fraction == pytest.approx(0.5)
    assert r.useful_ratio == pytest.approx(1.0)


@pytest.mark.parametrize("arch_id", ["qwen2-7b", "mixtral-8x7b", "rwkv6-3b",
                                     "whisper-large-v3", "hymba-1.5b"])
def test_model_flops_scaling(arch_id):
    """Train cell counts ~2 forwards; MoE uses active params; decode is
    per-token."""
    cfg = all_archs()[arch_id].cfg
    tr = flops_lib.model_flops(cfg, TRAIN_4K, "mezo")
    pf = flops_lib.model_flops(cfg, PREFILL_32K, "mezo")
    de = flops_lib.model_flops(cfg, DECODE_32K, "mezo")
    assert tr["model_flops"] > 0 and de["model_flops"] > 0
    tr1 = flops_lib.model_flops(cfg, TRAIN_4K, "ft")
    assert tr1["model_flops"] > tr["model_flops"]
    assert de["model_flops"] < pf["model_flops"] / 100
    if cfg.n_experts:
        assert tr["backbone_params_active"] < cfg.n_params()


def test_moe_active_params():
    cfg = all_archs()["mixtral-8x7b"].cfg
    assert cfg.n_active_params() < 0.35 * cfg.n_params()


@pytest.mark.parametrize("arch_id", sorted(jall_archs()))
def test_model_flops_equal_jax(arch_id):
    """Every key of ``model_flops`` (and ``attention_flops`` /
    ``backbone_params``) equal to JAX's, integer for integer, for every
    cell and both optimizers."""
    jcfg, cfg = jall_archs()[arch_id].cfg, all_archs()[arch_id].cfg
    for jcell, cell in zip(JALL_CELLS, ALL_CELLS):
        assert jcell.name == cell.name
        for opt in ("mezo", "ft"):
            want = jflops.model_flops(jcfg, jcell, opt)
            got = flops_lib.model_flops(cfg, cell, opt)
            assert got == want and all(type(v) is int for v in got.values())
        B, S = cell.global_batch, cell.seq_len
        assert flops_lib.attention_flops(cfg, B, 1, S) == \
            jflops.attention_flops(jcfg, B, 1, S)
    for active in (False, True):
        assert flops_lib.backbone_params(cfg, active) == \
            jflops.backbone_params(jcfg, active)


def _records() -> list:
    """Dry-run records in the JSONL schema both packages write: two meshes,
    a later record replacing an earlier one, a tagged one, a failure."""
    def ok(arch, cell, mesh, comp, mem, coll, tag=None):
        r = Roofline(arch=arch, cell=cell, mesh=mesh, chips=256,
                     flops_per_chip=comp * PEAK_FLOPS,
                     hbm_bytes_per_chip=mem * HBM_BW,
                     link_bytes_per_chip=coll * LINK_BW,
                     model_flops=int(0.3 * comp * PEAK_FLOPS * 256),
                     model_flops_6nd=0).finalize()
        rec = dict(r.__dict__, status="ok")
        if tag:
            rec["tag"] = tag
        return rec
    return [ok("qwen2-0.5b", "train_4k", "single", 2.0, 1.0, 0.0),
            ok("qwen2-0.5b", "train_4k", "single", 3e-4, 1e-2, 5e-3),
            ok("yi-6b", "prefill_32k", "single", 5e-7, 2e-6, 4e-6),
            ok("yi-6b", "decode_32k", "multi", 1.0, 1.0, 1.0),
            ok("qwen2-7b", "train_4k", "single", 0.0, 0.0, 0.0, tag="x"),
            {"arch": "mixtral-8x7b", "cell": "train_4k", "mesh": "single",
             "status": "error", "error": "RuntimeError: aten.sort"}]


def test_report_renders_the_jsonl_as_jax(tmp_path):
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    for mesh in ("single", "multi", None):
        for tag in (None, "x"):
            assert report.roofline_table(str(path), mesh or "single", tag) \
                == jreport.roofline_table(str(path), mesh or "single", tag)
            assert list(report.load_latest(str(path), mesh, tag).items()) \
                == list(jreport.load_latest(str(path), mesh, tag).items())
    assert report.pick_hillclimb_cells(str(path)) == \
        jreport.pick_hillclimb_cells(str(path))
    for x in (0, 3e-7, 2.5e-3, 0.75, 12.0):
        assert report.fmt_s(x) == jreport.fmt_s(x)


def test_costs_equal_the_kernel_lines_reckonings():
    """``analysis.costs`` gives the work ``chip_smoke.py``'s ``kernels`` line
    reckoned inline before it read the module — bytes, operations, and so
    every ``bound_ms`` and ``bound_by`` — at the line's shapes: K1 / X1 one
    pass over qwen2-0.5b's 15 leaves, K3–K5 eight streams, K2 (16, 256,
    14, 64) over 2 KV heads and (16, 256, 40, 128), hymba's window 2048,
    K11 (16, 256, 40, 64), K12 a decode step's blocks."""
    from repro_torch.analysis import costs
    from repro_torch.models import bundle
    from repro_torch.tree_utils import is_floating, tree_leaves
    leaves = [p for p in tree_leaves(bundle(
        all_archs()["qwen2-0.5b"].cfg).param_shapes()) if is_floating(p)]
    n_all = sum(p.numel() for p in leaves)
    nbytes = sum(p.numel() * p.element_size() for p in leaves)
    sizes = [(p.numel(), p.element_size()) for p in leaves]
    B = 8
    total = costs.total
    assert total(costs.zo_affine(n, e) for n, e in sizes) == \
        costs.Cost(2 * nbytes, 64 * n_all)
    assert total(costs.zo_affine_chain(n, e, B) for n, e in sizes) == \
        costs.Cost(2 * nbytes, 64 * B * n_all)
    assert total(costs.zo_affine_fanout(n, e, B) for n, e in sizes) == \
        costs.Cost((1 + B) * nbytes, 64 * B * n_all)
    assert total(costs.zo_sqnorm(n) for n, _ in sizes) == \
        costs.Cost(0, 63 * n_all)
    assert total(costs.zo_affine_threefry(n, e) for n, e in sizes) == \
        costs.Cost(2 * nbytes, 4 * n_all)
    assert costs.flash_attention(16, 256, 14, 2, 64, 2) == costs.Cost(
        2 * (16 * 256 * 14 * 64 * 2 + 16 * 256 * 2 * 64 * 2),
        4 * 64 * costs.attended_pairs(256) * 16 * 14, "tensor")
    assert costs.flash_attention(16, 256, 40, 40, 128, 2).bytes == \
        2 * 4 * 16 * 256 * 40 * 128
    assert costs.flash_attention(1, 4096, 25, 5, 64, 2, window=2048).ops == \
        4 * 64 * costs.attended_pairs(4096, window=2048) * 25
    n = 16 * 256 * 40 * 64
    assert costs.wkv6_chunked(16, 256, 40, 64, 16) == costs.Cost(
        4 * (5 * n + 2 * 16 * 40 * 64 * 64 + 40 * 64),
        costs.wkv6_flops(16, 256, 40, 64, 16))
    assert costs.paged_gather(24, 97, 16, 128, 2) == \
        costs.Cost(2 * 24 * 97 * 16 * 128 * 2, 0)
    # the bound: the bytes at 3.35 TB/s against the operations at their rate
    assert costs.bound_ms(total(costs.zo_affine(n, e) for n, e in sizes)) \
        == (2 * nbytes / 3.35e12 * 1e3, "bytes")
    assert costs.bound_ms([costs.zo_affine(n, e) for n, e in sizes]) == \
        costs.bound_ms(total(costs.zo_affine(n, e) for n, e in sizes))
    assert costs.bound_ms(costs.Cost(0, 67e9)) == (1.0, "operations")
    assert costs.bound_ms(costs.Cost(0, 989e9, "tensor")) == \
        (1.0, "operations")
    assert all(costs.attended_pairs(S, c, w) == sum(
        max(0, (qi if c else S - 1) - (max(0, qi - w + 1) if w else 0) + 1)
        for qi in range(S)) for S in (1, 7, 64) for c in (True, False)
        for w in (0, 1, 5, 64))
