"""The port's dry run (``repro_torch.launch.dryrun``): a step traced on
``meta`` tensors — plain for one rank, DTensors on a fake process group for
a mesh — against the analytic useful FLOPs, against a real step on the
CPU, and against JAX's own shard shapes:

1. qwen2-0.5b at full width and depth on one rank, a 16 × 256 train cell:
   ``useful_ratio`` in [0.98, 1.02].  The trace counts the matmuls of the
   two forwards, which ``model_flops`` counts too; what remains is the
   attention — ``model_flops`` takes every (q, k) pair, K2 charges the
   causal half (``pallas_flash``), the plain path's masked matmuls all of
   them — and the bias and norm leaves ``n_params`` counts as matmul
   parameters;
2. one traced step's charges per kernel (calls, bytes, operations) equal
   those of the same step run on the CPU under a cost counter, for the
   counter-hash (K1, K2) and threefry (X1) streams, spsa and fzoo(4);
   A wrapper's shape rule moves no bytes beyond its kernel's charge;
3. per-rank counts at 1, 2 and 3 layers lie on a line, exactly: an eager
   trace counts every layer (JAX's 1/2-layer calibration is not needed);
4. on a fake (2, 2) mesh the per-rank argument bytes of θ and the batch
   equal the sums of JAX's ``NamedSharding(...).shard_shape`` over the
   same specs on an ``AbstractMesh``, and the collectives are recorded;
5. qwen2-0.5b ``train_4k`` on the single-pod (16, 16) mesh traces to
   ``status: "ok"`` within 60 s, touching no card and leaving no process
   group behind.
"""
import math
import time

import numpy as np

import pytest
torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from repro.distributed import sharding as jsh
from repro_torch import exec as zexec
from repro_torch import zo
from repro_torch.analysis import costs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import TRAIN_4K, ShapeCell, all_archs, bundle
from repro_torch.perturb.stream import prng_key
from repro_torch.tree_utils import tree_leaves

SMOKE_TRAIN = ShapeCell("smoke_train", 256, 16, "train")


def _opt(estimator: str, backend: str):
    if estimator == "fzoo":
        return zo.fzoo(lr=1e-6, eps=1e-3, batch_seeds=4, backend=backend)
    return zo.mezo(lr=1e-6, eps=1e-3, backend=backend)


@pytest.mark.parametrize("backend,impl", [("pallas", "pallas_flash"),
                                          ("xla", None)])
def test_useful_ratio_at_full_size(backend, impl):
    cfg = all_archs()["qwen2-0.5b"].cfg
    over = {"attention_impl": impl} if impl else {}
    rec = dryrun.run_case("qwen2-0.5b", SMOKE_TRAIN, None, "single-1x1",
                          over, backend=backend, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert 0.98 <= rec["useful_ratio"] <= 1.02
    assert rec["collectives"]["total_count"] == 0 and rec["chips"] == 1
    n_leaves = len(tree_leaves(bundle(cfg).param_shapes()))
    kernel = "zo_affine" if backend == "pallas" else "zo_affine_threefry"
    # perturb +, perturb −, the fused restore-update: one call per leaf each
    assert rec["kernels"][kernel]["calls"] == 3 * n_leaves
    if impl:
        assert rec["kernels"]["flash_attention"]["calls"] == 2 * cfg.n_layers


@pytest.mark.parametrize("estimator", ["spsa", "fzoo"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_traced_charges_equal_a_cpu_step(backend, estimator):
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    if backend == "pallas":
        cfg = cfg.replace(attention_impl="pallas_flash")
    b = bundle(cfg)
    B, S = 2, 16
    params = b.init(0, device="cpu")
    batch = b.make_batch(prng_key(1), B, S, device="cpu")
    prog = zexec.StepProgram(_opt(estimator, backend), zexec.local())
    step = prog.step_fn(b.loss_fn())
    with costs.counting() as real:
        step(params, prog.init(seed=0), batch)
    trace = dryrun.trace_case(cfg, b, ShapeCell("t", S, B, "train"), None,
                              backend=backend, estimator=estimator,
                              batch_seeds=4)
    assert trace.kernels == real.as_dict()
    want = {"zo_affine", "flash_attention"} if backend == "pallas" else \
        {"zo_affine_threefry"}
    if estimator == "fzoo":
        want = ({"zo_affine_batched", "zo_affine_chain", "flash_attention"}
                if backend == "pallas" else {"zo_affine_threefry"})
    assert set(trace.kernels) == want


@pytest.mark.parametrize("placed", [False, True])
def test_shape_rules_move_no_bytes_of_their_own(placed):
    """A wrapper's shape rule allocates its result and charges its kernel,
    so a trace's bytes over the calls are the kernels' charges alone; the
    B-stream results (K5, K4, K8) are ``(B, *x.shape)``, placed as
    ``torch.stack`` places them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.zo_fused import kernel as kz
    from repro_torch.kernels.zo_fused import multi, rows
    seeds, a, b = [1, 2, 3], [1.0, 1.0, 1.0], [0.5, -0.5, 0.25]
    calls = {
        "zo_affine": lambda x: kz.zo_affine(x, 1, 1.0, 0.5),
        "zo_affine_batched": lambda x: kz.zo_affine_batched(x, seeds, 1.0,
                                                            0.5),
        "zo_affine_multi": lambda x: multi.zo_affine_multi(x, seeds, a, b),
        "zo_affine_chain": lambda x: multi.zo_affine_chain(x, seeds, a, b),
        "zo_affine_multi_rows": lambda x: rows.zo_affine_multi_rows(
            x, seeds, a, b, 8, 2, 1),
    }

    def run():
        shard = torch.empty((64, 48), dtype=torch.bfloat16, device="meta")
        x = shard
        if placed:
            mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
            x = DTensor.from_local(shard, mesh, [Shard(0), Replicate()],
                                   run_check=False)
        with dryrun.tracing(placed) as trace:
            outs = {name: f(x) for name, f in calls.items()}
        assert set(trace.kernels) == set(calls)
        assert trace.hbm_bytes == sum(
            k["bytes"] for k in trace.kernels.values())
        for name in ("zo_affine_batched", "zo_affine_multi",
                     "zo_affine_multi_rows"):
            y, want = outs[name], torch.stack([x] * len(seeds))
            assert (y.shape, y.dtype, y.device) == (want.shape, want.dtype,
                                                    want.device)
            if placed:
                assert y.placements == want.placements
                assert y.to_local().shape == want.to_local().shape

    if placed:
        with dryrun.fake_group(4):
            run()
    else:
        run()


@pytest.mark.parametrize("shift", [0, 1, 5, 11])
def test_ring_prefill_roll_by_slices_is_torch_roll(shift):
    """A prefill's ring write rolls by two slices (DTensor shards those
    where a torch has no rule for ``aten.roll``): torch.roll's bits."""
    from repro_torch.models.attention import _roll
    x = torch.from_numpy(np.random.default_rng(shift).standard_normal(
        (2, 12, 3, 4)).astype(np.float32))
    assert torch.equal(_roll(x, shift, 1), torch.roll(x, shift, dims=1))
    pos = torch.arange(12, dtype=torch.int32)
    assert torch.equal(_roll(pos, shift, 0), torch.roll(pos, shift))


def test_counts_lie_on_a_line_in_the_layers():
    recs = [dryrun.run_case("qwen2-0.5b", SMOKE_TRAIN, None, "single-1x1",
                            {"n_layers": L}, verbose=False)
            for L in (1, 2, 3)]
    assert all(r["status"] == "ok" for r in recs)

    def keys(r):
        k = r["kernels"]["zo_affine_threefry"]
        return (r["flops_per_chip"], r["hbm_bytes_per_chip"], k["calls"],
                k["bytes"], k["ops"], r["local_ops"],
                r["memory_analysis"]["argument_size_in_bytes"])

    k1, k2, k3 = (keys(r) for r in recs)
    per_layer = [b - a for a, b in zip(k1, k2)]
    assert [c - b for b, c in zip(k2, k3)] == per_layer
    # the leaves are stacked over the layers: X1's calls stay, its bytes
    # and operations grow with every layer, as the FLOPs and bytes do
    assert per_layer[2] == 0
    assert all(p > 0 for i, p in enumerate(per_layer) if i != 2)


def _jax_local_bytes(jcfg_tree, spec_tree, amesh) -> int:
    import jax
    total = 0
    for sds, spec in zip(jax.tree_util.tree_leaves(jcfg_tree),
                         jax.tree_util.tree_leaves(
                             spec_tree, is_leaf=lambda x: isinstance(
                                 x, JaxP))):
        shape = JaxNamedSharding(amesh, spec).shard_shape(sds.shape)
        total += math.prod(shape) * sds.dtype.itemsize
    return total


def test_argument_bytes_on_a_2x2_mesh_equal_jax_shard_shapes():
    import jax
    from repro.models import all_archs as jall_archs
    from repro.models import bundle as jbundle
    from repro.models.config import TRAIN_4K as JTRAIN_4K
    arch = "qwen2-0.5b"
    amesh = AbstractMesh((2, 2), ("data", "model"))
    jb = jbundle(jall_archs()[arch].cfg)
    jparams = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    jspecs = jsh.param_specs(jparams, amesh)
    jbatch = jb.input_specs(JTRAIN_4K)
    jbspecs = {k: jsh.infer_batch_spec(k, v.shape, amesh)
               for k, v in jbatch.items()}
    want_params = _jax_local_bytes(jparams, jspecs, amesh)
    want_batch = _jax_local_bytes(jbatch, jbspecs, amesh)
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        rec = dryrun.run_case(arch, TRAIN_4K, mesh, "single-2x2", {},
                              verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    args = rec["memory_analysis"]["argument_bytes"]
    assert (args["params"], args["batch"]) == (want_params, want_batch)
    coll = rec["collectives"]
    assert coll["total_count"] > 0 and coll["total_bytes"] > 0
    # DTensor's own CommDebugMode saw the collectives the trace recorded
    names = {"all-reduce": "all_reduce", "all-gather": "all_gather_into_tensor",
             "reduce-scatter": "reduce_scatter_tensor"}
    for kind, op in names.items():
        assert coll[kind]["count"] == rec["comm_counts"].get(
            f"c10d_functional.{op}", 0)


def test_train_4k_on_the_single_pod_mesh():
    import torch.distributed as dist
    t0 = time.time()
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        rec = dryrun.run_case("qwen2-0.5b", TRAIN_4K, mesh, "single", {},
                              verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert time.time() - t0 < 60
    assert rec["chips"] == 256 and rec["collectives"]["total_count"] > 0
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()
