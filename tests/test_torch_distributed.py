"""Two ranks on the CPU — the counterpart of ``tests/test_distributed.py``:
two ``gloo`` processes (a ``FileStore`` under ``tmp_path``, a timeout of
their own) run the port's distribution layer on the qwen2-0.5b smoke config
in f32:

* the data-parallel step (the batch split over 'data' on a (2, 1) mesh,
  its rows' ``loss_mask`` sums unequal) against the single-process step on
  the full batch, within JAX's bounds (loss 1e-4, g 5e-3, θ 1e-5), each
  rank evaluating its half of the rows, the two ranks' θ bitwise equal;
* every collective of that step is an ``all_reduce`` of at most two f32
  elements, one per loss evaluation (JAX's scalar-sync property);
* the data-parallel loss of the accuracy and F1 objectives (a masked token
  mean and a uniform row mean) and of the moe family's accuracy within
  1e-6 of the single-process loss; the moe family's cross entropy, whose
  load-balancing term no sum of per-rank scalars gives, refused;
* ``psum_scalar`` over 'data';
* the seed-parallel step run the same way (``collectives.
  seed_parallel_step_fn`` with the mesh);
* ``param_shardings`` with real ``Shard`` placements on ``make_elastic_mesh``'s
  (1, 2) mesh: ``distribute_tensor`` then ``full_tensor()`` bitwise, each
  rank holding half of every sharded leaf;
* the elastic path: the placed tree saved on rank 0 loads in this process
  onto plain tensors bitwise.

Four ranks hold ``axes_group``'s subgroups over several axes: ``psum_scalar``
over ('pod', 'data') and over 'model' on (pod, data, model) meshes of
(2, 1, 2) and (2, 2, 1), and the data-parallel loss over ('pod', 'data').

JAX's tensor-parallel forward check has no counterpart: the port's forwards
run on local tensors (ROADMAP Queue 1, tensor-parallel execution).
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent(r"""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 2),
                            rank=rank, world_size=2)
    from repro_torch import exec as zexec
    from repro_torch import zo
    from repro_torch.checkpoint.io import save_tree
    from repro_torch.core import MeZOConfig
    from repro_torch.distributed import param_shardings
    from repro_torch.distributed.collectives import (seed_parallel_init,
                                                     seed_parallel_step_fn)
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import all_archs, bundle
    from repro_torch.perturb.stream import prng_key
    from repro_torch.tree_utils import tree_clone, tree_max_abs_diff

    from repro_torch.distributed.collectives import (data_parallel_loss,
                                                     psum_scalar)

    def masked_batch(b):
        # the rows keep 16, 5, 11 and 2 tokens: rank 0's share 21, rank 1's 13
        batch = b.make_batch(prng_key(1), 4, 16, device="cpu")
        keep = torch.tensor([16, 5, 11, 2])[:, None]
        batch["loss_mask"] = (torch.arange(16)[None] < keep).float()
        return batch

    cfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype="float32")
    b = bundle(cfg)
    params = b.init(0, device="cpu")
    batch = masked_batch(b)
    loss_fn = b.loss_fn()
    out = {}

    # the single-process step on the full batch (no mesh)
    opt = zo.mezo(lr=1e-4, eps=1e-3)
    p_ref, _, m_ref = zexec.StepProgram(opt).step_fn(loss_fn)(
        tree_clone(params), opt.init(params, seed=0), batch)

    # data parallel: θ replicated, the batch split over 'data'
    dp = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    calls = []
    real = dist.all_reduce

    def recording(t, *a, **k):
        calls.append((t.numel(), str(t.dtype)))
        return real(t, *a, **k)

    rows = []

    def counted(p, bt):
        return loss_fn(p, bt)

    def counted_parts(p, bt):
        rows.append(int(bt["tokens"].shape[0]))
        return loss_fn.parts(p, bt)

    counted.parts = counted_parts

    dist.all_reduce = recording
    try:
        step = zexec.StepProgram(opt, zexec.local(mesh=dp)).step_fn(counted)
        p_dp, _, m_dp = step(tree_clone(params), opt.init(params, seed=0),
                             batch)
    finally:
        dist.all_reduce = real
    out["dp"] = [abs(float(m_ref["loss"]) - float(m_dp["loss"])),
                 abs(float(m_ref["projected_grad"])
                     - float(m_dp["projected_grad"])),
                 tree_max_abs_diff(p_ref, p_dp)]
    out["calls"] = calls
    out["rows"] = rows

    # the other objectives, the moe family, and psum_scalar: the labels
    # take the model's own predictions at 6, 1, 4 and 0 leading positions,
    # so accuracy and F1 differ from row to row
    def hits(b, params, batch):
        pred = b.train_logits_fn()(params, batch)[..., :b.cfg.vocab_size]
        first = torch.arange(16)[None] < torch.tensor([6, 1, 4, 0])[:, None]
        batch["labels"] = torch.where(first, pred.argmax(-1).to(
            batch["labels"].dtype), batch["labels"])
        return batch

    bt_h = hits(b, params, masked_batch(b))
    out["objectives"] = [abs(float(data_parallel_loss(f, dp)(params, bt_h))
                             - float(f(params, bt_h)))
                         for f in (b.loss_fn("accuracy"), b.loss_fn("f1"))]
    out["f1"] = float(b.loss_fn("f1")(params, bt_h))
    bm = bundle(all_archs()["granite-moe-3b-a800m"].smoke_cfg)
    pm = bm.init(0, device="cpu")
    bt_m = hits(bm, pm, masked_batch(bm))
    acc = bm.loss_fn("accuracy")
    out["moe_accuracy"] = abs(float(data_parallel_loss(acc, dp)(pm, bt_m))
                              - float(acc(pm, bt_m)))
    try:
        data_parallel_loss(bm.loss_fn(), dp)
        out["moe_ce"] = "accepted"
    except ValueError as e:
        out["moe_ce"] = str(e)
    out["psum"] = float(psum_scalar(rank + 1.0, "data", dp))
    torch.save(p_dp, f"{tmp}/dp{rank}.pt")

    # seed-parallel, with and without the mesh
    conf = MeZOConfig(lr=1e-4, eps=1e-3)
    p1_ref, _, _ = seed_parallel_step_fn(loss_fn, conf, 2)(
        tree_clone(params), seed_parallel_init(0), batch)
    p1_dp, st, _ = seed_parallel_step_fn(loss_fn, conf, 2, mesh=dp)(
        tree_clone(params), seed_parallel_init(0), batch)
    out["sp"] = tree_max_abs_diff(p1_ref, p1_dp)
    out["sp_step"] = st.step
    torch.save(p1_dp, f"{tmp}/sp{rank}.pt")

    # real Shard placements on make_elastic_mesh's (1, 2) mesh
    tp = make_elastic_mesh(device="cpu")
    out["tp_mesh"] = [list(tp.mesh_dim_names), list(tp.mesh.shape)]
    halves, bitwise = 0, True
    shard = param_shardings(p_dp, tp)

    def walk(p, s):
        global halves, bitwise
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        dt = distribute_tensor(p, tp, s.placements)
        if any(isinstance(x, Shard) for x in s.placements):
            halves += dt.to_local().shape != p.shape
        bitwise &= torch.equal(dt.full_tensor(), p)
        return dt
    placed = walk(p_dp, shard)
    out["halves"], out["placed_bitwise"] = halves, bitwise
    save_tree(f"{tmp}/placed{rank}.mz", placed)
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
""")


_SCRIPT_4 = textwrap.dedent(r"""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 4),
                            rank=rank, world_size=4)
    from repro_torch.distributed.collectives import (data_parallel_loss,
                                                     psum_scalar)
    from repro_torch.models import all_archs, bundle
    from repro_torch.perturb.stream import prng_key

    names = ("pod", "data", "model")
    lines = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=names)
    whole = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=names)
    x = 10.0 ** rank                   # each rank's digit in the sums
    out = {"lines": float(psum_scalar(x, ("pod", "data"), lines)),
           "model": float(psum_scalar(x, "model", lines)),
           "whole": float(psum_scalar(x, ("pod", "data"), whole))}

    b = bundle(all_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype="float32"))
    params = b.init(0, device="cpu")
    batch = b.make_batch(prng_key(1), 4, 16, device="cpu")
    keep = torch.tensor([16, 5, 11, 2])[:, None]
    batch["loss_mask"] = (torch.arange(16)[None] < keep).float()
    loss_fn = b.loss_fn()
    out["dp"] = abs(float(data_parallel_loss(loss_fn, whole)(params, batch))
                    - float(loss_fn(params, batch)))
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
""")


def _run_ranks(script: str, n: int, tmp_path) -> list:
    """``script`` in ``n`` processes (rank, ``tmp_path``); their RESULT
    dicts, in rank order."""
    import json
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(tmp_path)], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=240)
            assert p.returncode == 0, so[-3000:] + se[-3000:]
            outs.append(so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [json.loads(o.split("RESULT ", 1)[1]) for o in outs]


def test_two_rank_gloo_data_parallel(tmp_path):
    res = _run_ranks(_SCRIPT, 2, tmp_path)
    for r in res:
        d_loss, d_g, d_p = r["dp"]
        assert d_loss < 1e-4 and d_g < 5e-3 and d_p < 1e-5, r["dp"]
        # spsa: two loss evaluations, one all-reduce of two f32 each, each
        # rank evaluating half of the global batch's four rows
        assert r["rows"] == [2, 2]
        assert r["calls"] == [[2, "torch.float32"]] * 2
        assert max(r["objectives"]) < 1e-6 and r["moe_accuracy"] < 1e-6, r
        assert r["f1"] < -0.01
        assert "load-balancing" in r["moe_ce"], r["moe_ce"]
        assert r["psum"] == 3.0
        assert r["sp"] < 1e-5 and r["sp_step"] == 1
        assert r["tp_mesh"] == [["data", "model"], [1, 2]]
        assert r["halves"] > 0 and r["placed_bitwise"]
    from repro_torch.checkpoint.io import load_tree
    from repro_torch.tree_utils import tree_leaves
    for kind in ("dp", "sp"):
        a, b = (torch.load(tmp_path / f"{kind}{r}.pt") for r in range(2))
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b))), kind
    theta = torch.load(tmp_path / "dp0.pt")
    loaded, _ = load_tree(str(tmp_path / "placed0.mz"), theta)
    assert all(torch.equal(x, y) and type(x) is torch.Tensor
               for x, y in zip(tree_leaves(loaded), tree_leaves(theta)))


def test_four_rank_gloo_multi_axis_groups(tmp_path):
    res = _run_ranks(_SCRIPT_4, 4, tmp_path)
    # rank = 2·pod + model on (2, 1, 2): the ('pod', 'data') lines are
    # {0, 2} and {1, 3}, the 'model' lines {0, 1} and {2, 3}
    assert [r["lines"] for r in res] == [101.0, 1010.0, 101.0, 1010.0]
    assert [r["model"] for r in res] == [11.0, 11.0, 1100.0, 1100.0]
    assert all(r["whole"] == 1111.0 for r in res)
    assert all(r["dp"] < 1e-6 for r in res), res
