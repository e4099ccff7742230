"""Tensor parallelism on four CPU ranks — the counterpart of JAX's
``tests/test_distributed.py`` sharded checks: four ``gloo`` processes (a
``FileStore`` under ``tmp_path``) run the port's MeZO step with θ as
DTensors under ``param_shardings`` on a (2, 2) ``data × model`` mesh, the
batch placed over 'data', on JAX's own case — qwen2-0.5b's smoke config in
f32, θ₀ carried from JAX through ``convert``, a 4 × 16 batch — and are held
to JAX's one-device step at JAX's bounds (loss 1e-4, g 5e-3, θ 1e-5):

* the spsa step on ``xla`` (X1 on each rank's shards) and on ``pallas``
  (K1 on shards) against JAX's ``xla`` and ``pallas-interpret`` steps;
* the TP forward's logits within 2e-3 of JAX's, for ``attention_impl``
  ``xla`` and ``pallas_flash`` (K2's plain version on each rank's heads);
* the ``seed_parallel(2)`` step (X1 on shards, the group updates too) on
  ``xla`` within 1e-5;
* θ at every loss evaluation, gathered, bitwise the one-process port's,
  and the update written with the one-process g bitwise its update;
* the saved sharded θ loaded onto plain tensors bitwise (the elastic path);
* the kernels' charges of the dry run's trace of the same step on a fake
  (2, 2) mesh equal to the live step's on each rank;
* the z kernels' window helper (``_build.shard_map`` and
  ``shard_window``) equal to ``distribute_tensor``'s local shards;
* the sharded writes with no shard map yet (the fan-out, the sphere's
  ‖z‖², rows plans), a live DTensor handed to a kernel, and K2 on heads
  placed unlike each other, refused.

The ranks run while the test process computes JAX's references.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent

_RANK = textwrap.dedent(r"""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 4),
                            rank=rank, world_size=4)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import exec as zexec
    from repro_torch import zo
    from repro_torch.analysis import costs
    from repro_torch.checkpoint.io import save_tree
    from repro_torch.device import host_f32
    from repro_torch.distributed import make_activation_resolver
    from repro_torch.distributed.sharding import P, NamedSharding, place
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.zo_fused.kernel import zo_affine
    from repro_torch.models import all_archs, bundle
    from repro_torch.models.common import shard_resolver
    from repro_torch.perturb import StreamRef, get_backend
    from repro_torch.perturb.stream import prng_key
    from repro_torch.select import parse_selection
    from repro_torch.tree_utils import tree_clone, tree_leaves, tree_map

    inp = torch.load(tmp + "/inputs.pt")
    params0, batch = inp["params"], inp["batch"]
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype="float32")
    b = bundle(cfg)
    loss_fn = b.loss_fn()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}

    def full(tree):
        # a replicated leaf's full_tensor() is its live local tensor: copy
        return tree_map(lambda t: t.full_tensor().clone(), tree)

    def same(a, c):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(c)))

    def opt_of(backend):
        return zo.mezo(lr=1e-4, eps=1e-3, backend=backend)

    def placed_params(prog):
        return place(tree_clone(params0), prog.shardings(params0)[0])

    # the window helper against distribute_tensor's shards
    prog = zexec.StepProgram(opt_of("xla"), zexec.local(mesh=mesh))
    psh = prog.shardings(params0)[0]
    helper_ok, n_sharded = True, 0
    coord = mesh.get_coordinate()
    for p, sh in zip(tree_leaves(params0), tree_leaves(psh)):
        dt = distribute_tensor(p, mesh, sh.placements)
        smap = _build.shard_map(dt)
        local = dt.to_local()
        if smap is None:
            helper_ok &= torch.equal(local, p)
            continue
        n_sharded += 1
        idx = smap.index(0, local.numel(), "cpu")
        helper_ok &= torch.equal(local.reshape(-1), p.reshape(-1)[idx])
        dim = [pl.dim for pl in sh.placements if pl.is_shard()][0]
        sl, wmap = _build.shard_window(p.shape, dim, 2, coord[1])
        helper_ok &= wmap == smap and torch.equal(p[sl], local)
    out["helper"] = [bool(helper_ok), n_sharded]

    # the spsa step on each stream: the TP step (its θ at each loss
    # evaluation recorded), the one-process port step, and the TP step
    # again with the one-process losses (so the one-process g) written
    for backend in ("xla", "pallas"):
        seen, one_seen, one_losses = [], [], []

        def rec_tp(p, bt):
            seen.append(full(p))
            return loss_fn(p, bt)

        def rec_one(p, bt):
            one_seen.append(tree_clone(p))
            loss = loss_fn(p, bt)
            one_losses.append(float(host_f32(loss)))
            return loss

        prog = zexec.StepProgram(opt_of(backend), zexec.local(mesh=mesh))
        opt = opt_of(backend)
        with costs.counting() as charged:
            p_tp, _, m_tp = prog.step_fn(rec_tp)(
                placed_params(prog), opt.init(params0, seed=0), batch)
        p_one, _, _ = zexec.StepProgram(opt).step_fn(rec_one)(
            tree_clone(params0), opt.init(params0, seed=0), batch)

        def rec_replayed(p, bt):
            seen.append(full(p))
            return torch.tensor(one_losses[len(seen) - 3])

        p_rep, _, _ = prog.step_fn(rec_replayed)(
            placed_params(prog), opt.init(params0, seed=0), batch)
        theta = full(p_tp)
        out[backend] = {
            "loss": float(m_tp["loss"]), "g": float(m_tp["projected_grad"]),
            "pm_bitwise": [same(a, c) for a, c in zip(seen[:2], one_seen)]
            + [same(a, c) for a, c in zip(seen[2:], one_seen)],
            "update_bitwise": same(full(p_rep), p_one),
            "charges": charged.as_dict()}
        if rank == 0:
            torch.save(theta, f"{tmp}/theta_{backend}.pt")
        if backend == "xla":
            save_tree(f"{tmp}/placed{rank}.mz", p_tp)

    # seed_parallel(2) on xla, the groups' rows placed over 'data'
    opt = opt_of("xla")
    prog = zexec.StepProgram(opt, zexec.seed_parallel(2, mesh=mesh))
    p_sp, _, m_sp = prog.step_fn(loss_fn)(placed_params(prog),
                                          opt.init(params0, seed=0), batch)
    theta_sp = full(p_sp)              # a collective: every rank gathers
    if rank == 0:
        torch.save(theta_sp, f"{tmp}/theta_sp.pt")

    # the TP forward's logits, attention on the xla path and on K2
    for impl in ("xla", "pallas_flash"):
        bi = bundle(cfg.replace(attention_impl=impl))
        placed = placed_params(prog)
        tokens = place({"tokens": batch["tokens"]},
                       {"tokens": NamedSharding(mesh, P("data"))})
        with shard_resolver(make_activation_resolver(mesh)), \
                implicit_replication(), torch.no_grad():
            logits = bi.train_logits_fn()(placed, tokens)
        logits = logits.full_tensor()
        if rank == 0:
            torch.save(logits, f"{tmp}/logits_{impl}.pt")

    # refusals on live sharded leaves
    placed = placed_params(prog)
    ref = StreamRef(prng_key(3))
    refusals = {}
    for what, call in (
            ("fan-out", lambda: get_backend("pallas").perturb_many(
                placed, [ref, ref], 1e-3)),
            ("sphere", lambda: get_backend("xla").perturb(
                placed, ref, 1e-3, "sphere")),
            ("rows", lambda: get_backend("pallas").perturb(
                placed, StreamRef(prng_key(3), parse_selection(
                    "rows(block=1,k=4)"), 0), 1e-3)),
            ("dtensor", lambda: zo_affine(placed["embed"], 1, 1.0, 1e-3)),
            ("heads", lambda: flash_attention(*(
                distribute_tensor(torch.zeros(2, 4, 4, 8), mesh, pl)
                for pl in ([Replicate(), Shard(2)], [Replicate(), Shard(2)],
                           [Replicate(), Shard(1)]))))):
        try:
            call()
            refusals[what] = "accepted"
        except (NotImplementedError, TypeError, ValueError) as e:
            refusals[what] = f"{type(e).__name__}: {e}"
    out["refusals"] = refusals
    dist.barrier()
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
""")


def _start_ranks(tmp_path) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                              str(tmp_path)], env=env, cwd=str(tmp_path),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(4)]


def _results(procs) -> list:
    import json
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=240)
            assert p.returncode == 0, so[-3000:] + se[-3000:]
            outs.append(json.loads(so.split("RESULT ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's references and the four ranks' results on one case."""
    import jax
    import jax.numpy as jnp

    from repro import exec as jexec
    from repro import zo as jzo
    from repro.models import all_archs as jax_archs
    from repro.models import bundle as jax_bundle
    from repro.models import transformer as jtransformer
    from repro_torch import convert
    tmp = tmp_path_factory.mktemp("tp")
    cfg = jax_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype="float32")
    jb = jax_bundle(cfg)
    params = jb.init(jax.random.PRNGKey(0))
    batch = jb.make_batch(jax.random.PRNGKey(1), batch=4, seq=16)
    torch.save({"params": convert.params_from_jax(
        jax.tree.map(np.asarray, params)),
        "batch": {k: torch.from_numpy(np.array(v)) for k, v in
                  batch.items()}}, tmp / "inputs.pt")
    procs = _start_ranks(tmp)
    loss_fn = jb.loss_fn()
    ref = {}
    for backend, jbackend in (("xla", "xla"), ("pallas", "pallas-interpret")):
        opt = jzo.mezo(lr=1e-4, eps=1e-3, backend=jbackend)
        p, _, m = jax.jit(opt.step_fn(loss_fn))(params,
                                                opt.init(params, seed=0),
                                                batch)
        ref[backend] = (jax.tree.map(np.asarray, p), float(m["loss"]),
                        float(m["projected_grad"]))
    opt = jzo.mezo(lr=1e-4, eps=1e-3, backend="xla")
    sp = jexec.StepProgram(opt, jexec.seed_parallel(2)).step_fn(loss_fn)
    ref["sp"] = jax.tree.map(np.asarray, jax.jit(sp)(
        params, opt.init(params, seed=0), batch)[0])
    ref["logits"] = np.asarray(jtransformer.forward(
        cfg, params, tokens=batch["tokens"]).logits)
    ref["params0"] = jax.tree.map(jnp.asarray, params)
    return tmp, ref, _results(procs)


def _max_diff(torch_tree, jax_tree) -> float:
    from repro_torch import convert
    from repro_torch.tree_utils import tree_leaves
    want = convert.params_from_jax(jax_tree)
    return max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(torch_tree), tree_leaves(want)))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_tp_step_meets_jax_bounds(run, backend):
    tmp, ref, res = run
    theta = torch.load(tmp / f"theta_{backend}.pt")
    want, loss, g = ref[backend]
    for r in res:
        assert abs(r[backend]["loss"] - loss) < 1e-4, (r[backend], loss)
        assert abs(r[backend]["g"] - g) < 5e-3, (r[backend], g)
    assert _max_diff(theta, want) < 1e-5


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_tp_theta_pm_and_update_bitwise_one_process(run, backend):
    for r in run[2]:
        assert r[backend]["pm_bitwise"] == [True] * 4, r[backend]
        assert r[backend]["update_bitwise"], r[backend]


@pytest.mark.parametrize("impl", ["xla", "pallas_flash"])
def test_tp_forward_logits_match_jax(run, impl):
    tmp, ref, _ = run
    logits = torch.load(tmp / f"logits_{impl}.pt").numpy()
    assert float(np.max(np.abs(logits - ref["logits"]))) < 2e-3


def test_tp_seed_parallel_matches_jax(run):
    tmp, ref, _ = run
    assert _max_diff(torch.load(tmp / "theta_sp.pt"), ref["sp"]) < 1e-5


def test_tp_saved_sharded_theta_loads_bitwise(run):
    from repro_torch.checkpoint.io import load_tree
    from repro_torch.tree_utils import tree_leaves
    tmp = run[0]
    theta = torch.load(tmp / "theta_xla.pt")
    loaded, _ = load_tree(str(tmp / "placed0.mz"), theta)
    assert all(torch.equal(a, b) and type(a) is torch.Tensor
               for a, b in zip(tree_leaves(loaded), tree_leaves(theta)))


def test_shard_window_helper_is_distribute_tensors_shard(run):
    for r in run[2]:
        ok, n_sharded = r["helper"]
        assert ok and n_sharded > 0, r["helper"]


@pytest.mark.parametrize("what,needle", [
    ("fan-out", "ROADMAP Queue 2"), ("sphere", "ROADMAP Queue 2"),
    ("rows", "ROADMAP Queue 2"),
    ("dtensor", "local shard"), ("heads", "placed differently")])
def test_sharded_writes_without_a_route_refuse(run, what, needle):
    for r in run[2]:
        assert needle in r["refusals"][what], r["refusals"][what]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_dry_run_charges_equal_the_live_tp_step(run, backend):
    """The dry run traces the step on a fake (2, 2) mesh on ``meta``
    DTensors; its kernels' charges (calls, bytes, operations on the rank's
    shards) are the live four-rank step's, rank by rank alike."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShapeCell, all_archs, bundle
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype="float32")
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        trace = dryrun.trace_case(cfg, bundle(cfg),
                                  ShapeCell("t", 16, 4, "train"), mesh,
                                  backend=backend)
    for r in run[2]:
        assert r[backend]["charges"] == trace.kernels, (r[backend],
                                                        trace.kernels)
