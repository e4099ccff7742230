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
* fzoo(4) and spsa with ``dist="sphere"`` on both streams and the
  antithetic spsa chain on ``pallas`` (the fan-out K4 / K5 and X1's
  stacked streams on each rank's shards, the sphere's ‖z‖² split over the
  model axis and all-gathered): θ at every loss evaluation and the update
  bitwise the one-process port's, the loss within 1e-4 of JAX's; each
  stacked view a DTensor with θ's placements, with no collective but the
  norm's all-gather;
* the kernels' charges of the dry run's trace of the same step on a fake
  (2, 2) mesh equal to the live step's on each rank (the sphere's norm
  charges: the rank's share);
* the z kernels' window helper (``_build.shard_map`` and
  ``shard_window``) equal to ``distribute_tensor``'s local shards;
* the sharded writes with no shard map yet (rows plans), a live DTensor
  handed to a kernel, and K2 on heads placed unlike each other, refused.

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
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    import numpy as np
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
    from repro_torch.zo.estimators import _view

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

    # name -> optimizer: JAX's cases (``jax_cases`` below) in the port
    CASES = {
        "xla": lambda: opt_of("xla"), "pallas": lambda: opt_of("pallas"),
        "fzoo4_xla": lambda: zo.fzoo(lr=1e-4, eps=1e-3, batch_seeds=4,
                                     backend="xla"),
        "fzoo4_pallas": lambda: zo.fzoo(lr=1e-4, eps=1e-3, batch_seeds=4,
                                        backend="pallas"),
        "sphere_xla": lambda: zo.mezo(lr=1e-4, eps=1e-3, dist="sphere",
                                      backend="xla"),
        "sphere_pallas": lambda: zo.mezo(lr=1e-4, eps=1e-3, dist="sphere",
                                         backend="pallas"),
        "anti_pallas": lambda: zo.mezo(lr=1e-4, eps=1e-3,
                                       sequential_perturb=False,
                                       backend="pallas")}

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

    # each case's step: the TP step (its θ at each loss evaluation
    # recorded), the one-process port step, and the TP step again with the
    # one-process losses (so the one-process g) written
    for name, make in CASES.items():
        seen, one_seen, one_losses, rep_seen = [], [], [], []

        def rec_tp(p, bt):
            seen.append(full(p))
            return loss_fn(p, bt)

        def rec_one(p, bt):
            one_seen.append(tree_clone(p))
            loss = loss_fn(p, bt)
            one_losses.append(float(host_f32(loss)))
            return loss

        def rec_replayed(p, bt):
            rep_seen.append(full(p))
            return torch.tensor(one_losses[len(rep_seen) - 1])

        opt = make()
        prog = zexec.StepProgram(opt, zexec.local(mesh=mesh))
        with costs.counting() as charged:
            p_tp, _, m_tp = prog.step_fn(rec_tp)(
                placed_params(prog), opt.init(params0, seed=0), batch)
        p_one, _, _ = zexec.StepProgram(opt).step_fn(rec_one)(
            tree_clone(params0), opt.init(params0, seed=0), batch)
        p_rep, _, _ = prog.step_fn(rec_replayed)(
            placed_params(prog), opt.init(params0, seed=0), batch)
        theta = full(p_tp)
        g = np.asarray(m_tp["projected_grad"], np.float32).reshape(-1)
        out[name] = {
            "loss": float(m_tp["loss"]), "g": float(g[0]),
            "pm_bitwise": [same(a, c) for a, c in zip(seen, one_seen)]
            + [same(a, c) for a, c in zip(rep_seen, one_seen)],
            "evaluations": [len(seen), len(one_seen), len(rep_seen)],
            "update_bitwise": same(full(p_rep), p_one),
            "charges": charged.as_dict()}
        if rank == 0 and name in ("xla", "pallas"):
            torch.save(theta, f"{tmp}/theta_{name}.pt")
        if name == "xla":
            save_tree(f"{tmp}/placed{rank}.mz", p_tp)
        del p_tp, p_one, p_rep, theta, seen, one_seen, rep_seen

    # the fan-out's stacked DTensor view: the streams written on each
    # shard, each view θ's placements, no collective but the sphere norm's
    # one all-gather per stream
    placed = placed_params(prog)
    refs2 = [StreamRef(prng_key(j)) for j in range(2)]
    views = {}
    for d in ("gaussian", "sphere"):
        with CommDebugMode() as comm:
            st = get_backend("pallas").perturb_many(placed, refs2, 1e-3, d)
            vs = [_view(st, j) for j in range(2)]
        views[d] = {
            "comm": {str(k): int(v)
                     for k, v in comm.get_comm_counts().items()},
            "placed_like_theta": all(
                v.placements == p.placements and v.shape == p.shape
                and s.shape == (2,) + tuple(p.shape)
                for x in vs for v, p, s in zip(tree_leaves(x),
                                               tree_leaves(placed),
                                               tree_leaves(st)))}
    out["views"] = views

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


def jax_cases(jzo) -> dict:
    """The rank script's ``CASES`` as JAX's optimizers (``pallas`` is JAX's
    ``pallas-interpret``, as its CPU tests run it).  fzoo's loss is its
    center forward ℓ(θ₀), which no z stream touches, so JAX's fzoo(4) step
    on ``xla`` gives the loss both port streams are held to."""
    return {
        "xla": jzo.mezo(lr=1e-4, eps=1e-3, backend="xla"),
        "pallas": jzo.mezo(lr=1e-4, eps=1e-3, backend="pallas-interpret"),
        "fzoo4_xla": jzo.fzoo(lr=1e-4, eps=1e-3, batch_seeds=4,
                              backend="xla"),
        "sphere_xla": jzo.mezo(lr=1e-4, eps=1e-3, dist="sphere",
                               backend="xla"),
        "sphere_pallas": jzo.mezo(lr=1e-4, eps=1e-3, dist="sphere",
                                  backend="pallas-interpret"),
        "anti_pallas": jzo.mezo(lr=1e-4, eps=1e-3, sequential_perturb=False,
                                backend="pallas-interpret")}


#: the estimators this slice runs under tensor parallelism: fzoo(4) and
#: sphere spsa on both streams, the antithetic spsa chain on ``pallas``
NEW_CASES = ("fzoo4_xla", "fzoo4_pallas", "sphere_xla", "sphere_pallas",
             "anti_pallas")
#: (loss evaluations of one step, of which the stacked views): spsa's two
#: and fzoo(4)'s four views and its center
EVALUATIONS = {"fzoo4_xla": 5, "fzoo4_pallas": 5, "sphere_xla": 2,
               "sphere_pallas": 2, "anti_pallas": 2}


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
    for name, opt in jax_cases(jzo).items():
        p, _, m = jax.jit(opt.step_fn(loss_fn))(params,
                                                opt.init(params, seed=0),
                                                batch)
        ref[name] = (jax.tree.map(np.asarray, p), float(m["loss"]),
                     float(np.ravel(m["projected_grad"])[0]))
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


@pytest.mark.parametrize("case", ("xla", "pallas") + NEW_CASES)
def test_tp_theta_pm_and_update_bitwise_one_process(run, case):
    n = EVALUATIONS.get(case, 2)
    for r in run[2]:
        assert r[case]["evaluations"] == [n] * 3, r[case]
        assert r[case]["pm_bitwise"] == [True] * (2 * n), r[case]
        assert r[case]["update_bitwise"], r[case]


@pytest.mark.parametrize("case", NEW_CASES)
def test_tp_estimators_losses_meet_jax(run, case):
    """fzoo(4), sphere spsa and the antithetic chain under tensor
    parallelism: the step's loss within JAX's 1e-4 of JAX's one-device
    step on the same θ₀ (g is not compared across frameworks: its 1/ε
    magnifies the forward's tolerance, ROADMAP Queue 3)."""
    _, ref, res = run
    loss = ref["fzoo4_xla" if case.startswith("fzoo4") else case][1]
    for r in res:
        assert abs(r[case]["loss"] - loss) < 1e-4, (r[case]["loss"], loss)


@pytest.mark.parametrize("dist,want", [
    ("gaussian", {}), ("sphere", {"c10d.allgather_": 2})])
def test_tp_fanout_views_take_theta_placements(run, dist, want):
    """``perturb_many`` on live sharded θ (two streams, ``pallas``): each
    stacked view (fzoo's ``_view``) is a DTensor with θ's own placements
    and shape, its stack ``(2, *shape)``; the gaussian fan-out moves
    nothing between ranks (no gather of θ), the sphere's only its norm's
    partial sums — one all-gather per stream."""
    for r in run[2]:
        v = r["views"][dist]
        assert v["placed_like_theta"] and v["comm"] == want, v


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
    ("rows", "ROADMAP Queue 2"),
    ("dtensor", "local shard"), ("heads", "placed differently")])
def test_sharded_writes_without_a_route_refuse(run, what, needle):
    for r in run[2]:
        assert needle in r["refusals"][what], r["refusals"][what]


#: the dry run's cases: (estimator, batch seeds, dist, backend) by name
DRY_CASES = {"xla": ("spsa", 1, "gaussian", "xla"),
             "pallas": ("spsa", 1, "gaussian", "pallas"),
             "fzoo4_pallas": ("fzoo", 4, "gaussian", "pallas"),
             "sphere_xla": ("spsa", 1, "sphere", "xla"),
             "sphere_pallas": ("spsa", 1, "sphere", "pallas")}


@pytest.mark.parametrize("case", sorted(DRY_CASES))
def test_dry_run_charges_equal_the_live_tp_step(run, case):
    """The dry run traces the step on a fake (2, 2) mesh on ``meta``
    DTensors as rank 0; its kernels' charges (calls, bytes, operations on
    the rank's shards) are the live four-rank step's.  The sphere's ‖z‖²
    is split over the model axis, so a rank's norm charges are its share:
    the ranks at model coordinate 0 (ranks 0 and 2) equal the trace in
    every kernel, those at 1 in every kernel but the norm's, and the two
    shares' K6 work adds up to the whole norm's."""
    from repro_torch.analysis import costs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShapeCell, all_archs, bundle
    estimator, seeds, dist, backend = DRY_CASES[case]
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(dtype="float32")
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        trace = dryrun.trace_case(cfg, bundle(cfg),
                                  ShapeCell("t", 16, 4, "train"), mesh,
                                  backend=backend, estimator=estimator,
                                  batch_seeds=seeds, dist=dist)
    res = run[2]
    for rank, r in enumerate(res):
        got = r[case]["charges"]
        if dist != "sphere" or rank % 2 == 0:
            assert got == trace.kernels, (rank, got, trace.kernels)
            continue
        norm = "zo_sqnorm" if backend == "pallas" else "zo_affine_threefry"
        assert {k: v for k, v in got.items() if k != norm} == {
            k: v for k, v in trace.kernels.items() if k != norm}
    if dist == "sphere" and backend == "pallas":
        # three norm passes a step (θ ± εz and the restore), each the whole
        # leaf list's tiles over both shares
        ns = [p.numel() for p in tree_leaves_of(cfg)]
        per_pass = costs.total(costs.zo_sqnorm(n) for n in ns).ops
        assert res[0][case]["charges"]["zo_sqnorm"]["ops"] + res[1][case][
            "charges"]["zo_sqnorm"]["ops"] == 3 * per_pass
        assert res[0][case]["charges"]["zo_sqnorm"]["ops"] < 3 * per_pass


def tree_leaves_of(cfg) -> list:
    """The floating leaves of ``cfg``'s θ (as meta tensors)."""
    from repro_torch.models import bundle
    from repro_torch.tree_utils import is_floating, tree_leaves
    return [p for p in tree_leaves(bundle(cfg).param_shapes())
            if is_floating(p)]
