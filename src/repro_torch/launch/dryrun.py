"""Multi-pod dry run: trace every (architecture × shape × mesh) cell's step
on one rank and record its per-rank work for the roofline report — the
port of ``repro.launch.dryrun``.

Usage:
  python -m repro_torch.launch.dryrun                     # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch qwen2-7b --cell train_4k --mesh single
  python -m repro_torch.launch.dryrun --mesh-shape 1,1    # one rank, meta tensors
  python -m repro_torch.launch.dryrun --ep-mesh --arch mixtral-8x7b

Outputs one JSON line per case to results/dryrun.jsonl (append), with
JAX's keys, so ``repro_torch.analysis.report`` (or JAX's) renders either
package's records.

How a case is traced.  JAX compiles the step for a mesh of host-platform
placeholder devices; CUDA devices cannot be faked, but a process group can.
For each mesh the dry run starts torch's ``"fake"`` process group (rank 0
of the mesh's rank count, on a ``FakeStore``: every collective returns at
once and moves nothing), builds the mesh through ``launch.mesh`` on device
type ``cpu`` — the card is never touched — and destroys the group before
the next mesh.  The parameters (``Bundle.param_shapes()``) and the cell's
inputs (``Bundle.input_specs``) become DTensors on ``meta`` tensors placed
by ``param_shardings`` / ``infer_batch_spec``, with the activation resolver
installed; the step then runs eagerly on them under
``implicit_replication()`` (the model's plain constants — rotary tables,
masks, positions — mix in as replicated), so nothing is allocated and
DTensor's propagation inserts the collectives a rank would issue.  A mesh
of one rank (``--mesh-shape 1,1``) traces plain ``meta`` tensors.  Every
kernel wrapper takes its shape rule on ``meta`` tensors and charges its
work (``analysis.costs``); every host read of a loss answers a placeholder
(``device.placeholder_reads``), so the trace makes the kernel calls a real
step makes.

What is counted, per rank, from the local ops beneath DTensor's dispatch:

* FLOPs: the flop counter's formulas (``torch.utils.flop_counter``) on the
  local shards, plus the kernels' tensor-core charges (K2's matmuls);
* HBM bytes: each local op's operand and result bytes — before any fusion,
  as the port runs eagerly — with the kernels charged by ``analysis.costs``
  and not by their plain versions;
* collectives by kind with their local result bytes (and DTensor's own
  ``CommDebugMode`` counts beside them);
* memory: the argument bytes (the local shards of θ, the optimizer state
  and the batch) and the peak of live bytes above them during the trace.

``compile_s`` holds the trace's seconds (JAX's key: its compile time).
There is no ``calibrate_loop_costs``: XLA's cost analysis counts a scanned
layer loop's body once, so JAX extrapolates from 1- and 2-layer compiles;
an eager trace runs every layer and counts each.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import threading
import time
import traceback
import weakref

import torch

from repro_torch import exec as zexec
from repro_torch import zo
from repro_torch.analysis import costs
from repro_torch.analysis import flops as flops_lib
from repro_torch.analysis import roofline as roofline_lib
from repro_torch.device import placeholder_reads
from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              infer_batch_spec,
                                              make_activation_resolver,
                                              param_shardings)
from repro_torch.launch.mesh import (make_ep_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import ALL_CELLS, all_archs, bundle, cells_for
from repro_torch.models.common import shard_resolver
from repro_torch.models.rwkv6 import RWKVLayerState
from repro_torch.tree_utils import tree_leaves, tree_map

P = PartitionSpec

#: JAX's HLO names of the functional collectives a DTensor program issues
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor_coalesced": "reduce-scatter"}
#: ops that allocate without moving bytes
_ALLOCATORS = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}
#: ops whose result shares its input's storage though their schema does not
#: say so
_VIEW_LIKE = {"_unsafe_view", "lift_fresh"}
#: seconds one case may trace before it is recorded as an error: DTensor's
#: search over sharding strategies can grow past any use on a 3-D mesh
#: (an einsum of 5-D operands on the multi-pod mesh)
CASE_LIMIT_S = 300


def _testing_api():
    """torch's fake process group (its testing namespace) and DTensor's
    ``implicit_replication`` (its experimental namespace): the one place
    the port reaches either."""
    try:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group (torch.testing."
            "_internal.distributed.fake_pg.FakeStore) and DTensor's "
            "implicit_replication (torch.distributed.tensor.experimental); "
            f"this torch lacks one: {e}") from e
    return FakeStore, implicit_replication


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise ``TimeoutError`` in the block after ``seconds`` (the main
    thread only; elsewhere no limit)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"the trace passed {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@contextlib.contextmanager
def fake_group(world: int):
    """Rank 0 of a ``world``-rank fake process group, destroyed on exit."""
    import torch.distributed as dist
    FakeStore, _ = _testing_api()
    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the dry run "
                           "starts (and destroys) its own fake group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Placement of the step's arguments
# --------------------------------------------------------------------------- #
def _ns(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def batch_sharding_tree(cfg, specs: dict, mesh) -> dict:
    """Map the input_specs dict (incl. nested caches/states) to shardings."""
    del cfg
    out = {}
    for name, sds in specs.items():
        if name == "cache":
            out[name] = {
                "k": _ns(mesh, infer_batch_spec("cache_k", sds["k"].shape,
                                                mesh)),
                "v": _ns(mesh, infer_batch_spec("cache_v", sds["v"].shape,
                                                mesh)),
                "pos": _ns(mesh, infer_batch_spec("cache_pos_arr",
                                                  sds["pos"].shape, mesh)),
            }
        elif name == "cross_kv":
            out[name] = {
                "k": _ns(mesh, infer_batch_spec("cross_k", sds["k"].shape,
                                                mesh)),
                "v": _ns(mesh, infer_batch_spec("cross_v", sds["v"].shape,
                                                mesh)),
            }
        elif name == "state":
            if isinstance(sds, RWKVLayerState):
                out[name] = RWKVLayerState(
                    shift_tm=_ns(mesh, infer_batch_spec(
                        "rwkv_shift", sds.shift_tm.shape, mesh)),
                    shift_cm=_ns(mesh, infer_batch_spec(
                        "rwkv_shift", sds.shift_cm.shape, mesh)),
                    wkv=_ns(mesh, infer_batch_spec("rwkv_wkv", sds.wkv.shape,
                                                   mesh)))
            else:
                out[name] = _ns(mesh, infer_batch_spec("ssm_state",
                                                       sds.shape, mesh))
        else:
            out[name] = _ns(mesh, infer_batch_spec(name, sds.shape, mesh))
    return out


def replicated_tree(tree, mesh):
    return tree_map(lambda _: _ns(mesh, P()), tree)


def _placed(t: torch.Tensor, sharding: NamedSharding):
    """``t``'s shape as a DTensor on ``meta``: rank 0's shard under the
    sharding's placements (DTensor's rule: uneven shards give the early
    ranks one more row)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = sharding.placements
    local_shape, _ = compute_local_shape_and_global_offset(
        t.shape, sharding.mesh, pl)
    local = torch.empty(local_shape, dtype=t.dtype, device="meta")
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def _place_tree(tree, shardings):
    """``tree``'s meta leaves placed leaf by leaf (the two trees share a
    structure; ``shardings`` None leaves every leaf a plain meta tensor)."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_place_tree(v, s)
                            for v, s in zip(tree, shardings)))
    if isinstance(tree, list):
        return [_place_tree(v, s) for v, s in zip(tree, shardings)]
    return _placed(tree, shardings)


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "placements") else t
            total += loc.numel() * loc.element_size()
    return total


# --------------------------------------------------------------------------- #
# The per-rank counter
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Trace:
    """One rank's counts over a traced step (see the module docstring)."""
    flops: int = 0
    hbm_bytes: int = 0
    collectives: list = dataclasses.field(default_factory=list)
    memory: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    kernel_alu_ops: int = 0
    comm_counts: dict = dataclasses.field(default_factory=dict)


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _RankOps:
    """A dispatch mode that sees the local ops beneath DTensor's dispatch
    (it declines DTensor-level calls, so DTensor runs them on the shards
    and their ops come back here), skipping DTensor's own shape
    propagation, which runs each op once more on global shapes."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.flop_registry = flop_registry
        self.flops = self.bytes = self.ops = 0
        self.collectives: list = []
        self.live = self.peak = 0
        #: id of a live tensor -> its storage's [bytes, live tensors on it]
        self._storage: dict = {}
        self.suspended = 0
        self.last_dtensor_op = None

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                placed = [t for t in _tensors((args, kwargs))
                          if hasattr(t, "placements")]
                if placed:
                    counter.last_dtensor_op = (func, [
                        (tuple(t.shape), tuple(t.placements))
                        for t in placed])
                    return NotImplemented
                out = func(*args, **kwargs)
                if not counter.suspended:
                    counter.account(func, args, kwargs, out)
                return out

        self.mode = Mode()

    def _hold(self, t: torch.Tensor, token: list) -> None:
        """``t`` keeps ``token``'s storage alive until it is collected."""
        token[1] += 1
        self._storage[id(t)] = token
        weakref.finalize(t, self._release, id(t), token)

    def _release(self, key: int, token: list) -> None:
        if self._storage.get(key) is token:
            del self._storage[key]
        token[1] -= 1
        if token[1] == 0:
            self.live -= token[0]

    def account(self, func, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        outs = _tensors(out)
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            if name in _COLLECTIVES:
                self.collectives.append((_COLLECTIVES[name],
                                         sum(_nbytes(t) for t in outs)))
            return
        self.ops += 1
        packet = func.overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.is_view or name in _VIEW_LIKE:
            # a view keeps its base's storage live (the base tensor may go)
            bases = _tensors((args, kwargs))
            token = self._storage.get(id(bases[0])) if bases else None
            if token is not None:
                for t in outs:
                    self._hold(t, token)
            return
        if name not in _ALLOCATORS:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        if any(r.alias_info is not None for r in func._schema.returns):
            return                         # in place, or into out=
        for t in outs:
            nb = _nbytes(t)
            self.live += nb
            self.peak = max(self.peak, self.live)
            self._hold(t, [nb, 0])

    @contextlib.contextmanager
    def active(self, placed: bool):
        """The mode, and for a DTensor trace DTensor's shape propagation
        (``ShardingPropagator._propagate_tensor_meta_non_cached``) wrapped
        so that the ops it runs go uncounted."""
        if not placed:
            with self.mode:
                yield self
            return
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name, None)
        if orig is None:
            raise RuntimeError(f"this torch's DTensor has no "
                               f"ShardingPropagator.{name}: the dry run "
                               "cannot tell its shape propagation apart")
        counter = self

        def propagate(prop, op_schema):
            counter.suspended += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter.suspended -= 1

        setattr(ShardingPropagator, name, propagate)
        try:
            with self.mode:
                yield self
        finally:
            setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def tracing(placed: bool):
    """Count one rank's work over the block: yields the ``Trace`` filled in
    on exit.  ``placed`` is a DTensor trace (a mesh of more than one rank):
    under ``implicit_replication`` and DTensor's ``CommDebugMode``."""
    trace = Trace()
    rank_ops = _RankOps()
    with contextlib.ExitStack() as stack:
        if placed:
            _, implicit_replication = _testing_api()
            from torch.distributed.tensor.debug import CommDebugMode
            comm = stack.enter_context(CommDebugMode())
            stack.enter_context(implicit_replication())
        counter = stack.enter_context(costs.counting())
        stack.enter_context(placeholder_reads())
        stack.enter_context(torch.no_grad())
        stack.enter_context(rank_ops.active(placed))
        try:
            yield trace
        except Exception as e:
            if rank_ops.last_dtensor_op is not None:
                func, specs = rank_ops.last_dtensor_op
                e.add_note(f"the last DTensor op: {func} on " + ", ".join(
                    f"{list(s)} {list(p)}" for s, p in specs))
            raise
    trace.ops = rank_ops.ops
    trace.kernels = counter.as_dict()
    trace.flops = rank_ops.flops + counter.ops_at("tensor")
    trace.kernel_alu_ops = counter.ops_at("f32")
    trace.hbm_bytes = rank_ops.bytes + counter.total_bytes
    trace.collectives = list(rank_ops.collectives)
    trace.memory = {"peak_bytes": int(rank_ops.peak)}
    if placed:
        trace.comm_counts = {str(k): int(v) for k, v in
                             comm.get_comm_counts().items()}


# --------------------------------------------------------------------------- #
# One case
# --------------------------------------------------------------------------- #
def _make_opt(estimator, backend, batch_seeds, selection):
    if estimator == "fzoo":
        return zo.fzoo(lr=1e-6, eps=1e-3, batch_seeds=batch_seeds,
                       backend=backend, selection=selection)
    return zo.mezo(lr=1e-6, eps=1e-3, estimator=estimator, backend=backend,
                   selection=selection)


def _host_positions(batch: dict, cell) -> dict:
    """A decode cell's 0-d ``cache_pos`` as a host int (the port's decode
    takes the batch's lockstep position on the host), the context's last
    row: the new token's place after ``seq_len − 1`` cached ones."""
    if "cache_pos" in batch and batch["cache_pos"].dim() == 0:
        batch = dict(batch, cache_pos=cell.seq_len - 1)
    return batch


def place_case(cfg, b, cell, mesh) -> tuple:
    """(θ, the cell's batch, their argument bytes) on rank 0 of ``mesh``
    (None: one rank, plain meta tensors)."""
    specs = b.input_specs(cell)
    params = b.param_shapes()
    if mesh is not None:
        params = _place_tree(params, param_shardings(params, mesh))
        specs = _place_tree(specs, batch_sharding_tree(cfg, specs, mesh))
    return params, specs, {"params": _local_bytes(params),
                           "batch": _local_bytes(specs)}


def trace_case(cfg, b, cell, mesh, backend: str = "xla",
               estimator: str = "spsa", batch_seeds: int = 8,
               exec_plan: str = "local", n_groups: int = 1,
               selection: str = "full", placed_args=None) -> Trace:
    """Trace the cell's step on rank 0 of ``mesh`` (None: one rank, plain
    meta tensors), its arguments ``place_case``'s (made here unless
    given); returns its ``Trace`` with the argument bytes."""
    params, batch, arg_bytes = (placed_args if placed_args is not None
                                else place_case(cfg, b, cell, mesh))
    arg_bytes = dict(arg_bytes)
    placed = mesh is not None
    resolver_p = make_activation_resolver(mesh, cfg) if placed else None
    with shard_resolver(resolver_p):
        if cell.kind == "train":
            opt = _make_opt(estimator, backend, batch_seeds, selection)
            plan = (zexec.seed_parallel(n_groups)
                    if exec_plan == "seed_parallel" else zexec.local())
            prog = zexec.StepProgram(opt, plan)
            state = prog.init(seed=0)
            arg_bytes["state"] = _local_bytes(state)
            step = prog.step_fn(b.loss_fn())
            with tracing(placed) as trace:
                step(params, state, batch)
        elif cell.kind == "prefill":
            with tracing(placed) as trace:
                b.prefill_fn()(params, batch)
        else:
            batch = _host_positions(batch, cell)
            with tracing(placed) as trace:
                b.decode_fn()(params, batch)
    trace.memory.update(
        argument_size_in_bytes=sum(arg_bytes.values()),
        argument_bytes=arg_bytes)
    return trace


def run_case(arch_id: str, cell, mesh, mesh_name: str, overrides: dict,
             optimizer: str = "mezo", verbose: bool = True,
             backend: str = "xla", estimator: str = "spsa",
             batch_seeds: int = 8, exec_plan: str = "local",
             n_groups: int = 1, selection: str = "full") -> dict:
    """One case's record: JAX's keys (``compile_s`` the trace's seconds)
    plus the trace's ``kernels`` (calls, bytes and operations charged per
    kernel), ``kernel_alu_ops`` and ``comm_counts``.  ``mesh`` None is one
    rank on plain meta tensors."""
    arch = all_archs()[arch_id]
    cfg = arch.cfg
    if overrides:
        cfg = cfg.replace(**overrides)
    b = bundle(cfg)
    chips = 1 if mesh is None else int(mesh.size())
    rec = {"arch": arch_id, "cell": cell.name, "mesh": mesh_name,
           "chips": chips, "optimizer": optimizer,
           "perturb_backend": backend, "estimator": estimator,
           "batch_seeds": batch_seeds if estimator == "fzoo" else 1,
           "exec_plan": exec_plan,
           "n_groups": n_groups if exec_plan == "seed_parallel" else 1,
           "selection": selection,
           "overrides": {k: str(v) for k, v in overrides.items()},
           "status": "ok"}
    t0 = time.time()
    try:
        args = place_case(cfg, b, cell, mesh)
        # kept on a failed trace too: what a rank must hold at the least
        rec["memory_analysis"] = {
            "argument_size_in_bytes": sum(args[2].values()),
            "argument_bytes": dict(args[2])}
        with _time_limit(CASE_LIMIT_S):
            trace = trace_case(cfg, b, cell, mesh, backend=backend,
                               estimator=estimator, batch_seeds=batch_seeds,
                               exec_plan=exec_plan, n_groups=n_groups,
                               selection=selection, placed_args=args)
        t_trace = time.time() - t0
        rec["raw"] = {"flops": trace.flops, "hbm_bytes": trace.hbm_bytes,
                      "collective_bytes": roofline_lib.collective_stats(
                          trace.collectives)["total_bytes"]}
        model_fl = flops_lib.model_flops(cfg, cell, optimizer)
        roof = roofline_lib.from_trace(arch_id, cell.name, mesh_name, chips,
                                       trace, model_fl)
        rec.update(dataclasses.asdict(roof))
        rec["compile_s"] = round(t_trace, 2)
        rec["kernels"] = trace.kernels
        rec["kernel_alu_ops"] = trace.kernel_alu_ops
        rec["comm_counts"] = trace.comm_counts
        rec["local_ops"] = trace.ops
        if verbose:
            print(f"[dryrun] {arch_id:22s} {cell.name:12s} {mesh_name:6s} "
                  f"OK  trace={t_trace:6.1f}s "
                  f"flops/chip={rec['flops_per_chip']:.3e} "
                  f"bottleneck={rec['bottleneck']:10s} "
                  f"roofline={rec['roofline_fraction']:.3f}", flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = " ".join([f"{type(e).__name__}: {e}",
                                 *getattr(e, "__notes__", ())])
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] {arch_id:22s} {cell.name:12s} {mesh_name:6s} "
                  f"FAIL {rec['error'][:200]}", flush=True)
    return rec


# --------------------------------------------------------------------------- #
# The command line
# --------------------------------------------------------------------------- #
def _parse_value(v: str):
    if v.isdigit():
        return int(v)
    if v in ("True", "False"):
        return v == "True"
    try:
        return float(v)
    except ValueError:
        return v


@contextlib.contextmanager
def _mesh_for(cfg, mesh_name: str, multi: bool, args):
    """(the mesh, its label) inside its fake process group; None for one
    rank."""
    if args.mesh_shape:
        d, m = (int(x) for x in args.mesh_shape.split(","))
        label = f"{mesh_name}-{d}x{m}"
        if d * m == 1:
            yield None, label
            return
        with fake_group(d * m):
            yield make_mesh((d, m), ("data", "model"), device="cpu"), label
        return
    world = 512 if multi else 256
    with fake_group(world):
        if args.ep_mesh:
            yield (make_ep_mesh(cfg.n_experts or 8, multi_pod=multi,
                                device="cpu"), mesh_name + "-ep")
        else:
            yield make_production_mesh(multi_pod=multi, device="cpu"), \
                mesh_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id (default: all assigned)")
    ap.add_argument("--cell", default=None,
                    help="train_4k|prefill_32k|decode_32k|long_500k")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--ep-mesh", action="store_true",
                    help="use the expert-parallel mesh factorization (MoE)")
    ap.add_argument("--mesh-shape", default=None,
                    help="override data,model (e.g. 32,8) — a DP/TP "
                         "factorization of its own rank count; 1,1 traces "
                         "one rank on plain meta tensors")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. "
                         "attention_impl=chunked)")
    ap.add_argument("--optimizer", default="mezo", choices=["mezo"])
    ap.add_argument("--estimator", default="spsa",
                    choices=["spsa", "one_point", "fzoo"],
                    help="gradient estimator for the train cells; 'fzoo' "
                         "traces the batched-seed one-sided step")
    ap.add_argument("--batch-seeds", type=int, default=8,
                    help="seed streams per step for --estimator fzoo")
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "pallas"],
                    help="perturbation backend for the train cells (X1's "
                         "threefry stream, or the counter-hash stream)")
    ap.add_argument("--exec-plan", default="local",
                    choices=["local", "seed_parallel"],
                    help="execution plan for the train cells "
                         "(repro_torch.exec)")
    ap.add_argument("--n-groups", type=int, default=2,
                    help="seed groups for --exec-plan seed_parallel")
    ap.add_argument("--select", default="full",
                    help="parameter selection for the train cells "
                         "(repro_torch.select spec: full, leaves(<regex>), "
                         "block_cyclic(<k>), peft(lora|prefix), "
                         "moe_experts(<G>)) or 'auto' for the registry's "
                         "per-family default")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED_ARCHS
    from repro_torch.models import default_selection
    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _parse_value(v)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", False))
    if args.mesh in ("multi", "both") and not args.mesh_shape:
        meshes.append(("multi", True))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_fail = 0
    with open(args.out, "a") as f:
        for mesh_name, multi in meshes:
            for arch_id in archs:
                cfg = all_archs()[arch_id].cfg
                cells = cells_for(cfg)
                if args.cell:
                    cells = [c for c in ALL_CELLS if c.name == args.cell]
                    if cells[0] not in cells_for(cfg):
                        print(f"[dryrun] {arch_id} {args.cell}: skipped "
                              f"(not a cell of this arch)", flush=True)
                        continue
                selection = args.select
                if selection == "auto":
                    selection = default_selection(
                        cfg.replace(**overrides) if overrides else cfg)
                with _mesh_for(cfg, mesh_name, multi, args) as (mesh, label):
                    for cell in cells:
                        rec = run_case(arch_id, cell, mesh, label, overrides,
                                       backend=args.backend,
                                       estimator=args.estimator,
                                       batch_seeds=args.batch_seeds,
                                       exec_plan=args.exec_plan,
                                       n_groups=args.n_groups,
                                       selection=selection)
                        if args.tag:
                            rec["tag"] = args.tag
                        f.write(json.dumps(rec) + "\n")
                        f.flush()
                        n_ok += rec["status"] == "ok"
                        n_fail += rec["status"] != "ok"
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
