"""The port's sharding rule engine (``repro_torch.distributed.sharding``)
against JAX's ``repro.distributed.sharding`` — the counterpart of
``tests/test_sharding.py``, spec-level, no devices needed:

* ``infer_param_spec`` equals JAX's entry for entry on every leaf of every
  assigned arch at full config, on the single-pod, multi-pod and
  expert-parallel meshes (JAX's shapes from ``jax.eval_shape``, the port's
  from ``Bundle.param_shapes()``); the sharded dims divide their axes and
  the big weights do shard;
* ``Bundle.param_shapes()`` equals ``jax.eval_shape`` of JAX's init in
  paths, shapes and dtypes for every registered arch, on the ``meta``
  device;
* ``infer_batch_spec`` on every name, on dims that do and do not divide;
* ``make_activation_resolver``'s answers over a sweep of logical names,
  shapes and config flags;
* the shape-only production meshes, and ``param_shardings`` on a one-rank
  ``gloo`` ``DeviceMesh`` (placed and taken back bitwise).
"""
import itertools
import types

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS
from repro.distributed import sharding as jsh
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro_torch.distributed import (infer_batch_spec, infer_param_spec,
                                     make_activation_resolver,
                                     param_shardings, param_specs)
from repro_torch.distributed.sharding import P, batch_shardings
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import all_archs, bundle
from repro_torch.tree_utils import flatten_with_path, tree_leaves


class FakeMesh:
    """Shape-only stand-in (no devices needed for spec inference)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape.keys())


MESH = FakeMesh({"data": 16, "model": 16})
MESH_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESH_EP = FakeMesh({"data": 16, "expert": 8, "model": 2})
MESHES = {"single": MESH, "multi": MESH_MP, "ep": MESH_EP}


def _axis_sizes(mesh, entry):
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return int(np.prod([mesh.shape[a] for a in entry]))
    return mesh.shape[entry]


_SHAPES: dict = {}


def _jax_leaves(arch_id):
    if arch_id not in _SHAPES:
        shapes = jax_bundle(jax_archs()[arch_id].cfg).param_shapes()
        _SHAPES[arch_id] = [
            (jax.tree_util.keystr(kp), tuple(leaf.shape), str(leaf.dtype))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    return _SHAPES[arch_id]


@pytest.mark.parametrize("arch_id", sorted(jax_archs()))
def test_param_shapes_equal_jax(arch_id):
    tree = bundle(all_archs()[arch_id].cfg).param_shapes()
    got = [(path, tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
           for path, leaf in flatten_with_path(tree)]
    assert got == _jax_leaves(arch_id)
    assert all(leaf.is_meta for leaf in tree_leaves(tree))


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ASSIGNED_ARCHS)
def test_param_specs_equal_jax(arch_id, mesh_id):
    mesh = MESHES[mesh_id]
    tree = bundle(all_archs()[arch_id].cfg).param_shapes()
    specs = param_specs(tree, mesh)
    n_sharded = 0
    saw_expert_axis = False
    for (path, shape, _), (tpath, spec) in zip(_jax_leaves(arch_id),
                                               _spec_items(specs, tree)):
        assert tpath == path
        want = jsh.infer_param_spec(path, shape, mesh)
        assert spec == tuple(want), (arch_id, path, spec, want)
        assert infer_param_spec(path, shape, mesh) == spec
        for dim, entry in enumerate(spec):
            size = _axis_sizes(mesh, entry)
            if size > 1:
                n_sharded += 1
                assert shape[dim] % size == 0, (arch_id, path, shape, spec)
            saw_expert_axis |= entry == "expert"
    if mesh_id != "ep":
        # the big weights must actually shard (not all-replicated)
        assert n_sharded >= 6, (arch_id, n_sharded)
    elif all_archs()[arch_id].cfg.n_experts % 8 == 0 and \
            all_archs()[arch_id].cfg.n_experts:
        assert saw_expert_axis, arch_id


def _spec_items(specs, tree):
    """(path, spec) per leaf: the spec tree holds a spec at each of the
    parameter tree's leaf positions."""
    paths = [p for p, _ in flatten_with_path(tree)]
    out = []
    for path in paths:
        node = specs
        for key in path[2:-2].split("']['"):
            node = node[key]
        out.append((path, node))
    return out


def test_batch_specs():
    assert infer_batch_spec("tokens", (256, 4096), MESH) == P("data", None)
    assert infer_batch_spec("tokens", (1, 4096), MESH) == P(None, None)
    s = infer_batch_spec("cache_k", (32, 128, 32768, 8, 128), MESH)
    assert s[1] == "data" and s[2] == "model"             # flash-decode split
    assert infer_batch_spec("tokens", (256, 4096), MESH_MP)[0] == \
        ("pod", "data")


_BATCH_NAMES = ("tokens", "labels", "loss_mask", "token", "gold_ids",
                "embeds", "frames", "embed", "cache_k", "cache_v",
                "cache_pos_arr", "cross_k", "cross_v", "ssm_state",
                "rwkv_wkv", "rwkv_shift", "unknown")


def _batch_shapes(name):
    nd = {"tokens": 2, "labels": 2, "loss_mask": 2, "token": 2,
          "gold_ids": 1, "embeds": 3, "frames": 3, "embed": 3,
          "cache_k": 5, "cache_v": 5, "cache_pos_arr": 2, "cross_k": 5,
          "cross_v": 5, "ssm_state": 5, "rwkv_wkv": 5, "rwkv_shift": 3,
          "unknown": 2}[name]
    # every dim divisible by 32, then each dim in turn made odd, then a
    # head-dim-only split (dim 2 odd, dim 3 divisible)
    base = (32,) * nd
    yield base
    for d in range(nd):
        yield base[:d] + (7,) + base[d + 1:]
    if nd == 5:
        yield (4, 32, 25, 64, 16)
    yield ()


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_infer_batch_spec_every_name_equal_jax(mesh_id):
    mesh = MESHES[mesh_id]
    n = 0
    for name in _BATCH_NAMES:
        for shape in _batch_shapes(name):
            got = infer_batch_spec(name, shape, mesh)
            assert got == tuple(jsh.infer_batch_spec(name, shape, mesh)), (
                name, shape, got)
            n += 1
    assert n == 95


def test_uneven_head_fallbacks():
    s = infer_param_spec("['layers']['attn']['wq']", (28, 3584, 3584), MESH)
    assert s == P(None, None, "model")
    s = infer_param_spec("['layers']['attn']['wq']", (28, 3584, 1000), MESH)
    assert s == P(None, "model", None)
    s = infer_param_spec("['layers']['attn']['wq']", (28, 1000, 1000), MESH)
    assert s == P()


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_activation_resolver_equal_jax(mesh_id):
    mesh = MESHES[mesh_id]
    logicals = ("act_btd", "act_ff", "act_vocab", "act_heads",
                "act_kv_heads", "act_ssd", "act_experts", "other")
    shapes = [(32, 64, 128), (7, 64, 128), (32, 7, 130), (32, 64, 16, 64),
              (32, 64, 25, 64), (32, 1, 14, 64), (8, 32, 64, 16),
              (6, 7, 64, 130), (32, 16, 64, 25, 64), (32, 7, 64, 25, 16),
              (32, 64), (7,)]
    flags = [dict(attention_cp=cp, shard_heads_fallback=fb,
                  sequence_parallel=sp)
             for cp, fb, sp in itertools.product(
                 (False, True), ("compiler", "batch"), (False, True))]
    n = 0
    for fl in [None] + flags:
        cfg = None if fl is None else types.SimpleNamespace(**fl)
        mine = make_activation_resolver(mesh, cfg)
        theirs = jsh.make_activation_resolver(mesh, cfg)
        for logical, shape in itertools.product(logicals, shapes):
            a, b = mine(logical, shape), theirs(logical, shape)
            assert (a is None) == (b is None), (logical, shape, fl)
            if a is not None:
                assert a == tuple(b), (logical, shape, fl, a, b)
            n += 1
    assert n == 9 * len(logicals) * len(shapes)


def test_production_meshes_are_shape_only_here():
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names) == (
        {"data": 16, "model": 16}, ("data", "model"))
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_lib.make_ep_mesh(8).shape == {"data": 16, "expert": 8,
                                              "model": 2}
    assert mesh_lib.make_ep_mesh(40, multi_pod=True).shape == {
        "pod": 2, "data": 16, "expert": 8, "model": 2}
    assert mesh_lib.make_ep_mesh(3).shape == {"data": 16, "expert": 1,
                                              "model": 16}
    assert mesh_lib.make_elastic_mesh(48).shape == {"data": 3, "model": 16}
    assert mesh_lib.make_elastic_mesh(12, model_parallel=8).shape == {
        "data": 2, "model": 6}
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        single.materialize()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_elastic_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        param_shardings({"w": torch.zeros(4)}, multi)
    # the rules read a shape-only mesh as JAX's read its production mesh
    w = "['layers']['mlp']['w1']"
    assert infer_param_spec(w, (24, 896, 4864), multi) == tuple(
        jsh.infer_param_spec(w, (24, 896, 4864), MESH_MP))


def test_param_shardings_on_a_one_rank_gloo_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.exec import StepProgram, seed_parallel
    from repro_torch import zo
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_elastic_mesh(device="cpu")
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        params = bundle(all_archs()["qwen2-0.5b"].smoke_cfg).init(
            0, device="cpu")
        shard = param_shardings(params, mesh)
        for (path, leaf), (_, s) in zip(flatten_with_path(params),
                                        _spec_items(shard, params)):
            assert s.spec == infer_param_spec(path, tuple(leaf.shape), mesh)
            pl = s.placements
            assert len(pl) == 2
            for axis, p in zip(("data", "model"), pl):
                dims = [d for d, e in enumerate(s.spec)
                        if e == axis or (isinstance(e, tuple) and axis in e)]
                assert p == (Shard(dims[0]) if dims else Replicate())
            dt = distribute_tensor(leaf, mesh, pl)
            assert torch.equal(dt.to_local(), leaf)
            assert torch.equal(dt.full_tensor(), leaf)
        prog = StepProgram(zo.mezo(lr=1e-3), seed_parallel(2, mesh=mesh))
        batch = {"tokens": torch.zeros(4, 8, dtype=torch.int32)}
        ps, ss, bs = prog.shardings(params, batch, prog.init(params))
        assert bs["tokens"].spec == P("data")
        assert all(s.spec == P() for s in tree_leaves(ss))
        names = {"tokens": "tokens"}
        assert batch_shardings(batch, mesh, names)["tokens"].spec == \
            P("data", None)
        with pytest.raises(ValueError, match="carries no mesh"):
            StepProgram(zo.mezo(lr=1e-3)).shardings(params)
        from repro_torch.exec import local
        from repro_torch.train.adam import Adam, AdamConfig
        with pytest.raises(ValueError, match="without a mesh"):
            StepProgram(Adam(AdamConfig()), local(mesh=mesh)).step_fn(
                lambda p, b: 0.0)
    finally:
        dist.destroy_process_group()
