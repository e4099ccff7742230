"""Production mesh construction — the port of ``repro.launch.mesh``.

The factories are FUNCTIONS, so importing this module touches no device and
no process group.

Mesh axes:
  single-pod : (data=16, model=16)            — 256 ranks
  multi-pod  : (pod=2, data=16, model=16)     — 512 ranks
  EP         : ([pod=2,] data=16, expert=ep, model=16/ep)

'model' is the tensor-parallel axis; 'data' (and 'pod') carry pure data
parallelism.  Under MeZO the cross-replica traffic is the loss scalars.

JAX forces 512 host devices to build its production meshes; CUDA devices
cannot be faked.  So a mesh larger than the ranks present is a
``ShapeMesh``: it has the axis names and sizes that the rule engine
(``repro_torch.distributed.sharding``) and a dry run read, and it refuses to
materialize, naming the rank count it needs.  A mesh that fits the default
process group's world size is a ``torch.distributed`` ``DeviceMesh`` on the
caller's device.  No process group is started here: the caller starts one
(``torch.distributed.init_process_group``) and this module raises, saying
so, where a mesh needs one.
"""
from __future__ import annotations

import math

from repro_torch.device import DeviceSpec, resolve_device


class ShapeMesh:
    """A mesh's axis names and sizes, with no devices behind them."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape.values()))

    def materialize(self):
        raise RuntimeError(
            f"this {self.shape} mesh needs {self.size} ranks "
            f"(one device each) and the default process group has "
            f"{_world_size()}: it is shape-only (rule engine, dry run)")

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def _world_size() -> int:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size()


def _mesh(sizes: tuple, names: tuple, device: DeviceSpec):
    """A ``DeviceMesh`` over the default process group when ``sizes`` fits
    its world size, else the shape-only mesh."""
    n = int(math.prod(sizes))
    world = _world_size()
    if n > world:
        if world == 0 and n == 1:
            raise RuntimeError(
                "a mesh on the devices present needs a process group; start "
                "one first, e.g. torch.distributed.init_process_group("
                "'nccl' (or 'gloo' on the CPU), init_method='tcp://"
                "localhost:<port>' or store=FileStore(path), rank=0, "
                "world_size=1)")
        return ShapeMesh(dict(zip(names, sizes)))
    if n < world:
        raise ValueError(
            f"a {dict(zip(names, sizes))} mesh has {n} ranks but the default "
            f"process group has {world}: a mesh spans the whole group")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, sizes,
                            mesh_dim_names=names)


def make_mesh(shape: tuple, axis_names: tuple = ("data", "model"),
              device: DeviceSpec = None):
    """A mesh of ``shape`` over ``axis_names`` — ``jax.make_mesh``'s place
    (the dry run's ``--mesh-shape``): a ``DeviceMesh`` over the default
    process group when it has exactly that many ranks, else shape-only."""
    return _mesh(tuple(int(s) for s in shape), tuple(axis_names), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceSpec = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_elastic_mesh(n_devices: int | None = None,
                      model_parallel: int | None = None,
                      device: DeviceSpec = None):
    """Derive a mesh from the ranks alive (elastic scaling / degraded
    restart): the largest model axis that divides the rank count, capped at
    ``model_parallel`` (default 16).  ``n_devices`` defaults to the default
    process group's world size (which must exist)."""
    if n_devices is None:
        n_devices = _world_size()
        if n_devices == 0:
            raise RuntimeError(
                "make_elastic_mesh() counts the default process group's "
                "ranks, and none is started: call torch.distributed."
                "init_process_group first, or pass n_devices= for a "
                "shape-only mesh")
    n = int(n_devices)
    cap = model_parallel or 16
    model = 1
    for m in range(min(cap, n), 0, -1):
        if n % m == 0:
            model = m
            break
    return _mesh((n // model, model), ("data", "model"), device)


def make_ep_mesh(n_experts: int, *, multi_pod: bool = False,
                 device: DeviceSpec = None):
    """Expert-parallel refactorization of the production mesh: the 16
    'model' ways split into (expert, tp) with expert | n_experts.  The rank
    count is unchanged (256 / 512); only the logical factorization
    differs."""
    ep = 1
    for cand in (16, 8, 4, 2):
        if n_experts % cand == 0 and 16 % cand == 0:
            ep = cand
            break
    tp = 16 // ep
    if multi_pod:
        return _mesh((2, 16, ep, tp), ("pod", "data", "expert", "model"),
                     device)
    return _mesh((16, ep, tp), ("data", "expert", "model"), device)
