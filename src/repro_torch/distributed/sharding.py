"""Logical-axis sharding rules with divisibility fallbacks — the port of
``repro.distributed.sharding`` (MaxText-style; the rule table is plain
Python, kept verbatim).

Parameters are matched by path pattern to a *candidate dim order*; the first
candidate whose size divides the tensor-parallel axis is sharded, otherwise
the leaf is replicated.  One rule engine shards every registered
architecture on the production meshes with no bespoke code — uneven head
counts (25, 14, 28…) fall back from per-head to flattened-feature or
input-dim sharding automatically.

Conventions:
  * stacked block leaves have a leading 'layers' axis (never sharded);
  * 'model' (or 'expert'+'model' on the EP mesh) is tensor parallel;
  * 'data' (+ 'pod') shard the batch;
  * the KV-cache sequence axis shards over 'model' in decode.

What the port has in place of JAX's types:

* a spec is a ``PartitionSpec``: a tuple of entries, each ``None``, an axis
  name or a tuple of names, equal to ``tuple(jax_spec)`` for the same leaf;
  replicated is the empty spec, as ``P()`` is;
* a mesh is anything with ``shape`` (axis name → size) and ``axis_names``:
  a shape-only mesh (``launch.mesh``), a stand-in with those two
  attributes, or a ``torch.distributed`` ``DeviceMesh`` (read through its
  ``mesh_dim_names``);
* a sharding is a ``NamedSharding(mesh, spec)`` on a ``DeviceMesh``, whose
  ``placements`` are DTensor's: an entry on axis ``a`` is ``Shard(dim)`` on
  mesh dim ``a``, a tuple entry shards the same tensor dim on each of its
  mesh dims (in the mesh's dim order, which is the order of the tuple on
  every production mesh), and every other mesh dim is ``Replicate()``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import NamedTuple, Optional, Sequence

from repro_torch.tree_utils import (PyTree, flatten_with_path, tree_map,
                                    tree_unflatten)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s value: one entry per tensor dim
    (``None``, an axis name, or a tuple of axis names; a one-name tuple is
    the name itself, as JAX normalizes it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"

    def placements(self, device_mesh) -> tuple:
        """This spec's DTensor placements on ``device_mesh``
        (``spec_placements``)."""
        return spec_placements(self, device_mesh)


P = PartitionSpec


class MeshView(NamedTuple):
    """A ``DeviceMesh`` read as the rule engine reads a mesh."""
    shape: dict
    axis_names: tuple
    device_mesh: object


def as_mesh(mesh):
    """The mesh as the rules read it: a ``DeviceMesh`` becomes a
    ``MeshView`` over its ``mesh_dim_names``; anything else (a shape-only
    mesh, a stand-in with ``shape`` and ``axis_names``) is itself."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    sizes = tuple(mesh.mesh.shape)
    return MeshView(dict(zip(names, sizes)), tuple(names), mesh)


def device_mesh_of(mesh):
    """The materialized ``DeviceMesh`` behind ``mesh``; a shape-only mesh
    refuses (``materialize`` names the rank count it needs)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh
    dm = getattr(mesh, "device_mesh", None)
    if dm is not None:
        return dm
    materialize = getattr(mesh, "materialize", None)
    if materialize is not None:
        return materialize()
    raise TypeError(f"{type(mesh).__name__} is not a materialized mesh: "
                    "build one with repro_torch.launch.mesh over a started "
                    "process group")


# --------------------------------------------------------------------------- #
# Mesh-axis helpers
# --------------------------------------------------------------------------- #
#: the one mesh dim a batch over ('pod', 'data') is placed on
#: (``flatten_batch_axes``)
BATCH_FLAT = "pod_data"


def batch_axes(mesh) -> tuple:
    mesh = as_mesh(mesh)
    if BATCH_FLAT in mesh.axis_names:
        return (BATCH_FLAT,)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def flatten_batch_axes(device_mesh):
    """``device_mesh`` with its 'pod' and 'data' dims flattened into the
    one dim ``BATCH_FLAT`` (``DeviceMesh._flatten``), the others after it
    in order: a batch over both axes is then one ``Shard(0)`` where two
    would make DTensor carry ``_StridedShard`` placements through every
    op (and search its strategies over them).  The ranks and each one's
    place are unchanged; a mesh without both dims is itself."""
    import warnings
    names = tuple(device_mesh.mesh_dim_names)
    if "pod" not in names or "data" not in names:
        return device_mesh
    device_mesh["pod", "data"]._flatten(BATCH_FLAT)
    rest = tuple(n for n in names if n not in ("pod", "data"))
    with warnings.catch_warnings():
        # torch names slicing by a flattened dim as to be deprecated
        warnings.simplefilter("ignore", UserWarning)
        return device_mesh[(BATCH_FLAT,) + rest]


def tp_axes(mesh) -> tuple:
    mesh = as_mesh(mesh)
    return tuple(a for a in ("expert", "model")
                 if a in mesh.axis_names) or ("model",)


def axis_size(mesh, axes) -> int:
    mesh = as_mesh(mesh)
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


# --------------------------------------------------------------------------- #
# Parameter rules
# --------------------------------------------------------------------------- #
# (path regex, candidate shard dims counted from the END of the shape,
#  mesh axis group).  First divisible candidate wins; none -> replicated.
# Dims are negative indices so rules are agnostic to the stacked layer axis.
_PARAM_RULES: list[tuple[str, Sequence[int], str]] = [
    # embeddings: shard d_model (gathers stay shard-local); head: shard vocab
    (r"\['embed'\]$",               (-1,),      "tp"),
    (r"\['head'\]$",                (-1,),      "tp"),
    # attention: column-parallel qkv, row-parallel o (Megatron)
    (r"\['attn'\]\['w[qkv]'\]$",    (-1, -2),   "tp"),
    (r"\['attn'\]\['wo'\]$",        (-2,),      "tp"),
    (r"\['xattn'\]\['w[qkv]'\]$",   (-1, -2),   "tp"),
    (r"\['xattn'\]\['wo'\]$",       (-2,),      "tp"),
    (r"\['b[qkv]'\]$",              (-1,),      "tp"),
    # dense FFN: column w1/w3, row w2
    (r"\['mlp'\]\['w[13]'\]$",      (-1,),      "tp"),
    (r"\['mlp'\]\['w2'\]$",         (-2,),      "tp"),
    # MoE: experts on 'expert' axis when present/divisible, else ff dim on tp
    (r"\['moe'\]\['router'\]$",     (),         "tp"),
    (r"\['moe'\]\['w[13]'\]$",      (-3, -1),   "moe"),
    (r"\['moe'\]\['w2'\]$",         (-3, -2),   "moe"),
    # grouped expert layout (cfg.expert_groups > 1): each "eg{j}" sub-leaf
    # holds E/G experts on the same (-3) experts dim — same sharding rules
    (r"\['moe'\]\['eg\d+'\]\['w[13]'\]$", (-3, -1), "moe"),
    (r"\['moe'\]\['eg\d+'\]\['w2'\]$",    (-3, -2), "moe"),
    # Hymba SSM projections
    (r"\['ssm'\]\['in_proj'\]$",    (-1,),      "tp"),
    (r"\['ssm'\]\['out_proj'\]$",   (-2,),      "tp"),
    (r"\['ssm'\]\['[bc]_proj'\]$",  (-1,),      "tp"),
    # RWKV time/channel mix
    (r"\['tm'\]\['w[rkvg]'\]$",     (-1,),      "tp"),
    (r"\['tm'\]\['wo'\]$",          (-2,),      "tp"),
    (r"\['tm'\]\['w_lora_a'\]$",    (),         "tp"),
    (r"\['tm'\]\['w_lora_b'\]$",    (-1,),      "tp"),
    (r"\['cm'\]\['wk'\]$",          (-1,),      "tp"),
    (r"\['cm'\]\['wv'\]$",          (-2,),      "tp"),
    (r"\['cm'\]\['wr'\]$",          (-1,),      "tp"),
    # LoRA PEFT trees
    (r"\['w[qkvo]'\]\['a'\]$",      (),         "tp"),
    (r"\['w[qkvo]'\]\['b'\]$",      (-1,),      "tp"),
]


def _spec_with(shape: tuple, dim: int, axes) -> PartitionSpec:
    """PartitionSpec sharding ``dim`` (negative index) over ``axes``."""
    nd = len(shape)
    entries: list = [None] * nd
    entries[dim % nd] = axes
    return P(*entries)


def infer_param_spec(path: str, shape: tuple, mesh) -> PartitionSpec:
    """Rule-engine lookup with divisibility fallback."""
    mesh = as_mesh(mesh)
    if len(shape) == 0:
        return P()
    tp = tp_axes(mesh)
    has_expert = "expert" in mesh.axis_names
    for pattern, cands, group in _PARAM_RULES:
        if re.search(pattern, path):
            if group == "moe":
                # candidate -3 is the experts dim -> 'expert' axis if present;
                # candidate -1/-2 is the ff dim -> 'model'.
                for dim in cands:
                    is_expert_dim = (dim == -3)
                    if is_expert_dim and not has_expert:
                        continue
                    axes = ("expert",) if is_expert_dim else ("model",)
                    if len(shape) >= -dim and \
                            shape[dim] % axis_size(mesh, axes) == 0:
                        return _spec_with(shape, dim, axes)
                return P()
            axes = tp if group == "tp" else (group,)
            size = axis_size(mesh, axes)
            for dim in cands:
                if len(shape) >= -dim and shape[dim] % size == 0:
                    return _spec_with(shape, dim, axes)
            # fall back to 'model' only (smaller factor) on the EP mesh
            if len(axes) > 1:
                for dim in cands:
                    if len(shape) >= -dim and \
                            shape[dim] % mesh.shape["model"] == 0:
                        return _spec_with(shape, dim, "model")
            return P()
    return P()   # norms, scalars, anything unmatched: replicated


def param_specs(params: PyTree, mesh) -> PyTree:
    """One spec per leaf, by its ``keystr``-style path."""
    specs = [infer_param_spec(path, tuple(leaf.shape), mesh)
             for path, leaf in flatten_with_path(params)]
    return tree_unflatten(params, specs)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a materialized ``DeviceMesh``; ``placements`` are the
    DTensor placements ``distribute_tensor`` takes."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def spec_placements(spec, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(dim)`` on
    every mesh dim an entry names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis not in names:
                raise ValueError(f"spec {spec!r} names axis {axis!r}, which "
                                 f"the mesh {names} lacks")
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def param_shardings(params: PyTree, mesh) -> PyTree:
    """Each leaf's spec as a ``NamedSharding`` on the materialized mesh (a
    shape-only mesh refuses)."""
    dm = device_mesh_of(mesh)
    return tree_unflatten(params, [
        NamedSharding(dm, infer_param_spec(path, tuple(leaf.shape), dm))
        for path, leaf in flatten_with_path(params)])


def place(tree: PyTree, shardings: PyTree) -> PyTree:
    """``tree`` — held whole by every rank, as a JAX step's arguments are —
    as DTensors under ``shardings`` (``NamedSharding`` leaves of the same
    structure): each rank keeps its own shard, cut from its copy
    (``compute_local_shape_and_global_offset``), so nothing is sent.  A
    leaf that is not a tensor, or a 0-d one, rides along unplaced."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(x, sh):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        shape, offset = compute_local_shape_and_global_offset(
            x.shape, sh.mesh, sh.placements)
        local = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        return DTensor.from_local(local.contiguous(), sh.mesh,
                                  sh.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return tree_map(one, tree, shardings)


# --------------------------------------------------------------------------- #
# Batch / cache / state rules
# --------------------------------------------------------------------------- #
def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def infer_batch_spec(name: str, shape: tuple, mesh) -> PartitionSpec:
    """Input specs for step-function batches (tokens/labels/caches/states)."""
    mesh = as_mesh(mesh)
    ba = batch_axes(mesh)
    bsz = axis_size(mesh, ba)
    model = mesh.shape["model"]
    b_ax: object = ba if len(ba) > 1 else (ba[0] if ba else None)

    def batch_ok(dim_size):
        return _div(dim_size, bsz)

    if len(shape) == 0:
        return P()
    if name in ("tokens", "labels", "loss_mask", "token", "gold_ids"):
        return P(b_ax if batch_ok(shape[0]) else None,
                 *([None] * (len(shape) - 1)))
    if name in ("embeds", "frames", "embed"):
        return P(b_ax if batch_ok(shape[0]) else None, None, None)
    if name in ("cache_k", "cache_v"):
        # (L, B, cap, KV, hd): batch -> data, cache seq -> model (flash-decode)
        B, cap = shape[1], shape[2]
        return P(None, b_ax if batch_ok(B) else None,
                 "model" if _div(cap, model) else None, None, None)
    if name == "cache_pos_arr":
        return P(None, "model" if _div(shape[1], model) else None)
    if name == "cross_k" or name == "cross_v":
        return P(None, b_ax if batch_ok(shape[1]) else None,
                 "model" if _div(shape[2], model) else None, None, None)
    if name == "ssm_state":
        # (L, B, SH, hd, N): batch -> data; head-dim -> model if divisible
        return P(None, b_ax if batch_ok(shape[1]) else None,
                 "model" if _div(shape[2], model) else None,
                 "model" if not _div(shape[2], model)
                 and _div(shape[3], model) else None,
                 None)
    if name == "rwkv_wkv":
        # (L, B, H, hd, hd): shard key head_dim over model if heads don't divide
        return P(None, b_ax if batch_ok(shape[1]) else None,
                 "model" if _div(shape[2], model) else None,
                 "model" if not _div(shape[2], model)
                 and _div(shape[3], model) else None,
                 None)
    if name == "rwkv_shift":
        return P(None, b_ax if batch_ok(shape[1]) else None,
                 "model" if _div(shape[2], model) else None)
    return P()


def batch_shardings(batch_specs_tree: PyTree, mesh, names: PyTree) -> PyTree:
    """``infer_batch_spec`` of each leaf under its name, as shardings on the
    materialized mesh."""
    dm = device_mesh_of(mesh)
    return tree_map(
        lambda n, s: NamedSharding(dm, infer_batch_spec(n, tuple(s.shape),
                                                        dm)),
        names, batch_specs_tree)


# --------------------------------------------------------------------------- #
# Activation resolver (installed around forwards via models.common's
# shard_resolver)
# --------------------------------------------------------------------------- #
def make_activation_resolver(mesh, cfg=None):
    mesh = as_mesh(mesh)
    ba = batch_axes(mesh)
    b_ax: object = ba if len(ba) > 1 else (ba[0] if ba else None)
    bsz = axis_size(mesh, ba)
    model = mesh.shape["model"]
    has_expert = "expert" in mesh.axis_names
    heads_fallback = getattr(cfg, "shard_heads_fallback", "compiler")
    seq_parallel = getattr(cfg, "sequence_parallel", False)
    attention_cp = getattr(cfg, "attention_cp", False)

    def resolve(logical: str, shape: tuple) -> Optional[PartitionSpec]:
        def b0():
            return b_ax if _div(shape[0], bsz) else None
        if logical == "act_btd" and len(shape) == 3:
            if seq_parallel and _div(shape[1], model):
                return P(b0(), "model", None)
            return P(b0(), None, None)
        if logical == "act_ff" and len(shape) >= 2:
            return P(b0(), *([None] * (len(shape) - 2)),
                     "model" if _div(shape[-1], model) else None)
        if logical == "act_vocab" and len(shape) == 3:
            return P(b0(), None, "model" if _div(shape[-1], model) else None)
        if logical in ("act_heads", "act_kv_heads") and len(shape) == 4:
            # (B,S,H,hd): prefer head sharding; fallback per config — a
            # compiler's own choice can shard the contraction dim (hd) and
            # all-reduce the S×S scores
            if attention_cp and logical == "act_heads" \
                    and _div(shape[1], model) and shape[1] > 1:
                # context parallelism: q's sequence over 'model' (K/V stay
                # batch-local)
                return P(b0(), "model", None, None)
            if _div(shape[2], model):
                return P(b0(), None, "model", None)
            if heads_fallback == "batch":
                return P(b0(), None, None, None)
            if attention_cp and logical == "act_kv_heads":
                return P(b0(), None, None, None)
            return None
        if logical == "act_ssd" and len(shape) == 5:
            # (B, nc, C, SH, ·): chunk axis == sequence; shard over 'model'
            # under context parallelism (the SSD analogue of CP attention)
            if attention_cp and _div(shape[1], model):
                return P(b0(), "model", None, None, None)
            return P(b0(), None, None, None, None)
        if logical == "act_experts" and len(shape) == 4:
            # (E, G, C, d): experts -> expert/model axis; groups -> batch axes
            g_ax = b_ax if _div(shape[1], bsz) else None
            if has_expert and _div(shape[0], mesh.shape["expert"]):
                return P("expert", g_ax, None,
                         "model" if _div(shape[3], model) else None)
            if _div(shape[0], model):
                return P("model", g_ax, None, None)
            return P(None, g_ax, None, None)
        return None

    return resolve
