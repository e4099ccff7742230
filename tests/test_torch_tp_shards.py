"""The z kernels on a rank's shard of a leaf (tensor parallelism): K1, K3,
the fan-out K4 / K5, X1 (both threefry layouts) and X1's stacked streams
(``perturb_many``'s writes) on every rank's window of a leaf under
DTensor's ``Shard`` rule, each bitwise the same slice of the whole-leaf
write — the plain versions, which the CUDA shard routes are held to on the
card (``chip_smoke.py`` phase (tp)); and the sphere's ‖z‖² split over P
ranks (K6's tiles, X1's chunks), every rank's folded shares bitwise the
one-process norms.

Leaf kinds: a 1-D bias, the stacked (L, d, h) leaves cut on their column
(dim 2) and row (dim 1), an ``embed`` (V, d) and a ``head`` (d, V) cut on
their columns, over model axes of 2 and 4 (uneven sizes, so some shards are
short or empty); counters that cross 2³² inside a shard; and the launch
plan (``ShardMap.segments``) that cuts a shard into launches.  The window
helper is held to ``distribute_tensor``'s local shards in
``tests/test_torch_tensor_parallel.py``, on gloo ranks.

Also the dry run's two repairs that tensor parallelism shares its code
with: its record's memory keys (JAX's three) and the multi-pod mesh's
batch placed on one flattened mesh dim.
"""
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import _build
from repro_torch.kernels.threefry.kernel import zo_affine_threefry
from repro_torch.kernels.zo_fused import multi as km
from repro_torch.kernels.zo_fused.kernel import zo_affine, zo_affine_batched
from repro_torch.kernels.zo_fused.multi import (zo_affine_chain,
                                                zo_affine_multi)
from repro_torch.perturb import base
from repro_torch.perturb import xla as pxla
from repro_torch.perturb.xla import in_dtype

torch.set_num_threads(1)

#: (shape, sharded dim): a bias, the stacked column and row cuts, embed's
#: and head's column cuts
LEAVES = (((13,), 0), ((3, 10, 12), 2), ((3, 10, 12), 1), ((22, 10), 1),
          ((10, 22), 1))
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


#: the fan-outs' streams (B = 3): seeds, and per-stream (a, b) for K4
SEEDS3 = [5, 2**31 + 9, 77]
A3, B3 = [1.0, 0.5, 1.0], [1e-2, -3e-2, 2e-3]


def _windowed(x, shard, offset):
    # K1 / K4 / K5 take no offset: a window of a longer leaf is a shard map
    # whose start is the window's
    if not offset:
        return shard
    shard = shard or _build.ShardMap(x.numel(), x.numel(), 0)
    return shard._replace(start=shard.start + offset)


def _k1(x, shard=None, offset=0, total=None, dist="gaussian"):
    del total
    return zo_affine(x.clone(), 12345, 0.75, 1e-2, dist,
                     shard=_windowed(x, shard, offset))


def _k3(x, shard=None, offset=0, total=None, dist="gaussian"):
    del offset, total
    return zo_affine_chain(x.clone(), [5, 2**31 + 9], [0.5, 1.0],
                           [1e-2, -3e-2], dist, shard=shard)


def _k5(x, shard=None, offset=0, total=None, dist="gaussian"):
    del total
    return zo_affine_batched(x, SEEDS3, 0.75, 1e-2, dist,
                             shard=_windowed(x, shard, offset))


def _k4(x, shard=None, offset=0, total=None, dist="gaussian"):
    del offset, total
    return zo_affine_multi(x, SEEDS3, A3, B3, dist, shard=shard)


def _x1(partitionable):
    def run(x, shard=None, offset=0, total=None, dist="gaussian"):
        sc = [in_dtype(v, x.dtype) for v in (0.75, -1e-2, 1e-3)]
        return zo_affine_threefry(x, (7, 2**32 - 3), "restore", *sc, None,
                                  dist, out=torch.empty_like(x),
                                  offset=offset, total=total, shard=shard,
                                  partitionable=partitionable)
    return run


def _x1_stacked(x, shard=None, offset=0, total=None, dist="gaussian"):
    """X1's stacked streams as ``XLABackend.perturb_many`` writes them:
    stream j's ``xpbz`` from x into slice j of one stack."""
    out = torch.empty((3,) + tuple(x.shape), dtype=x.dtype)
    for j, key in enumerate(((7, 2**32 - 3), (1, 2), (2**31, 5))):
        zo_affine_threefry(x, key, "xpbz", 0.0, in_dtype(B3[j], x.dtype), 0.0,
                           None, dist, out=out[j], offset=offset, total=total,
                           shard=shard)
    return out


KERNELS = {"k1": _k1, "k3": _k3, "k4": _k4, "k5": _k5, "x1": _x1(True),
           "x1_original": _x1(False), "x1_stacked": _x1_stacked}


def _slice(whole, x, sl):
    """The window ``sl`` of x in ``whole`` (a fan-out's streams lead)."""
    return whole[(slice(None),) * (whole.dim() - x.dim()) + sl].contiguous()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_every_shard_is_the_slice_of_the_whole_write(kernel, dtype):
    fn = KERNELS[kernel]
    g = torch.Generator().manual_seed(3)
    for shape, dim in LEAVES:
        x = torch.randn(shape, generator=g).to(dtype)
        for dist in ("gaussian", "rademacher"):
            whole = fn(x, dist=dist)
            for n in (2, 4):
                for r in range(n):
                    sl, smap = _build.shard_window(shape, dim, n, r)
                    loc = x[sl].contiguous()
                    got = fn(loc, shard=smap, total=x.numel(), dist=dist)
                    assert torch.equal(got.view(-1).view(torch.uint8),
                                       _slice(whole, x, sl).view(-1).view(
                                           torch.uint8)), \
                        (kernel, dtype, shape, dim, n, r, dist)


@pytest.mark.parametrize("kernel", ["k1", "k5", "x1"])
def test_counters_crossing_2_32_inside_a_shard(kernel):
    """A leaf read as a window whose flat indices cross 2³² (K1's uint32
    counter wraps there, X1's threefry counter carries into its high
    word): each shard of the window is the slice of the window's write."""
    fn = KERNELS[kernel]
    off = 2**32 - 40
    x = torch.randn(8, 12, generator=torch.Generator().manual_seed(5))
    whole = fn(x, offset=off, total=off + x.numel())
    for r in range(4):
        sl, smap = _build.shard_window(x.shape, 1, 4, r)
        got = fn(x[sl].contiguous(), shard=smap, offset=off,
                 total=off + x.numel())
        assert torch.equal(got, _slice(whole, x, sl)), r


#: leaf lists for the norm's shares: K6's in elements (tiles of 2¹⁷), X1's
#: in elements under a chunk of 64 — a leaf shorter than one tile (chunk),
#: leaves that straddle shares, and a two-tile list that P = 3, 4 outrun
NORM_LISTS = {"k6": ([5, km.TILE_ELEMS + 9, 64], [3, 2**31 + 7, 11]),
              "k6_short": ([5, 7], [1, 2]),
              "x1": ([5, 200, 64, 130], None), "x1_short": ([5, 7], None)}


def _gathered(shares, per):
    return torch.cat([torch.cat([s, s.new_zeros(per - len(s))])
                      for s in shares])


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(NORM_LISTS))
def test_norm_shares_fold_to_the_one_process_norm(case, parts, monkeypatch):
    """The sphere's ‖z‖² split over ``parts`` ranks: each rank's share of
    the work list (K6's tiles, X1's chunks; ``_build.share_range``), the
    shares gathered in rank order and folded, is on every rank bitwise the
    one-process norm — for K6's plain version and for X1's chunk sums."""
    ns, seeds = NORM_LISTS[case]
    if case.startswith("k6"):
        whole = km.zo_sqnorm_many(ns, seeds)
        tiles = sum(-(-n // km.TILE_ELEMS) for n in ns)
        shares = [km.share_sums_plain(ns, seeds, "gaussian", "cpu",
                                      *_build.share_range(tiles, r, parts))
                  for r in range(parts)]
        every = _gathered(shares, -(-tiles // parts))
        for r in range(parts):
            def gather(mine, r=r):
                assert torch.equal(mine[:len(shares[r])], shares[r])
                return every
            got = km.zo_sqnorm_many(ns, seeds, share=(r, parts, gather))
            assert torch.equal(got, whole), (r, got, whole)
        return
    monkeypatch.setattr(pxla, "SQNORM_CHUNK", 64)
    g = torch.Generator().manual_seed(4)
    leaves = [(torch.randn(n, generator=g).to(dt), (i, 2**32 - 1 - i), bands)
              for i, (n, dt, bands) in enumerate(zip(
                  ns, (torch.float32, torch.bfloat16) * 2,
                  (None, [(3, 70), (100, 190)], None, None)))]
    want = [pxla.leaf_sqnorm(*leaf) for leaf in leaves]
    chunks = sum(len(pxla._chunks([(0, p.numel())] if b is None else b))
                 for p, _, b in leaves)
    per = -(-chunks // parts)
    shares = []
    for r in range(parts):
        def keep(mine):
            shares.append(mine)
            return torch.zeros(per * parts, dtype=torch.float64)
        pxla._shared_sqnorms(leaves, base.NormShare(r, parts, keep))
    every = torch.cat(shares)
    for r in range(parts):
        got = pxla._shared_sqnorms(leaves, base.NormShare(
            r, parts, lambda mine: every))
        assert [v.tobytes() for v in got] == [v.tobytes() for v in want], r


@pytest.mark.parametrize("rows,stride", [(6, 20), (40, 64), (1, 3)])
def test_shard_segments_cover_the_shard_in_order(rows, stride):
    """``ShardMap.segments`` cuts a shard into launches below the span —
    whole rows, or pieces of one row longer than the span — each launch's
    own map giving the same global indices as the shard's."""
    smap = _build.ShardMap(rows, stride, 7)
    n = rows * 5
    want = smap.index(0, n, "cpu")
    seen = 0
    for lo, ln, R, G, base in smap.segments(n, span=16):
        assert lo == seen and 0 < ln <= 16
        local = _build.ShardMap(R, G, base).index(0, ln, "cpu")
        assert torch.equal(local, want[lo:lo + ln])
        seen += ln
    assert seen == n
    assert smap.segments(0) == []


# --------------------------------------------------------------------------- #
# The dry run's record and its multi-pod placement
# --------------------------------------------------------------------------- #
def test_dryrun_record_carries_jax_memory_keys():
    """JAX's three ``memory_analysis`` keys: the argument bytes, the output
    bytes — θ, written in place and returned by the step, the only tensors
    it returns — and the temp bytes, the trace's peak above the arguments
    with logsumexp's ``exp(x − max)`` workspace live at its op."""
    from repro_torch.launch import dryrun
    from repro_torch.models import ShapeCell
    rec = dryrun.run_case("qwen2-0.5b", ShapeCell("t", 16, 2, "train"), None,
                          "single-1x1", {"n_layers": 2}, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    mem = rec["memory_analysis"]
    assert mem["output_size_in_bytes"] == mem["argument_bytes"]["params"]
    assert mem["argument_size_in_bytes"] == sum(
        mem["argument_bytes"].values())
    # the f32 logits (2 × 16 × padded vocab) are logsumexp's input
    workspace = 2 * 16 * 151936 * 4
    assert mem["temp_size_in_bytes"] >= mem["peak_bytes"] > 0
    assert mem["temp_size_in_bytes"] >= workspace


def test_multi_pod_batch_lies_on_one_flattened_dim():
    """On a (2, 2, 2) (pod, data, model) mesh the dry run places a batch over
    ('pod', 'data') on one flattened mesh dim: one ``Shard(0)``, no
    ``_StridedShard`` in the batch, θ or the traced step's loss."""
    from repro_torch.distributed.sharding import (BATCH_FLAT, batch_axes,
                                                  flatten_batch_axes)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShapeCell, all_archs, bundle
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    b = bundle(cfg)
    cell = ShapeCell("t", 16, 4, "train")
    with dryrun.fake_group(8):
        mesh = flatten_batch_axes(make_mesh((2, 2, 2),
                                            ("pod", "data", "model"),
                                            device="cpu"))
        assert tuple(mesh.mesh_dim_names) == (BATCH_FLAT, "model")
        assert batch_axes(mesh) == (BATCH_FLAT,)
        params, batch, _ = dryrun.place_case(cfg, b, cell, mesh)
        placements = [p for t in list(_leaves(params)) + list(
            _leaves(batch)) for p in t.placements]
        assert not any("Strided" in type(p).__name__ for p in placements)
        assert batch["tokens"].placements[0].is_shard(0)
        trace = dryrun.trace_case(cfg, b, cell, mesh,
                                  placed_args=(params, batch, {}))
    assert trace.flops > 0


def _leaves(tree):
    from repro_torch.tree_utils import tree_leaves
    return [t for t in tree_leaves(tree) if hasattr(t, "placements")]


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_products_are_the_einsums(dtype):
    """Attention's grouped products form a DTensor's (b, k) batch by a bmm
    (``models.attention._grouped_scores`` / ``_grouped_values``); on plain
    tensors they are the einsums bit for bit at every registry arch's
    heads, in a prefill and a one-query decode (the card checks this in
    phase (tp))."""
    from repro_torch.models import all_archs
    from repro_torch.models.attention import (_grouped_scores,
                                              _grouped_values)
    g = torch.Generator().manual_seed(5)
    heads = sorted({(a.cfg.n_heads, a.cfg.kv_heads, a.cfg.hd)
                    for a in all_archs().values() if a.cfg.n_heads})
    assert len(heads) >= 10
    for H, KV, hd in heads:
        for B, Q, S in ((2, 16, 16), (3, 1, 24)):
            q = torch.randn(B, Q, KV, H // KV, hd, generator=g).to(dtype)
            k, v = (torch.randn(B, S, KV, hd, generator=g).to(dtype)
                    for _ in range(2))
            s = torch.einsum("bqkgh,bskh->bkgqs", q, k)
            w = torch.softmax(s.float(), -1).to(dtype)
            o = torch.einsum("bkgqs,bskh->bqkgh", w, v)
            assert torch.equal(_grouped_scores(q, k), s)
            assert torch.equal(_grouped_values(w, v), o)
