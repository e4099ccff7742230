"""The multi-seed zo_fused kernels — the port of
``repro.kernels.zo_fused.multi``:

* K4 ``zo_affine_multi`` (fan-out): y[j] = a_j·x + b_j·z(seed_j), stacked
  on a new leading axis; x read once for all B streams;
* K3 ``zo_affine_chain`` (chained): y = fold_j cast(a_j·y + b_j·z(seed_j)),
  one read and one write of x, in place allowed — the B-stream update chain
  of fzoo, the seed-group updates and batched replay;
* K6 ``zo_sqnorm_many``: ‖z(seed_l)[0:n_l]‖² as one f32 per leaf, every
  leaf of a sphere pass in one call — pass 1 of the sphere rescale, z never
  materialized (``zo_sqnorm``: one leaf); under tensor parallelism each
  rank sums its share of the tiles and the shares are gathered and folded
  (``share=``).

(K5, the fan-out with one shared (a, b), lives beside K1 in ``kernel.py``,
as ``zo_affine_2d_batched`` does in JAX.)

Each wrapper takes the plain version for a CPU tensor and launches its CUDA
kernel (``csrc/zo_multi.cu``, ``csrc/zo_sqnorm.cu``) for a CUDA one.  The
plain versions are the specification: K4 is the stacked K1 singles, K3 the
sequential K1 fold (each single writes x's dtype, the next reads it), so the
kernels — which share K1's z generator and affine combine — are bitwise
equal to them by construction.

K6's order of summation is fixed so kernel and plain agree bitwise (float
atomics would not): tiles of ``TILE_ELEMS`` = 256·512 elements (JAX's
tile); inside a tile, column t of the (128, 1024) view is summed top to
bottom in f32 starting from 0, then the 1024 column sums are halved
(s[t] += s[t+h] for h = 512 … 1); the tile sums are folded in tile order
in f32.  Elements at or past n add +0.  JAX sums a tile in the order XLA
picks, so K6 matches ``zo_sqnorm_ref`` within ``SQNORM_RTOL``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import costs
from repro_torch.kernels import _build
from repro_torch.kernels.zo_fused.kernel import (_MASK, DIST_CODES,
                                                 DTYPE_CODES, MAX_STREAMS,
                                                 _check_dist, _check_leaf,
                                                 _f32, _f32_array,
                                                 _multi_lib, _u32_array,
                                                 fanout_route,
                                                 launch_fanout_shard,
                                                 plain_chunk, z_from_counter,
                                                 zo_affine_plain)

TILE_ELEMS = 256 * 512               # TILE_ELEMS in csrc/zo_sqnorm.cu
_TILE_THREADS = 1024
_PER_THREAD = TILE_ELEMS // _TILE_THREADS
#: relative tolerance of K6 against JAX's ``zo_sqnorm_ref``: the two sum a
#: tile's 131 072 squares in different orders (f32, ~1e-7 per add, errors
#: of a pairwise-like order grow with log n)
SQNORM_RTOL = 1e-5


def _streams(seeds, a, b) -> tuple:
    seeds = [int(s) for s in seeds]
    a, b = list(a), list(b)
    if not seeds or not len(seeds) == len(a) == len(b):
        raise ValueError(f"need one a and one b per seed and at least one "
                         f"seed; got {len(seeds)} seeds, {len(a)} a, "
                         f"{len(b)} b")
    return seeds, [_f32(v) for v in a], [_f32(v) for v in b]


# --------------------------------------------------------------------------- #
# K4 fan-out
# --------------------------------------------------------------------------- #
def zo_affine_multi_plain(x: torch.Tensor, seeds, a, b,
                          dist: str = "gaussian",
                          shard: Optional[_build.ShardMap] = None
                          ) -> torch.Tensor:
    """Plain K4: the stacked K1 singles y[j] = zo_affine(x, seeds[j], a[j],
    b[j]) (on a rank's shard with ``shard``)."""
    seeds, a, b = _streams(seeds, a, b)
    return torch.stack([zo_affine_plain(x, s, aj, bj, dist, shard=shard)
                        for s, aj, bj in zip(seeds, a, b)])


def zo_affine_multi(x: torch.Tensor, seeds, a, b,
                    dist: str = "gaussian",
                    shard: Optional[_build.ShardMap] = None) -> torch.Tensor:
    """K4 (port of ``zo_affine_multi_2d``): y[j] = a_j·x + b_j·z(seeds[j]),
    shape ``(len(seeds), *x.shape)``, x read once; each launch is counted
    under its route (``fanout_route``).  ``shard`` makes x a rank's shard
    of a leaf (``_build.shard_map``), each slice bitwise that slice of the
    whole leaf's fan-out (the ``shard`` route); a live DTensor raises."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine_multi")
    _build.refuse_dtensor(x, "zo_affine_multi")
    seeds, a, b = _streams(seeds, a, b)
    if costs.active():
        costs.charge("zo_affine_multi", costs.zo_affine_fanout(
            _build.local(x).numel(), x.element_size(), len(seeds), dist))
    if _build.on_meta(x):
        return _build.empty_streams(x, len(seeds))
    if x.device.type == "cpu":
        return zo_affine_multi_plain(x, seeds, a, b, dist, shard)
    y = torch.empty((len(seeds),) + tuple(x.shape), dtype=x.dtype,
                    device=x.device)
    if x.numel() == 0:
        return y
    if shard is not None:
        launch_fanout_shard("zo_affine_multi", x, y, seeds, a, b, dist, shard)
        return y
    lib = _multi_lib()
    route = fanout_route(x, y)
    for j0 in range(0, len(seeds), MAX_STREAMS):
        j1 = min(j0 + MAX_STREAMS, len(seeds))
        err = lib.zo_affine_multi(
            _build.ptr(x), _build.ptr(y[j0]), x.numel(), DTYPE_CODES[x.dtype],
            _u32_array(seeds[j0:j1]), _f32_array(a[j0:j1]),
            _f32_array(b[j0:j1]), j1 - j0, DIST_CODES[dist],
            _build.stream_of(x))
        _build.check(lib, err, "zo_affine_multi")
        _build.count("zo_affine_multi", route)
    return y


# --------------------------------------------------------------------------- #
# K3 chain
# --------------------------------------------------------------------------- #
def zo_affine_chain_plain(x: torch.Tensor, seeds, a, b,
                          dist: str = "gaussian",
                          out: Optional[torch.Tensor] = None,
                          shard: Optional[_build.ShardMap] = None
                          ) -> torch.Tensor:
    """Plain K3: the sequential K1 fold ``for j: y = zo_affine(y, seeds[j],
    a[j], b[j])``, each step written in x's dtype.  ``out`` may be x;
    ``shard`` makes x a rank's shard (K1's map)."""
    seeds, a, b = _streams(seeds, a, b)
    if out is None:
        y = x.clone()
    else:
        y = out
        if y.data_ptr() != x.data_ptr():
            y.copy_(x)
    for s, aj, bj in zip(seeds, a, b):
        zo_affine_plain(y, s, aj, bj, dist, out=y, shard=shard)
    return y


def zo_affine_chain(x: torch.Tensor, seeds, a, b, dist: str = "gaussian",
                    out: Optional[torch.Tensor] = None,
                    shard: Optional[_build.ShardMap] = None) -> torch.Tensor:
    """K3 (port of ``zo_affine_chain_2d``): the B-stream fold in one read and
    one write of x; ``out=x`` writes in place.  Bitwise the sequential K1
    fold; more than ``MAX_STREAMS`` streams run as consecutive launches (a
    chain of chains is the same fold).  ``shard`` makes x a rank's shard
    of a leaf (``_build.shard_map``; the ``shard`` route on the card),
    bitwise the slice of the whole leaf's chain; a live DTensor raises."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine_chain")
    _build.refuse_dtensor(x, "zo_affine_chain")
    seeds, a, b = _streams(seeds, a, b)
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("zo_affine_chain: out must match x in shape, dtype "
                         "and device")
    if costs.active():
        costs.charge("zo_affine_chain", costs.zo_affine_chain(
            _build.local(x).numel(), x.element_size(), len(seeds), dist))
    if _build.on_meta(x):
        return torch.empty_like(x) if out is None else out
    if x.device.type == "cpu":
        return zo_affine_chain_plain(x, seeds, a, b, dist, out, shard)
    if out is not None and not out.is_contiguous():
        raise ValueError("zo_affine_chain: the CUDA kernel takes contiguous "
                         "leaves")
    y = torch.empty_like(x) if out is None else out
    if x.numel() == 0:
        return y
    lib = _multi_lib()
    src = x
    if shard is not None:
        size = x.element_size()
        for j0 in range(0, len(seeds), MAX_STREAMS):
            j1 = min(j0 + MAX_STREAMS, len(seeds))
            for lo, n, R, G, base in shard.segments(x.numel()):
                err = lib.zo_affine_chain_shard(
                    src.data_ptr() + lo * size, y.data_ptr() + lo * size, n,
                    DTYPE_CODES[x.dtype], _u32_array(seeds[j0:j1]),
                    _f32_array(a[j0:j1]), _f32_array(b[j0:j1]), j1 - j0,
                    DIST_CODES[dist], R, G & _MASK, base & _MASK,
                    _build.stream_of(x))
                _build.check(lib, err, "zo_affine_chain")
            _build.count("zo_affine_chain", "shard")
            src = y
        return y
    for j0 in range(0, len(seeds), MAX_STREAMS):
        j1 = min(j0 + MAX_STREAMS, len(seeds))
        err = lib.zo_affine_chain(
            _build.ptr(src), _build.ptr(y), x.numel(), DTYPE_CODES[x.dtype],
            _u32_array(seeds[j0:j1]), _f32_array(a[j0:j1]),
            _f32_array(b[j0:j1]), j1 - j0, DIST_CODES[dist],
            _build.stream_of(x))
        _build.check(lib, err, "zo_affine_chain")
        _build.count("zo_affine_chain")
        src = y
    return y


# --------------------------------------------------------------------------- #
# K6 sqnorm
# --------------------------------------------------------------------------- #
def _fold_f32(values: np.ndarray) -> np.float32:
    acc = np.float32(values[0])
    for v in values[1:]:
        acc = np.float32(acc + np.float32(v))
    return acc


def _tile_sums_plain(n: int, seed: int, dist: str, device, t0: int,
                     t1: int) -> torch.Tensor:
    """Plain K6's sums of a leaf's tiles [t0, t1) in the kernel's order
    (module docstring): a (t1 − t0,) f32 tensor on ``device``.  In the
    leaf's last tile the rows of the (128, 1024) view at or past n only
    add +0 to a non-negative sum, so they are not generated."""
    group = max(1, plain_chunk(device) // TILE_ELEMS)
    parts = [torch.zeros(0, dtype=torch.float32, device=device)]
    for g0 in range(t0, t1, group):
        g1 = min(t1, g0 + group)
        # a group of one tile (the leaf's last may be partial): only the
        # rows of its view that hold elements below n
        rows = min(_PER_THREAD, -(-(n - g0 * TILE_ELEMS) // _TILE_THREADS)) \
            if g1 - g0 == 1 else _PER_THREAD
        idx = (torch.arange(0, rows * _TILE_THREADS, dtype=torch.int64,
                            device=device)
               + torch.arange(g0, g1, dtype=torch.int64,
                              device=device)[:, None] * TILE_ELEMS)
        z = z_from_counter(idx & _MASK, seed, dist)
        sq = torch.where(idx < n, z * z, torch.zeros_like(z))
        sq = sq.view(g1 - g0, rows, _TILE_THREADS)
        acc = torch.zeros(g1 - g0, _TILE_THREADS, dtype=torch.float32,
                          device=device)
        for k in range(rows):
            acc = acc + sq[:, k]
        h = _TILE_THREADS // 2
        while h:
            acc = acc[:, :h] + acc[:, h:2 * h]
            h //= 2
        parts.append(acc[:, 0])
    return torch.cat(parts)


def _tiles(n: int) -> int:
    return -(-int(n) // TILE_ELEMS)


def zo_sqnorm_plain(n: int, seed: int, dist: str = "gaussian",
                    device="cpu") -> torch.Tensor:
    """Plain K6 in the kernel's order (module docstring); a 0-d f32 tensor
    on ``device``."""
    _check_dist(dist)
    n = int(n)
    if n <= 0:
        raise ValueError(f"zo_sqnorm needs n >= 1, got {n}")
    total = _fold_f32(_tile_sums_plain(n, seed, dist, device, 0,
                                       _tiles(n)).cpu().numpy())
    return torch.tensor(total, dtype=torch.float32, device=device)


def zo_sqnorm_many_plain(ns, seeds, dist: str = "gaussian",
                         device="cpu") -> torch.Tensor:
    """Plain K6 over several leaves: ``zo_sqnorm_plain`` per leaf in a loop,
    an (L,) f32 tensor on ``device``."""
    ns, seeds = _leaf_list(ns, seeds)
    return torch.stack([zo_sqnorm_plain(n, s, dist, device)
                        for n, s in zip(ns, seeds)])


def _leaf_list(ns, seeds) -> tuple:
    ns, seeds = [int(n) for n in ns], [int(s) for s in seeds]
    if not ns or len(ns) != len(seeds):
        raise ValueError(f"zo_sqnorm_many needs one seed per leaf and at "
                         f"least one leaf, got {len(ns)} sizes and "
                         f"{len(seeds)} seeds")
    if min(ns) <= 0:
        raise ValueError(f"zo_sqnorm needs n >= 1, got {min(ns)}")
    return ns, seeds


def _sqnorm_lib():
    lib = _build.load("zo_sqnorm")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.zo_sqnorm_many.argtypes = [vp, vp, vp, vp, ctypes.c_int,
                                       ctypes.c_int, vp]
        lib.zo_sqnorm_many.restype = ctypes.c_int
        lib.zo_sqnorm_share.argtypes = [vp, vp, vp, ctypes.c_int,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int, vp]
        lib.zo_sqnorm_share.restype = ctypes.c_int
        lib.zo_sqnorm_fold.argtypes = [vp, vp, vp, ctypes.c_int, vp]
        lib.zo_sqnorm_fold.restype = ctypes.c_int
        lib._typed = True
    return lib


def zo_sqnorm_many(ns, seeds, dist: str = "gaussian", device="cpu",
                   share=None) -> torch.Tensor:
    """K6 over leaves of ``ns[l]`` elements with streams ``seeds[l]``: the
    (L,) f32 tensor of ‖z(seeds[l])[0:ns[l]]‖² on ``device`` — the plain
    version on the CPU, one launch of the CUDA kernel (the tiles of every
    leaf in one grid, then one fold per leaf) on the card.  Each norm is
    bitwise what ``zo_sqnorm`` gives for its leaf alone.

    ``share`` = ``(rank, parts, gather)`` splits the work over ``parts``
    ranks (tensor parallelism, ``perturb.base.norm_share``): this rank sums
    its share of the flat tile list (``_build.share_range``; the ``share``
    route on the card), ``gather`` all-gathers the shares' partials in
    rank order, and every leaf's partials are folded in tile order — the
    one-process norms bit for bit, with 1/parts of the z work a rank."""
    _check_dist(dist)
    dev = torch.device(device)
    if share is not None:
        return _sqnorm_shared(ns, seeds, dist, dev, *share)
    if costs.active():
        costs.charge("zo_sqnorm", costs.total(
            costs.zo_sqnorm(int(n), dist) for n in ns))
    if dev.type == "meta":
        _leaf_list(ns, seeds)
        return torch.empty(len(ns), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return zo_sqnorm_many_plain(ns, seeds, dist, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"zo_sqnorm: no kernel for device {dev}")
    ns, seeds = _leaf_list(ns, seeds)
    tiles = sum(_tiles(n) for n in ns)
    partials = torch.empty(tiles, dtype=torch.float32, device=dev)
    out = torch.empty(len(ns), dtype=torch.float32, device=dev)
    lib = _sqnorm_lib()
    err = lib.zo_sqnorm_many(
        _build.ptr(partials), _build.ptr(out),
        (ctypes.c_int64 * len(ns))(*ns), _u32_array(seeds), len(ns),
        DIST_CODES[dist], _build.stream_of(out))
    _build.check(lib, err, "zo_sqnorm")
    _build.count("zo_sqnorm")
    return out


def _share_elems(ns, lo: int, hi: int) -> int:
    """Elements (below each leaf's n) in flat tiles [lo, hi) of ``ns``."""
    total, first = 0, 0
    for n in ns:
        a, b = max(lo, first), min(hi, first + _tiles(n))
        if a < b:
            total += min(n, (b - first) * TILE_ELEMS) - (a - first) * TILE_ELEMS
        first += _tiles(n)
    return total


def share_sums_plain(ns, seeds, dist: str, device, lo: int,
                     hi: int) -> torch.Tensor:
    """Plain K6's sums of flat tiles [lo, hi) of the leaves' list (each
    leaf's tiles in order, leaf after leaf): a (hi − lo,) f32 tensor."""
    parts, first = [torch.zeros(0, dtype=torch.float32, device=device)], 0
    for n, seed in zip(ns, seeds):
        a, b = max(lo, first), min(hi, first + _tiles(n))
        if a < b:
            parts.append(_tile_sums_plain(n, seed, dist, device, a - first,
                                          b - first))
        first += _tiles(n)
    return torch.cat(parts)


def fold_plain(ns, partials: torch.Tensor, device) -> torch.Tensor:
    """Plain K6's fold: each leaf's tile partials (the flat list's first
    Σ tiles entries) folded in tile order in f32, an (L,) tensor."""
    host, out, first = partials.cpu().numpy(), [], 0
    for n in ns:
        out.append(_fold_f32(host[first:first + _tiles(n)]))
        first += _tiles(n)
    return torch.tensor(np.array(out, np.float32), device=device)


def _sqnorm_shared(ns, seeds, dist: str, dev, rank: int, parts: int,
                   gather) -> torch.Tensor:
    ns, seeds = _leaf_list(ns, seeds)
    tiles = sum(_tiles(n) for n in ns)
    lo, hi = _build.share_range(tiles, rank, parts)
    if costs.active():
        costs.charge("zo_sqnorm", costs.zo_sqnorm(_share_elems(ns, lo, hi),
                                                  dist))
    mine = torch.zeros(-(-tiles // parts), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        mine[:hi - lo] = share_sums_plain(ns, seeds, dist, dev, lo, hi)
    elif dev.type == "cuda":
        lib = _sqnorm_lib()
        _build.check(lib, lib.zo_sqnorm_share(
            _build.ptr(mine), (ctypes.c_int64 * len(ns))(*ns),
            _u32_array(seeds), len(ns), lo, hi, DIST_CODES[dist],
            _build.stream_of(mine)), "zo_sqnorm")
    elif dev.type != "meta":
        raise RuntimeError(f"zo_sqnorm: no kernel for device {dev}")
    every = gather(mine)
    if dev.type == "meta":
        return torch.empty(len(ns), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return fold_plain(ns, every, dev)
    out = torch.empty(len(ns), dtype=torch.float32, device=dev)
    lib = _sqnorm_lib()
    _build.check(lib, lib.zo_sqnorm_fold(
        _build.ptr(every), _build.ptr(out), (ctypes.c_int64 * len(ns))(*ns),
        len(ns), _build.stream_of(out)), "zo_sqnorm")
    _build.count("zo_sqnorm", "share")
    return out


def zo_sqnorm(n: int, seed: int, dist: str = "gaussian",
              device="cpu") -> torch.Tensor:
    """K6 (port of ``zo_sqnorm_2d``): ‖z(seed)[0:n]‖², a 0-d f32 tensor on
    ``device`` (the device of the leaf it measures) — ``zo_sqnorm_many`` on
    one leaf."""
    return zo_sqnorm_many([n], [seed], dist, device)[0]


