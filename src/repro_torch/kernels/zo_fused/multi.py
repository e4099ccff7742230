"""The multi-seed zo_fused kernels — the port of
``repro.kernels.zo_fused.multi``:

* K4 ``zo_affine_multi`` (fan-out): y[j] = a_j·x + b_j·z(seed_j), stacked
  on a new leading axis; x read once for all B streams;
* K3 ``zo_affine_chain`` (chained): y = fold_j cast(a_j·y + b_j·z(seed_j)),
  one read and one write of x, in place allowed — the B-stream update chain
  of fzoo, the seed-group updates and batched replay;
* K6 ``zo_sqnorm_many``: ‖z(seed_l)[0:n_l]‖² as one f32 per leaf, every
  leaf of a sphere pass in one call — pass 1 of the sphere rescale, z never
  materialized (``zo_sqnorm``: one leaf).

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
                                                 fanout_route, plain_chunk,
                                                 z_from_counter,
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
                          dist: str = "gaussian") -> torch.Tensor:
    """Plain K4: the stacked K1 singles y[j] = zo_affine(x, seeds[j], a[j],
    b[j])."""
    seeds, a, b = _streams(seeds, a, b)
    return torch.stack([zo_affine_plain(x, s, aj, bj, dist)
                        for s, aj, bj in zip(seeds, a, b)])


def zo_affine_multi(x: torch.Tensor, seeds, a, b,
                    dist: str = "gaussian") -> torch.Tensor:
    """K4 (port of ``zo_affine_multi_2d``): y[j] = a_j·x + b_j·z(seeds[j]),
    shape ``(len(seeds), *x.shape)``, x read once; each launch is counted
    under its route (``fanout_route``)."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine_multi")
    seeds, a, b = _streams(seeds, a, b)
    if costs.active():
        costs.charge("zo_affine_multi", costs.zo_affine_fanout(
            _build.local(x).numel(), x.element_size(), len(seeds), dist))
    if _build.on_meta(x):
        return _build.empty_streams(x, len(seeds))
    if x.device.type == "cpu":
        return zo_affine_multi_plain(x, seeds, a, b, dist)
    y = torch.empty((len(seeds),) + tuple(x.shape), dtype=x.dtype,
                    device=x.device)
    if x.numel() == 0:
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
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain K3: the sequential K1 fold ``for j: y = zo_affine(y, seeds[j],
    a[j], b[j])``, each step written in x's dtype.  ``out`` may be x."""
    seeds, a, b = _streams(seeds, a, b)
    if out is None:
        y = x.clone()
    else:
        y = out
        if y.data_ptr() != x.data_ptr():
            y.copy_(x)
    for s, aj, bj in zip(seeds, a, b):
        zo_affine_plain(y, s, aj, bj, dist, out=y)
    return y


def zo_affine_chain(x: torch.Tensor, seeds, a, b, dist: str = "gaussian",
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 (port of ``zo_affine_chain_2d``): the B-stream fold in one read and
    one write of x; ``out=x`` writes in place.  Bitwise the sequential K1
    fold; more than ``MAX_STREAMS`` streams run as consecutive launches (a
    chain of chains is the same fold)."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine_chain")
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
        return zo_affine_chain_plain(x, seeds, a, b, dist, out)
    if out is not None and not out.is_contiguous():
        raise ValueError("zo_affine_chain: the CUDA kernel takes contiguous "
                         "leaves")
    y = torch.empty_like(x) if out is None else out
    if x.numel() == 0:
        return y
    lib = _multi_lib()
    src = x
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


def zo_sqnorm_plain(n: int, seed: int, dist: str = "gaussian",
                    device="cpu") -> torch.Tensor:
    """Plain K6 in the kernel's order (module docstring); a 0-d f32 tensor
    on ``device``."""
    _check_dist(dist)
    n = int(n)
    if n <= 0:
        raise ValueError(f"zo_sqnorm needs n >= 1, got {n}")
    tiles = -(-n // TILE_ELEMS)
    group = max(1, plain_chunk(device) // TILE_ELEMS)
    parts = []
    for t0 in range(0, tiles, group):
        t1 = min(tiles, t0 + group)
        idx = torch.arange(t0 * TILE_ELEMS, t1 * TILE_ELEMS,
                           dtype=torch.int64, device=device)
        z = z_from_counter(idx & _MASK, seed, dist)
        sq = torch.where(idx < n, z * z, torch.zeros_like(z))
        sq = sq.view(t1 - t0, _PER_THREAD, _TILE_THREADS)
        acc = torch.zeros(t1 - t0, _TILE_THREADS, dtype=torch.float32,
                          device=device)
        for k in range(_PER_THREAD):
            acc = acc + sq[:, k]
        h = _TILE_THREADS // 2
        while h:
            acc = acc[:, :h] + acc[:, h:2 * h]
            h //= 2
        parts.append(acc[:, 0])
    total = _fold_f32(torch.cat(parts).cpu().numpy())
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
        lib._typed = True
    return lib


def zo_sqnorm_many(ns, seeds, dist: str = "gaussian",
                   device="cpu") -> torch.Tensor:
    """K6 over leaves of ``ns[l]`` elements with streams ``seeds[l]``: the
    (L,) f32 tensor of ‖z(seeds[l])[0:ns[l]]‖² on ``device`` — the plain
    version on the CPU, one launch of the CUDA kernel (the tiles of every
    leaf in one grid, then one fold per leaf) on the card.  Each norm is
    bitwise what ``zo_sqnorm`` gives for its leaf alone."""
    _check_dist(dist)
    dev = torch.device(device)
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
    tiles = sum(-(-n // TILE_ELEMS) for n in ns)
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


def zo_sqnorm(n: int, seed: int, dist: str = "gaussian",
              device="cpu") -> torch.Tensor:
    """K6 (port of ``zo_sqnorm_2d``): ‖z(seed)[0:n]‖², a 0-d f32 tensor on
    ``device`` (the device of the leaf it measures) — ``zo_sqnorm_many`` on
    one leaf."""
    return zo_sqnorm_many([n], [seed], dist, device)[0]


