"""The sub-leaf zo_fused kernels K7–K10 — the port of
``repro.kernels.zo_fused.rows``: the affine kernels restricted to the
row-blocks that a ``rows(block=R, k=K)`` selection picks at a phase.

A leaf of n elements is cut into blocks of ``block_elems`` (= R · row
width) flat elements; element e is selected iff
``(e // block_elems) % k == phase``.  The kernels walk the SELECTED elements
only: compact index j ∈ [0, sel) maps to

    e = (phase + (j // block_elems) · k) · block_elems + j % block_elems

(bounded by n for a ragged last block), and z of element e is the counter
stream at e — so every selected value is bitwise what the whole-leaf kernel
writes there, and unselected elements are never read, generated or written.
JAX's 131 072-element tile plan, its gather of selected tiles and its
``dynamic_update_slice`` stitch were TPU BlockSpec artifacts and are not
carried over.

* K7 ``zo_affine_rows``: y = a·x + b·z(seed) on selected elements, in place
  (``out=x``); the plain version is K1's plain arithmetic gathered at the
  selected elements;
* K8 ``zo_affine_multi_rows``: a new (B, …) output, a_j·x + b_j·z_j on
  selected elements and x's bits elsewhere; the plain version is the stacked
  K7 singles;
* K9 ``zo_affine_chain_rows``: the K3 fold on selected elements, in place,
  cast through x's dtype between streams, at most ``MAX_STREAMS`` per
  launch; the plain version is the sequential K7 fold;
* K10 ``zo_sqnorm_rows_many``: Σ z² over the selected elements in f32, one
  norm per leaf, every partial rows leaf of a sphere pass in one call
  (``zo_sqnorm_rows``: one leaf), in the fixed two-pass order of K6 over
  the COMPACT index (tiles of ``TILE_ELEMS`` compact indices; column t of
  the (128, 1024) view of a tile summed top to bottom, the 1024 sums
  halved, the tile sums folded in order), which the plain version repeats
  op for op, so no bit of a norm depends on how leaves are grouped into
  calls.  JAX sums over flat-index tiles, so K10 meets
  ``zo_sqnorm_rows_ref`` within ``SQNORM_RTOL``.  The kernel maps compact
  to flat indices without a hardware division; ``_rows_leaf`` computes its
  constants here, where the CPU tests prove them.

K7 and K9 run one device function in K1's vector design: where a row-block
is a whole number of 16-byte vectors and the leaf starts on 16 bytes
(``rows_route`` → ``"vector"``), each thread takes N = 16 / itemsize
consecutive compact indices at a time — N consecutive flat elements inside
one block — and finds their block by a multiply-high divide by
``block_elems // N`` (``_vector_divide``); the indices past the last whole
vector, and every index of a launch on the ``"scalar"`` route, take one z
at a time.  Each launch is counted under its route.

Each wrapper takes the plain version for a CPU tensor and launches its CUDA
kernel (``csrc/zo_rows.cu``) for a CUDA one, or raises.  The kernels share
``csrc/zo_stream.cuh`` with K1 and K3–K6.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zo_fused.kernel import (_CHUNK, _MASK, DIST_CODES,
                                                 DTYPE_CODES, IDX_MUL,
                                                 MAX_STREAMS, SEED_MUL,
                                                 _check_dist, _check_leaf,
                                                 _f32, _f32_array, _fma,
                                                 _u32_array, z_from_counter)
from repro_torch.kernels.zo_fused.multi import (_PER_THREAD, _TILE_THREADS,
                                                TILE_ELEMS, _fold_f32,
                                                _streams)
# K10's tolerance is K6's: re-exported for the rows tests
from repro_torch.kernels.zo_fused.multi import SQNORM_RTOL as SQNORM_RTOL

#: K10's leaves per launch and uint32 fields per leaf (``ROWS_MAX_LEAVES``
#: and ``LEAF_FIELDS`` in csrc/zo_rows.cu)
ROWS_MAX_LEAVES = 64
_LEAF_FIELDS = 11


# --------------------------------------------------------------------------- #
# The plan: which elements, in which compact order
# --------------------------------------------------------------------------- #
def _plan(n: int, block_elems: int, k: int, phase: int) -> tuple:
    """Validated ``(n, be, k, phase)`` with ``be`` clamped to n (one block
    either way when be ≥ n, so the selection is unchanged)."""
    n, be, k, phase = int(n), int(block_elems), int(k), int(phase)
    if be < 1 or k < 1 or not 0 <= phase < k:
        raise ValueError(f"rows plan needs block_elems >= 1, k >= 1 and "
                         f"0 <= phase < k; got block_elems={be}, k={k}, "
                         f"phase={phase}")
    if n >= 1 << 32:
        # the reference's own rows kernels disagree with its plan there:
        # a tile's in-kernel mask forms the flat index in uint32, so past
        # 2^32 it selects by the wrapped index, and its sqnorm raises
        # (tests/test_torch_rows_past_2_32.py; ROADMAP Queue 3)
        raise ValueError(f"a {n}-element leaf exceeds the 2^32 counter "
                         "indices of the z stream: JAX's rows kernels mask "
                         "by the wrapped index there (a reference fault), "
                         "so rows plans refuse such a leaf")
    return n, min(be, max(n, 1)), k, phase


def selected_count(n: int, block_elems: int, k: int, phase: int) -> int:
    """Selected elements of an n-element leaf (the ragged last block counts
    its real elements only)."""
    n, be, k, phase = _plan(n, block_elems, k, phase)
    n_blocks = -(-n // be)
    if phase >= n_blocks:
        return 0
    count = len(range(phase, n_blocks, k)) * be
    if (n_blocks - 1 - phase) % k == 0:
        count -= n_blocks * be - n            # the last block is selected
    return count


def compact_to_flat(j: torch.Tensor, block_elems: int, k: int,
                    phase: int) -> torch.Tensor:
    """Flat element index of compact index ``j`` (int64 tensor)."""
    q = torch.div(j, block_elems, rounding_mode="floor")
    return (phase + q * k) * block_elems + (j - q * block_elems)


def _selected_or_raise(n: int, be: int, k: int, phase: int,
                       what: str) -> int:
    sel = selected_count(n, be, k, phase)
    if sel == 0:
        raise ValueError(
            f"{what}: the rows plan selects nothing of a {n}-element leaf "
            f"(block_elems={be}, k={k}, phase={phase}); the selection layer "
            "excludes such a leaf from the phase")
    return sel


# --------------------------------------------------------------------------- #
# Plain torch versions (the specification)
# --------------------------------------------------------------------------- #
def zo_affine_rows_plain(x: torch.Tensor, seed: int, a: float, b: float,
                         block_elems: int, k: int, phase: int,
                         dist: str = "gaussian",
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain K7: K1's y = fma(a, x, round(b·z)) at the selected elements,
    x's bits elsewhere.  ``out`` may be ``x`` (in place)."""
    _check_dist(dist)
    n, be, k, phase = _plan(x.numel(), block_elems, k, phase)
    sel = _selected_or_raise(n, be, k, phase, "zo_affine_rows")
    y = x.clone() if out is None else out
    if out is not None and y.data_ptr() != x.data_ptr():
        y.copy_(x)
    flat = x.reshape(-1)
    yflat = y.view(-1)
    a32 = torch.tensor(_f32(a), dtype=torch.float32, device=x.device)
    b32 = _f32(b)
    for lo in range(0, sel, _CHUNK):
        j = torch.arange(lo, min(lo + _CHUNK, sel), dtype=torch.int64,
                         device=x.device)
        e = compact_to_flat(j, be, k, phase)
        z = z_from_counter(e & _MASK, seed, dist)
        yflat[e] = _fma(a32, flat[e].to(torch.float32), z * b32).to(x.dtype)
    return y


def zo_affine_multi_rows_plain(x: torch.Tensor, seeds, a, b,
                               block_elems: int, k: int, phase: int,
                               dist: str = "gaussian") -> torch.Tensor:
    """Plain K8: the stacked K7 singles."""
    seeds, a, b = _streams(seeds, a, b)
    return torch.stack([
        zo_affine_rows_plain(x, s, aj, bj, block_elems, k, phase, dist)
        for s, aj, bj in zip(seeds, a, b)])


def zo_affine_chain_rows_plain(x: torch.Tensor, seeds, a, b,
                               block_elems: int, k: int, phase: int,
                               dist: str = "gaussian",
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain K9: the sequential K7 fold, each step written in x's dtype.
    ``out`` may be ``x``."""
    seeds, a, b = _streams(seeds, a, b)
    y = x.clone() if out is None else out
    if out is not None and y.data_ptr() != x.data_ptr():
        y.copy_(x)
    for s, aj, bj in zip(seeds, a, b):
        zo_affine_rows_plain(y, s, aj, bj, block_elems, k, phase, dist,
                             out=y)
    return y


def zo_sqnorm_rows_plain(n: int, seed: int, block_elems: int, k: int,
                         phase: int, dist: str = "gaussian",
                         device="cpu") -> torch.Tensor:
    """Plain K10 in the kernel's order (module docstring); a 0-d f32 tensor
    on ``device``."""
    _check_dist(dist)
    n, be, k, phase = _plan(n, block_elems, k, phase)
    sel = _selected_or_raise(n, be, k, phase, "zo_sqnorm_rows")
    tiles = -(-sel // TILE_ELEMS)
    group = max(1, _CHUNK // TILE_ELEMS)
    parts = []
    for t0 in range(0, tiles, group):
        t1 = min(tiles, t0 + group)
        lo, hi = t0 * TILE_ELEMS, t1 * TILE_ELEMS
        j = torch.arange(lo, min(hi, sel), dtype=torch.int64, device=device)
        z = z_from_counter(compact_to_flat(j, be, k, phase) & _MASK, seed,
                           dist)
        # indices at or past sel add +0, as in the kernel
        sq = torch.zeros(hi - lo, dtype=torch.float32, device=device)
        sq[:j.numel()] = z * z
        sq = sq.view(t1 - t0, _PER_THREAD, _TILE_THREADS)
        acc = torch.zeros(t1 - t0, _TILE_THREADS, dtype=torch.float32,
                          device=device)
        for q in range(_PER_THREAD):
            acc = acc + sq[:, q]
        h = _TILE_THREADS // 2
        while h:
            acc = acc[:, :h] + acc[:, h:2 * h]
            h //= 2
        parts.append(acc[:, 0])
    total = _fold_f32(torch.cat(parts).cpu().numpy())
    return torch.tensor(total, dtype=torch.float32, device=device)


def zo_sqnorm_rows_many_plain(ns, seeds, plans, dist: str = "gaussian",
                              device="cpu") -> torch.Tensor:
    """Plain K10 over several leaves: ``zo_sqnorm_rows_plain`` per leaf in a
    loop, an (L,) f32 tensor on ``device``."""
    ns, seeds, plans = _rows_leaf_list(ns, seeds, plans)
    return torch.stack([zo_sqnorm_rows_plain(n, s, be, k, ph, dist, device)
                        for n, s, (be, k, ph) in zip(ns, seeds, plans)])


def _rows_leaf_list(ns, seeds, plans) -> tuple:
    ns, seeds = [int(n) for n in ns], [int(s) for s in seeds]
    plans = [tuple(int(v) for v in p) for p in plans]
    if not ns or not len(ns) == len(seeds) == len(plans):
        raise ValueError(f"zo_sqnorm_rows_many needs one seed and one "
                         f"(block_elems, k, phase) plan per leaf and at least "
                         f"one leaf; got {len(ns)} sizes, {len(seeds)} seeds "
                         f"and {len(plans)} plans")
    return ns, seeds, plans


# --------------------------------------------------------------------------- #
# The compact -> flat index maps without a hardware division (K10, K7, K9)
# --------------------------------------------------------------------------- #
def divisor_magic(d: int) -> tuple:
    """``(mul, sh1, sh2)`` with ``q = (hi + ((j − hi) >> sh1)) >> sh2``,
    ``hi = (j · mul) >> 32``, equal to ``j // d`` for every 32-bit j
    (Granlund and Montgomery's round-up method for unsigned division by an
    invariant 1 ≤ d < 2^32: l = ⌈log2 d⌉, mul = ⌊2^32 (2^l − d) / d⌋ + 1 <
    2^32)."""
    d = int(d)
    if not 1 <= d < 1 << 32:
        raise ValueError(f"divisor {d} outside [1, 2^32)")
    lg = (d - 1).bit_length()
    mul = ((1 << 32) * ((1 << lg) - d)) // d + 1
    return mul, min(lg, 1), max(lg - 1, 0)


def _rows_leaf(n: int, seed: int, block_elems: int, k: int,
               phase: int) -> tuple:
    """The kernel's 11 uint32 fields for one leaf (``RowsLeaves`` in
    ``csrc/zo_rows.cu``): sel, key, be, mul, sh1 | sh2 << 8, phase·be, k·be,
    the carry threshold be − B, the carry step B, and the steps of
    e·IDX_MUL per 1 024 compact indices without and with a carry, where
    1024 = blocks·be + B, B < be; all mod 2^32."""
    n, be, k, phase = _plan(n, block_elems, k, phase)
    sel = _selected_or_raise(n, be, k, phase, "zo_sqnorm_rows")
    mul, sh1, sh2 = divisor_magic(be)
    blocks, rest = divmod(_TILE_THREADS, be)
    step0 = blocks * k * be + rest
    step1 = step0 + (k - 1) * be
    return tuple(v & _MASK for v in (
        sel, (int(seed) & _MASK) * SEED_MUL, be, mul, sh1 | sh2 << 8,
        phase * be, k * be, be - rest, rest, step0 * IDX_MUL,
        step1 * IDX_MUL))


# --------------------------------------------------------------------------- #
# K7's and K9's route and vector divide
# --------------------------------------------------------------------------- #
def rows_route(x: torch.Tensor, block_elems: int) -> str:
    """The route a K7 or K9 launch on leaf ``x`` (read and written in place)
    takes, by ``vector_route``'s rule in ``csrc/zo_rows.cu``: ``"vector"``
    when x starts on 16 bytes and a row-block (``block_elems`` clamped to
    the leaf) is a whole number of 16-byte vectors, ``"scalar"`` otherwise
    — every selected element then takes the scalar loop."""
    be = min(int(block_elems), max(x.numel(), 1))
    whole = be * x.element_size() % 16 == 0
    return "vector" if whole and x.data_ptr() % 16 == 0 else "scalar"


def _vector_divide(block_elems: int, itemsize: int) -> tuple:
    """K7's and K9's ``(mul, sh1 | sh2 << 8)``: ``divisor_magic`` of the
    vectors per row-block, ``block_elems // N`` with N = 16 / itemsize (1
    where a block holds no whole vector: the scalar route reads neither)."""
    mul, sh1, sh2 = divisor_magic(max(1, block_elems * itemsize // 16))
    return mul, sh1 | sh2 << 8


# --------------------------------------------------------------------------- #
# The CUDA kernels' wrappers
# --------------------------------------------------------------------------- #
def _lib():
    lib = _build.load("zo_rows")
    if not getattr(lib, "_typed", False):
        vp, i64, i, u32, f = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_uint32, ctypes.c_float)
        lib.zo_affine_rows.argtypes = [vp, vp, i64, i, u32, u32, u32, u32,
                                       u32, u32, f, f, i, vp]
        lib.zo_affine_chain_rows.argtypes = [vp, vp, i64, i, u32, u32, u32,
                                             u32, u32, vp, vp, vp, i, i, vp]
        lib.zo_affine_multi_rows.argtypes = [vp, vp, i64, i, u32, u32, u32,
                                             vp, vp, vp, i, i, vp]
        lib.zo_sqnorm_rows_many.argtypes = [vp, vp, vp, i, i, vp]
        lib.zo_rows_route.argtypes = [vp, vp, u32, i]
        for name in ("zo_affine_rows", "zo_affine_chain_rows",
                     "zo_affine_multi_rows", "zo_sqnorm_rows_many",
                     "zo_rows_route", "zo_rows_leaf_fields",
                     "zo_rows_max_leaves"):
            getattr(lib, name).restype = i
        if (lib.zo_rows_leaf_fields(), lib.zo_rows_max_leaves()) != (
                _LEAF_FIELDS, ROWS_MAX_LEAVES):
            raise RuntimeError("zo_rows: the kernel's leaf table does not "
                               "match _rows_leaf")
        lib._typed = True
    return lib


def _in_place_target(x: torch.Tensor, out: Optional[torch.Tensor],
                     what: str) -> torch.Tensor:
    """The tensor the kernel writes: ``out`` (holding x's bits first) or a
    copy of x — unselected elements keep x's bits either way."""
    if out is None:
        return x.clone()
    if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"{what}: out must match x in shape, dtype and "
                         "device")
    if x.device.type == "cuda" and not out.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes contiguous leaves")
    if out.data_ptr() != x.data_ptr():
        out.copy_(x)
    return out


def zo_affine_rows(x: torch.Tensor, seed: int, a: float, b: float,
                   block_elems: int, k: int, phase: int,
                   dist: str = "gaussian",
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 (port of ``zo_affine_2d_rows``): y = a·x + b·z(seed) on the
    selected elements, x's bits elsewhere; ``out=x`` writes in place and
    touches only the selected elements."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine_rows")
    if x.device.type == "cpu":
        return zo_affine_rows_plain(x, seed, a, b, block_elems, k, phase,
                                    dist, out)
    n, be, k, phase = _plan(x.numel(), block_elems, k, phase)
    sel = _selected_or_raise(n, be, k, phase, "zo_affine_rows")
    y = _in_place_target(x, out, "zo_affine_rows")
    lib = _lib()
    err = lib.zo_affine_rows(_build.ptr(y), _build.ptr(y), sel,
                             DTYPE_CODES[x.dtype], be, k, phase,
                             *_vector_divide(be, x.element_size()),
                             int(seed) & _MASK, _f32(a), _f32(b),
                             DIST_CODES[dist], _build.stream_of(x))
    _build.check(lib, err, "zo_affine_rows")
    _build.count("zo_affine_rows", rows_route(y, be))
    return y


def zo_affine_multi_rows(x: torch.Tensor, seeds, a, b, block_elems: int,
                         k: int, phase: int,
                         dist: str = "gaussian") -> torch.Tensor:
    """K8 (port of ``zo_affine_multi_2d_rows``): y[j] = a_j·x + b_j·z(seeds[j])
    on the selected elements and x's bits elsewhere, shape
    ``(len(seeds), *x.shape)``; x is read once, z generated only where
    selected."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine_multi_rows")
    seeds, a, b = _streams(seeds, a, b)
    if x.device.type == "cpu":
        return zo_affine_multi_rows_plain(x, seeds, a, b, block_elems, k,
                                          phase, dist)
    n, be, k, phase = _plan(x.numel(), block_elems, k, phase)
    _selected_or_raise(n, be, k, phase, "zo_affine_multi_rows")
    y = torch.empty((len(seeds),) + tuple(x.shape), dtype=x.dtype,
                    device=x.device)
    lib = _lib()
    for j0 in range(0, len(seeds), MAX_STREAMS):
        j1 = min(j0 + MAX_STREAMS, len(seeds))
        err = lib.zo_affine_multi_rows(
            _build.ptr(x), _build.ptr(y[j0]), n, DTYPE_CODES[x.dtype], be, k,
            phase, _u32_array(seeds[j0:j1]), _f32_array(a[j0:j1]),
            _f32_array(b[j0:j1]), j1 - j0, DIST_CODES[dist],
            _build.stream_of(x))
        _build.check(lib, err, "zo_affine_multi_rows")
        _build.count("zo_affine_multi_rows")
    return y


def zo_affine_chain_rows(x: torch.Tensor, seeds, a, b, block_elems: int,
                         k: int, phase: int, dist: str = "gaussian",
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9 (port of ``zo_affine_chain_2d_rows``): the B-stream fold on the
    selected elements in one read and one write of them; ``out=x`` writes
    in place.  Bitwise the sequential K7 fold; more than ``MAX_STREAMS``
    streams run as consecutive launches."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine_chain_rows")
    seeds, a, b = _streams(seeds, a, b)
    if x.device.type == "cpu":
        return zo_affine_chain_rows_plain(x, seeds, a, b, block_elems, k,
                                          phase, dist, out)
    n, be, k, phase = _plan(x.numel(), block_elems, k, phase)
    sel = _selected_or_raise(n, be, k, phase, "zo_affine_chain_rows")
    y = _in_place_target(x, out, "zo_affine_chain_rows")
    lib = _lib()
    divide, route = _vector_divide(be, x.element_size()), rows_route(y, be)
    for j0 in range(0, len(seeds), MAX_STREAMS):
        j1 = min(j0 + MAX_STREAMS, len(seeds))
        err = lib.zo_affine_chain_rows(
            _build.ptr(y), _build.ptr(y), sel, DTYPE_CODES[x.dtype], be, k,
            phase, *divide, _u32_array(seeds[j0:j1]), _f32_array(a[j0:j1]),
            _f32_array(b[j0:j1]), j1 - j0, DIST_CODES[dist],
            _build.stream_of(x))
        _build.check(lib, err, "zo_affine_chain_rows")
        _build.count("zo_affine_chain_rows", route)
    return y


def zo_sqnorm_rows_many(ns, seeds, plans, dist: str = "gaussian",
                        device="cpu") -> torch.Tensor:
    """K10 (port of ``zo_sqnorm_2d_rows``) over leaves of ``ns[l]`` elements
    with streams ``seeds[l]`` and rows plans ``plans[l] = (block_elems, k,
    phase)``: the (L,) f32 tensor of ‖z(seeds[l]) on the selected
    elements‖² on ``device`` — the plain version on the CPU; on the card
    one launch of the CUDA kernel per ``ROWS_MAX_LEAVES`` leaves (the tiles
    of every leaf in one grid, then one fold per leaf).  Each norm is
    bitwise what ``zo_sqnorm_rows`` gives for its leaf alone."""
    _check_dist(dist)
    dev = torch.device(device)
    if dev.type == "cpu":
        return zo_sqnorm_rows_many_plain(ns, seeds, plans, dist, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"zo_sqnorm_rows: no kernel for device {dev}")
    ns, seeds, plans = _rows_leaf_list(ns, seeds, plans)
    table = [_rows_leaf(n, s, *p) for n, s, p in zip(ns, seeds, plans)]
    tiles = sum(-(-row[0] // TILE_ELEMS) for row in table)
    partials = torch.empty(tiles, dtype=torch.float32, device=dev)
    out = torch.empty(len(ns), dtype=torch.float32, device=dev)
    lib = _lib()
    flat = [v for row in table for v in row]
    err = lib.zo_sqnorm_rows_many(
        _build.ptr(partials), _build.ptr(out),
        (ctypes.c_uint32 * len(flat))(*flat), len(ns), DIST_CODES[dist],
        _build.stream_of(out))
    _build.check(lib, err, "zo_sqnorm_rows")
    for _ in range(0, len(ns), ROWS_MAX_LEAVES):
        _build.count("zo_sqnorm_rows")
    return out


def zo_sqnorm_rows(n: int, seed: int, block_elems: int, k: int, phase: int,
                   dist: str = "gaussian", device="cpu") -> torch.Tensor:
    """K10 on one leaf: ‖z(seed) on the selected elements of an n-element
    leaf‖², a 0-d f32 tensor on ``device`` — ``zo_sqnorm_rows_many`` on one
    leaf."""
    return zo_sqnorm_rows_many([n], [seed], [(block_elems, k, phase)], dist,
                               device)[0]
