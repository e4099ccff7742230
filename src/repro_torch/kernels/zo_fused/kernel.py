"""K1 ``zo_affine``: y = a·x + b·z(seed, flat index) — the port of
``repro.kernels.zo_fused.kernel.zo_affine_2d`` (and its oracle ``ref.py``).

z is regenerated, never stored: a murmur3-finalized counter hash of (seed,
flat element index) feeds a transcendental-free Box–Muller (polynomial log
and cos), or the sign of one stream for ``rademacher``.  The stream is
specified to the bit, and this module reproduces JAX's bits exactly:

* every float op is separately rounded f32 **except** the multiply-adds that
  XLA:CPU contracts into fused multiply-adds in the reference graphs — each
  Horner step of ``_det_log`` and ``_det_cos2pi``, the final
  ``fma(e, LN2, log_m)``, and the affine combine ``fma(a, x, round(b·z))``;
* the plain torch version writes those FMAs as an *exact* emulation
  (``_fma``: exact f64 product, TwoSum error term, round-to-odd, one cast to
  f32 — Boldo–Melquiond), so it agrees with ``__fmaf_rn`` on every element,
  not just on most.

``zo_affine`` (K1) and ``zo_affine_batched`` (K5, the B-stream fan-out
with one shared (a, b)) are the entry points: a CPU tensor takes the plain
version (chunked so temporaries stay small), a CUDA tensor launches the
hand-written kernel (``csrc/zo_affine.cu``, ``csrc/zo_multi.cu``) or raises.
The counter is the flat index of the unpadded leaf as uint32, so no
blocked/padded view is needed.  The other multi-seed kernels (K3, K4, K6)
are in ``multi.py``; all of them share one z generator
(``csrc/zo_stream.cuh``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import costs
from repro_torch.kernels import _build

_MASK = 0xFFFFFFFF
_CHUNK = 1 << 20                        # plain-version elements per pass
_CHUNK_CUDA = 1 << 24                   # ... when it runs on the card
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DIST_CODES = {"gaussian": 0, "rademacher": 1}
#: streams per launch of the multi-seed kernels (ZO_MAX_STREAMS in
#: ``csrc/zo_multi.cu``); a longer list is split into consecutive launches
MAX_STREAMS = 64
#: the counter hash's multipliers of the flat index and of the seed
#: (IDX_MUL, SEED_MUL in ``csrc/zo_stream.cuh``)
IDX_MUL, SEED_MUL = 0x9E3779B1, 0x7FEB352D


def _f32(v) -> float:
    """Python float holding exactly ``np.float32(v)``."""
    return float(np.float32(v))


_C_LOG = tuple(_f32(c) for c in (1.0 / 13.0, 1.0 / 11.0, 1.0 / 9.0,
                                  1.0 / 7.0, 1.0 / 5.0, 1.0 / 3.0, 1.0))
_LN2 = _f32(0.6931471805599453)
_PI_2 = _f32(np.pi / 2)
_COS = tuple(_f32(c) for c in (
    -1.0 / 87178291200.0, 1.0 / 479001600.0, -1.0 / 3628800.0,
    1.0 / 40320.0, -1.0 / 720.0, 1.0 / 24.0, -1.0 / 2.0, 1.0))
_SIN = tuple(_f32(c) for c in (
    1.0 / 6227020800.0, -1.0 / 39916800.0, 1.0 / 362880.0, -1.0 / 5040.0,
    1.0 / 120.0, -1.0 / 6.0, 1.0))


# --------------------------------------------------------------------------- #
# Plain torch version (bitwise specification)
# --------------------------------------------------------------------------- #
def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for int64 ``h`` in [0, 2³²) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


def _murmur_mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def counter_uniform(idx: torch.Tensor, seed: int, salt: int) -> torch.Tensor:
    """uint32 counter (int64 tensor) + seed + salt -> f32 uniform in (0, 1)."""
    h = _mul_u32(idx, IDX_MUL)
    h = h ^ ((seed * SEED_MUL) & _MASK)
    h = (h + ((salt * 0x846CA68B) & _MASK)) & _MASK
    h = _murmur_mix(h)
    u = (h >> 8).to(torch.float32)                 # exact: < 2**24
    return u * (1.0 / 16777216.0) + (0.5 / 16777216.0)


def _fma(a, b, c) -> torch.Tensor:
    """Exactly rounded f32 fused multiply-add of f32 operands.

    The f64 product of two f32 values is exact; TwoSum gives the exact error
    of the f64 sum; rounding that sum to odd and then once to f32 is a
    correct single rounding (53 ≥ 2·24 + 2 bits)."""
    return _fma_odd(a, b, c).to(torch.float32)


def _fma_odd(a, b, c) -> torch.Tensor:
    """a·b + c of f32 (or narrower) operands rounded to odd in f64: exact
    product, TwoSum, and the last bit set where the f64 sum is inexact."""
    p = a.double() * b.double()
    cd = c.double() if isinstance(c, torch.Tensor) else c
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    odd_fix = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(odd_fix, bits + step, bits)
    return bits.view(torch.float64)


def _sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt of non-negative f32 ``t``.

    ``torch.sqrt`` on the CPU is a vectorized approximation that misses the
    correct rounding on ~0.7 % of inputs; XLA's ``vsqrtps`` and CUDA's
    ``__fsqrt_rn`` do not.  So take the nearest f32 candidate and move it one
    ulp if ``t`` lies beyond a rounding midpoint — each midpoint has 25
    significant bits, so its square is exact in f64 and so is the test."""
    r = torch.sqrt(t.double()).to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.zeros_like(r))
    td, rd = t.double(), r.double()
    mid_hi = (rd + up.double()) * 0.5
    mid_lo = (rd + dn.double()) * 0.5
    return torch.where(td > mid_hi * mid_hi, up,
                       torch.where(td < mid_lo * mid_lo, dn, r))


def _det_log(u: torch.Tensor) -> torch.Tensor:
    bits = u.view(torch.int32).to(torch.int64) & _MASK
    e = ((bits >> 23) - 127).to(torch.float32)                   # exact
    m = ((bits & 0x007FFFFF) | 0x3F800000).to(torch.int32).view(torch.float32)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = torch.full_like(s, _C_LOG[0])
    for c in _C_LOG[1:]:
        p = _fma(p, s2, c)
    log_m = 2.0 * (s * p)
    return _fma(e, torch.full_like(e, _LN2), log_m)


def _det_cos2pi(t: torch.Tensor) -> torch.Tensor:
    t4 = t * 4.0                                   # exact
    k = torch.floor(t4)                            # exact
    f = t4 - k                                     # exact
    phi = f * _PI_2
    p2 = phi * phi
    c = torch.full_like(p2, _COS[0])
    for coef in _COS[1:]:
        c = _fma(c, p2, coef)
    s = torch.full_like(p2, _SIN[0])
    for coef in _SIN[1:]:
        s = _fma(s, p2, coef)
    s = phi * s
    ki = k.to(torch.int32) & 3
    return torch.where(ki == 0, c, torch.where(
        ki == 1, -s, torch.where(ki == 2, -c, s)))


def _check_dist(dist: str) -> None:
    if dist not in DIST_CODES:
        raise NotImplementedError(
            f"zo_affine has no generator for dist={dist!r} (implemented: "
            "gaussian, rademacher); sphere is the gaussian stream rescaled "
            "by sqrt(d)/||z||, which the perturbation backend folds into b "
            "(||z||^2 from the zo_sqnorm kernel) — call with dist='gaussian'")


def z_from_counter(idx: torch.Tensor, seed: int, dist: str) -> torch.Tensor:
    """f32 z for uint32 counters ``idx`` (int64 tensor) of stream ``seed``."""
    _check_dist(dist)
    seed = int(seed) & _MASK
    if dist == "gaussian":
        u1 = counter_uniform(idx, seed, 1)
        u2 = counter_uniform(idx, seed, 2)
        t = -2.0 * _det_log(u1)
        r = _sqrt_rn(torch.clamp_min(t, 0.0))
        return r * _det_cos2pi(u2)
    u = counter_uniform(idx, seed, 1)                    # rademacher
    return torch.where(u >= 0.5, 1.0, -1.0).to(torch.float32)


def z_for(shape, seed: int, dist: str = "gaussian",
          device="cpu") -> torch.Tensor:
    """The f32 z of a leaf of ``shape`` (the port of ``ref.z_for``)."""
    n = int(np.prod(shape)) if len(shape) else 1
    idx = torch.arange(n, dtype=torch.int64, device=device) & _MASK
    return z_from_counter(idx, seed, dist).reshape(shape)


def plain_chunk(device) -> int:
    """Elements a plain version handles per pass on ``device``: 2^20 on the
    CPU, 2^24 on the card, where each pass's torch ops are bound by their
    launches.  Every plain version of the z kernels (X1's in
    ``threefry.kernel`` too) walks its leaf in these passes; each element
    is computed alone, so the passes decide the time, never the bits."""
    return _CHUNK_CUDA if torch.device(device).type == "cuda" else _CHUNK


def zo_affine_plain(x: torch.Tensor, seed: int, a: float, b: float,
                    dist: str = "gaussian",
                    out: Optional[torch.Tensor] = None,
                    offset: int = 0) -> torch.Tensor:
    """Plain torch K1 on any device: y = fma(a, x, round(b·z)) in f32, cast
    to x's dtype.  ``out`` may be ``x`` (in place); ``offset`` is added to
    every flat index (x is a window of a longer leaf), and the counter is
    that index mod 2³², as JAX's uint32 counter wraps."""
    flat = x.reshape(-1)
    y = torch.empty_like(x) if out is None else out
    yflat = y.view(-1)
    a32 = torch.tensor(_f32(a), dtype=torch.float32, device=x.device)
    b32 = _f32(b)
    chunk = plain_chunk(x.device)
    for lo in range(0, flat.numel(), chunk):
        hi = min(lo + chunk, flat.numel())
        idx = torch.arange(lo + offset, hi + offset, dtype=torch.int64,
                           device=x.device) & _MASK
        z = z_from_counter(idx, seed, dist)
        yflat[lo:hi] = _fma(a32, flat[lo:hi].to(torch.float32),
                            z * b32).to(x.dtype)
    return y


def _check_leaf(x: torch.Tensor, what: str) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} takes float32/bfloat16/float16 leaves, "
                        f"got {x.dtype}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes contiguous leaves")


# --------------------------------------------------------------------------- #
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------- #
def _lib():
    lib = _build.load("zo_affine")
    if not getattr(lib, "_typed", False):
        lib.zo_affine.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_uint32, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]
        lib.zo_affine.restype = ctypes.c_int
        lib._typed = True
    return lib


def zo_affine(x: torch.Tensor, seed: int, a: float, b: float,
              dist: str = "gaussian",
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = a·x + b·z(seed) over a leaf of any shape; ``out=x`` writes in
    place (the paper's in-place trick).  CPU tensors take the plain version;
    CUDA tensors launch K1; ``meta`` tensors (and DTensors on them) take the
    shape rule."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("zo_affine: out must match x in shape, dtype and "
                         "device")
    if costs.active():
        costs.charge("zo_affine", costs.zo_affine(
            _build.local(x).numel(), x.element_size(), dist))
    if _build.on_meta(x):
        return torch.empty_like(x) if out is None else out
    if x.device.type == "cpu":
        return zo_affine_plain(x, seed, a, b, dist, out)
    if out is not None and not out.is_contiguous():
        raise ValueError("zo_affine: the CUDA kernel takes contiguous leaves")
    y = torch.empty_like(x) if out is None else out
    if x.numel() == 0:
        return y
    lib = _lib()
    err = lib.zo_affine(_build.ptr(x), _build.ptr(y), x.numel(),
                        DTYPE_CODES[x.dtype], int(seed) & _MASK, _f32(a),
                        _f32(b), DIST_CODES[dist], _build.stream_of(x))
    _build.check(lib, err, "zo_affine")
    _build.count("zo_affine")
    return y


#: the checks of ``zo_selftest`` (``enum Check`` in ``csrc/zo_affine.cu``),
#: each a rewrite of ``zo_stream.cuh`` held to ``zo::ref`` over its domain
SELFTEST_CHECKS = ("uniform", "uniform_x4", "exponent", "mantissa",
                   "division", "neg2log", "sqrt", "quadrant", "cos",
                   "rademacher", "z_sample")


def z_selftest(device="cuda") -> dict:
    """Runs ``zo_selftest`` on the card: every 24-bit uniform (and every
    23-bit mantissa for the division) through the z generator's rewrites
    and through ``zo::ref``; {check: inputs on which they differ}."""
    lib = _lib()
    if not getattr(lib, "_selftest_typed", False):
        lib.zo_selftest.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.zo_selftest.restype = ctypes.c_int
        lib.zo_selftest_checks.restype = ctypes.c_int
        lib._selftest_typed = True
    if lib.zo_selftest_checks() != len(SELFTEST_CHECKS):
        raise RuntimeError("zo_selftest's checks do not match SELFTEST_CHECKS")
    bad = torch.zeros(len(SELFTEST_CHECKS), dtype=torch.int64, device=device)
    _build.check(lib, lib.zo_selftest(_build.ptr(bad), _build.stream_of(bad)),
                 "zo_selftest")
    return dict(zip(SELFTEST_CHECKS, bad.tolist()))


def _u32_array(vals):
    return (ctypes.c_uint32 * len(vals))(*[int(v) & _MASK for v in vals])


def _f32_array(vals):
    return (ctypes.c_float * len(vals))(*[_f32(v) for v in vals])


def _multi_lib():
    lib = _build.load("zo_multi")
    if not getattr(lib, "_typed", False):
        vp, i64, i, f = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)
        for name in ("zo_affine_multi", "zo_affine_chain"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, i64, i, vp, vp, vp, i, i, vp]
            fn.restype = i
        lib.zo_affine_batched.argtypes = [vp, vp, i64, i, vp, i, f, f, i, vp]
        lib.zo_affine_batched.restype = i
        lib._typed = True
    return lib


def fanout_route(x: torch.Tensor, y: torch.Tensor) -> str:
    """The route a fan-out launch (K4, K5) from leaf ``x`` into the stacked
    ``y`` takes, by ``launch_fanout``'s rule in ``csrc/zo_multi.cu``:
    ``"vector"`` when every slice of y lies against 16 bytes as x does (a
    slice of ``x.numel()`` elements is a whole number of 16-byte vectors,
    and x and y start at the same offset from 16 bytes, on an element
    boundary), ``"scalar"`` otherwise — every element then takes the scalar
    loop."""
    size = x.element_size()
    ax, ay = x.data_ptr() % 16, y.data_ptr() % 16
    whole = (x.numel() * size) % 16 == 0
    return "vector" if whole and ax == ay and ax % size == 0 else "scalar"


def zo_affine_batched_plain(x: torch.Tensor, seeds, a: float, b: float,
                            dist: str = "gaussian") -> torch.Tensor:
    """Plain K5: the stacked K1 singles y[j] = zo_affine(x, seeds[j], a, b)."""
    return torch.stack([zo_affine_plain(x, s, a, b, dist) for s in seeds])


def zo_affine_batched(x: torch.Tensor, seeds, a: float, b: float,
                      dist: str = "gaussian") -> torch.Tensor:
    """K5 (port of ``zo_affine_2d_batched``): y[j] = a·x + b·z(seeds[j]) with
    one shared (a, b), shape ``(len(seeds), *x.shape)``; each slice is
    bitwise the K1 single.  x is read once for all streams."""
    _check_dist(dist)
    _check_leaf(x, "zo_affine_batched")
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("zo_affine_batched needs at least one seed")
    if costs.active():
        costs.charge("zo_affine_batched", costs.zo_affine_fanout(
            _build.local(x).numel(), x.element_size(), len(seeds), dist))
    if _build.on_meta(x):
        return _build.empty_streams(x, len(seeds))
    if x.device.type == "cpu":
        return zo_affine_batched_plain(x, seeds, a, b, dist)
    y = torch.empty((len(seeds),) + tuple(x.shape), dtype=x.dtype,
                    device=x.device)
    if x.numel() == 0:
        return y
    lib = _multi_lib()
    route = fanout_route(x, y)
    for j0 in range(0, len(seeds), MAX_STREAMS):
        part = seeds[j0:j0 + MAX_STREAMS]
        err = lib.zo_affine_batched(
            _build.ptr(x), _build.ptr(y[j0]), x.numel(), DTYPE_CODES[x.dtype],
            _u32_array(part), len(part), _f32(a), _f32(b), DIST_CODES[dist],
            _build.stream_of(x))
        _build.check(lib, err, "zo_affine_batched")
        _build.count("zo_affine_batched", route)
    return y
