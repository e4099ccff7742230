"""X1 ``zo_affine_threefry``: y = a·x + b·z over one leaf, where z is
``jax.random.normal`` / ``rademacher`` of the leaf's key — JAX's default
``xla`` perturbation stream, reproduced bit for bit.

JAX has no Pallas kernel here: XLA lowers threefry, ``erf_inv`` and the
affine write into one loop fusion.  The port fuses them the same way in one
hand-written kernel (``csrc/zo_threefry.cu``) so no leaf-sized temporary
exists on the card; this module holds its plain torch version (the bitwise
specification, run for CPU tensors) and its wrapper.

The stream, in either threefry layout (``jax_threefry_partitionable``,
the port's switch ``perturb.stream.threefry_partitionable``):

* **bits, partitionable** (JAX's default since 0.5). Element i of a leaf
  draws ``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` — a
  function of (key, flat index) alone, so a leaf can be generated in chunks
  or band by band.
* **bits, original.** A leaf of n elements drawn at bw bits (``bit_width``:
  32 for f32 and rademacher, 8 for bf16, 16 for f16) hashes m =
  ⌈bw·n/32⌉ words in the pairing of ``stream.original_word`` (word w and
  w + ⌈m/2⌉ from one hash), past 2³² − 1 words under one key per block
  (``block_keys``); element i takes bw bits of word i / (32/bw)
  (``original_bits``).  A function of (key, n, i): chunks and bands are
  still generated alone, given the leaf's n.
* **f32 normal.** u = max(lo, 2·(m·2⁻²³) + lo) with m = bits >> 9 and
  lo = −(1 − 2⁻²⁴); z = √2 · erf_inv(u), erf_inv as XLA:CPU expands it:
  w = −log1p(−u²) (XLA's Cephes-style log1p, its log a Cephes ``logf``),
  Giles' two 9-term polynomials split at w < 5, every Horner step one FMA
  (XLA:CPU contracts them), every other op separately rounded.
* **bf16 / f16 normal.** JAX draws 8 (bf16) or 16 (f16) bits per element
  and forms u in the leaf dtype, each op rounded there; erf_inv runs in f32
  and is rounded back.  So z takes 128 (bf16) or 1024 (f16) values: a table
  indexed by ``bits & 0xFF`` or ``(bits & 0xFFFF) >> 6``.
* **rademacher.** ``bernoulli(0.5)`` on an f32 uniform: +1 when bit 31 of
  the bits is clear, −1 otherwise.

The affine write follows the graph JAX's ``xla`` backend traces for each
method (``FORMS``), as XLA:CPU compiles it.  In f32 and f16 its algebraic
simplifier folds z's √2 (and the z scale) into the scalar that multiplies z
(``folded_scalars``, the products rounded to the dtype) and LLVM contracts
one multiply into each add: f32 FMAs, and in f16 the native half FMAs of a
host with AVX512-FP16 (``vfmadd…ph``; a host without them rounds
otherwise, within an f16 ulp); in bf16 every op is rounded to the dtype,
as written.  An optional z scale (``zs``, the sphere's √d/‖z‖ or rescaled
SPSA's per-leaf d) multiplies z first, as JAX's ``z * s.astype(z.dtype)``.

A CPU tensor takes the plain version (chunked, so temporaries stay small);
a CUDA tensor launches X1 or raises.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import costs
from repro_torch.kernels import _build
from repro_torch.kernels.zo_fused.kernel import (_fma, _fma_odd, _sqrt_rn,
                                                 plain_chunk)

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DIST_CODES = {"gaussian": 0, "rademacher": 1}
#: the affine write of each backend method (``enum Form`` in the CUDA
#: source), with u the unit z is built from (f32 / f16 gaussian:
#: erf_inv(u), its √2 folded into k, b and e; else z) — f32 and f16 (fma
#: and rn in the dtype) | bf16 (rt: round to it):
#:   z       rn(u·k)               | z                        (``leaf_z``)
#:   axpbz   fma(a, x, rn(u·b))    | rt(rt(a·x) + rt(b·z))    (apply_rank1)
#:   xpbz    fma(u, b, x)          | rt(x + rt(b·z))          (perturb)
#:   restore fma(a, fma(u, e, x), rn(u·b))
#:           | rt(rt(a·rt(x + rt(e·z))) + rt(b·z))    (fused_restore_update)
FORMS = {"z": 0, "axpbz": 1, "xpbz": 2, "restore": 3}


def _f(hex64: str) -> float:
    """An f32 constant as it stands in XLA:CPU's LLVM IR (a double's bits)."""
    v = struct.unpack(">d", bytes.fromhex(hex64))[0]
    assert float(np.float32(v)) == v
    return v


# log(y), Cephes ``logf`` as XLA:CPU emits it
_SQRTHF = _f("3FE6A09E60000000")
_LOG_P = tuple(_f(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000"))
_LOG_Q1, _LOG_Q2 = _f("BF2BD01060000000"), _f("3FE6300000000000")
_FLT_MIN = _f("3810000000000000")
# log1p(x) for |x| < √2 − 1: x − x²/2 + x³·P(x)/Q(x)
_L1P_DEN = tuple(_f(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
_L1P_NUM0 = _f("3F07BC0960000000")
_L1P_NUM = tuple(_f(h) for h in (
    "3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
    "404E798EC0000000", "404C8E75A0000000", "40340A2020000000"))
_L1P_SMALL = _f("3FDA8279A0000000")
# erf_inv (Giles), w < 5 and w >= 5
_ERFINV_LT = tuple(_f(h) for h in (
    "3E5E2CB100000000", "3E970966C0000000", "BECD8E6AE0000000",
    "BED26B5820000000", "3F2CA65B60000000", "BF548A8100000000",
    "BF711C9DE0000000", "3FCF91EC60000000", "3FF805C5E0000000"))
_ERFINV_GE = tuple(_f(h) for h in (
    "BF2A3E1360000000", "3F1A76AD60000000", "3F561B8E40000000",
    "BF6E17BCE0000000", "3F77824F60000000", "BF7F38BAE0000000",
    "3F8354AFC0000000", "3FF006DB60000000", "4006A9EFC0000000"))
_SQRT2 = _f("3FF6A09E60000000")
_SQRT2_F16 = 1.4140625                  # √2 rounded to f16
_LO32 = _f("BFEFFFFFE0000000")          # nextafter(-1, 0) in f32


# --------------------------------------------------------------------------- #
# Plain torch version (bitwise specification)
# --------------------------------------------------------------------------- #
def threefry_pair(key, c0: torch.Tensor, c1: torch.Tensor):
    """threefry2x32(key, (c0, c1)) on int64 tensors of uint32 counts: both
    output words, int64 values in [0, 2³²)."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + k0) & _MASK
    x1 = (c1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def threefry_bits(key, idx: torch.Tensor) -> torch.Tensor:
    """``x0 ^ x1`` of threefry2x32(key, (idx >> 32, idx & 0xFFFFFFFF)) for
    int64 flat indices ``idx`` ≥ 0; int64 values in [0, 2³²) — the
    partitionable layout's bits of element idx."""
    x0, x1 = threefry_pair(key, idx >> 32, idx & _MASK)
    return x0 ^ x1


#: words one key hashes at most under the original layout; a longer draw
#: splits its key into ⌈m / BLOCK_WORDS⌉ keys (JAX's ``nblocks + 1``)
BLOCK_WORDS = (1 << 32) - 1


def bit_width(dtype: torch.dtype, dist: str) -> int:
    """Bits JAX draws per element: ``uniform`` takes the dtype's width, 8
    for bf16 (fewer than 8 mantissa bits); rademacher is ``bernoulli(0.5)``
    on an f32 uniform, 32 bits in every dtype."""
    if dist == "rademacher" or dtype == torch.float32:
        return 32
    return 8 if dtype == torch.bfloat16 else 16


def draw_words(n: int, bw: int) -> int:
    """m = ⌈bw · n / 32⌉, the 32-bit words a draw of n elements hashes."""
    return -(-bw * n // 32)


def block_keys(key, m: int) -> List:
    """The keys that hash an original-layout draw of m words: the key
    itself below ``BLOCK_WORDS`` words, else ``split(key, nblocks + 1)``
    in the original layout (block b hashes words [b·BLOCK_WORDS, …))."""
    from repro_torch.perturb.stream import split, threefry_partitionable
    nblocks = m // BLOCK_WORDS
    if nblocks == 0:
        return [(int(key[0]) & _MASK, int(key[1]) & _MASK)]
    with threefry_partitionable(False):
        return split(key, nblocks + 1)


def block_words(m: int, b: int) -> int:
    """Words hashed under block b's key (the last block: the remainder)."""
    nblocks, rem = divmod(m, BLOCK_WORDS)
    return BLOCK_WORDS if b < nblocks else rem


def original_bits(key, idx: torch.Tensor, n: int, bw: int) -> torch.Tensor:
    """The original layout's bw-bit value of elements ``idx`` (int64) of an
    n-element draw: word W = idx // (32/bw) of the m-word stream, hashed
    under block key W // BLOCK_WORDS at local count w = W % BLOCK_WORDS
    in the pairing of ``stream.original_word``; element idx takes bits
    bw · (idx % (32/bw)) and up of its word."""
    epw = 32 // bw
    m = draw_words(n, bw)
    word = idx // epw
    out = torch.empty_like(idx)
    keys = block_keys(key, m)
    blk = word // BLOCK_WORDS
    for b in range(len(keys)):
        sel = blk == b if len(keys) > 1 else None
        w = word if sel is None else word[sel] - b * BLOCK_WORDS
        mb = block_words(m, b)
        h = (mb + 1) // 2
        first = w < h
        pair = w + h
        c0 = torch.where(first, w, w - h)
        c1 = torch.where(first, torch.where(pair < mb, pair, 0), w)
        o0, o1 = threefry_pair(keys[b], c0, c1)
        bits = torch.where(first, o0, o1)
        if sel is None:
            out = bits
        else:
            out[sel] = bits
    if bw < 32:
        out = (out >> (bw * (idx % epw))) & ((1 << bw) - 1)
    return out


def random_bits(key, idx: torch.Tensor, n: int, bw: int,
                partitionable: bool) -> torch.Tensor:
    """Element ``idx``'s random bits of an n-element draw of width bw in
    the given layout (partitionable: all 32 bits of the element's hash,
    which the z unit masks to bw)."""
    if partitionable:
        return threefry_bits(key, idx)
    return original_bits(key, idx, n, bw)


def _full(t: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full_like(t, v)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p`` for x in (−1, 0]: a rational approximation
    for |x| < √2 − 1, else Cephes ``logf(1 + x)`` — each multiply that LLVM
    contracts into the following add written as one exact FMA."""
    # large |x|: log(1 + x) = e·ln2 + log(m), m in [√½, √2)
    y = x + 1.0
    y = torch.where(y > _FLT_MIN, y, _full(y, _FLT_MIN))
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0           # exact
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRTHF
    t = (m - 1.0) + torch.where(low, m, _full(m, 0.0))
    e = e - low.to(torch.float32)                                # exact
    t2 = t * t
    t3 = t2 * t
    pa = _fma(t, _full(t, _LOG_P[0]), _LOG_P[1])
    pb = _fma(t, _full(t, _LOG_P[2]), _LOG_P[3])
    pc = _fma(t, _full(t, _LOG_P[4]), _LOG_P[5])
    pa = _fma(pa, t, _LOG_P[6])
    pb = _fma(pb, t, _LOG_P[7])
    pc = _fma(pc, t, _LOG_P[8])
    p = _fma(_fma(pa, t3, pb), t3, pc)
    p = _fma(p, t3, e * _LOG_Q1)
    large = _fma(e, _full(e, _LOG_Q2), (t - t2 * 0.5) + p)
    # small |x|: x − x²/2 + x³·num(x)/den(x)
    x2 = x * x
    den = _full(x, 1.0)
    for c in _L1P_DEN:
        den = _fma(den, x, c)
    num = _full(x, _L1P_NUM0)
    for c in _L1P_NUM:
        num = _fma(num, x, c)
    small = x + _fma(x2, _full(x2, -0.5), (x * x2) * (num / den))
    return torch.where(torch.abs(x) < _L1P_SMALL, small, large)


def erf_inv_f32(u: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (Giles' single-precision approximation) as
    XLA:CPU computes it."""
    lg = xla_log1p(u * (-u))
    lt = lg > -5.0                                    # w = −lg < 5
    ww = torch.where(lt, -2.5 - lg, _sqrt_rn(torch.clamp_min(-lg, 0.0)) - 3.0)
    p = torch.where(lt, _ERFINV_LT[0], _ERFINV_GE[0]).to(torch.float32)
    for ca, cb in zip(_ERFINV_LT[1:], _ERFINV_GE[1:]):
        p = _fma(p, ww, torch.where(lt, ca, cb).to(torch.float32))
    p = torch.where(torch.abs(u) == 1.0, _full(p, float("inf")), p)
    return u * p


def normal_f32(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s f32 value of 32 random bits (int64 tensor)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * 2.0 + _LO32, _LO32)
    return erf_inv_f32(u) * _SQRT2


@functools.lru_cache(maxsize=None)
def _half_table(dtype: torch.dtype) -> torch.Tensor:
    """The unit a bf16 (256 entries, index ``bits & 0xFF``) or f16 (1024
    entries, index ``(bits & 0xFFFF) >> 6``) gaussian write multiplies, as
    f32 values: u formed in the dtype with every op rounded there, erf_inv
    in f32 rounded back — the graph of ``jax.random.normal``.  bf16's entry
    is z itself, times √2 in the dtype (XLA:CPU writes bf16 op by op); f16's
    is erf_inv(u), since there XLA folds the √2 into the scalar
    (``folded_scalars``)."""
    def rt(v):
        return v.to(dtype).to(torch.float32)

    if dtype == torch.bfloat16:
        idx = torch.arange(256, dtype=torch.int32)
        fbits = (idx >> 1) | 0x3F80
    else:
        idx = torch.arange(1024, dtype=torch.int32)
        fbits = idx | 0x3C00
    one = fbits.to(torch.int16).view(dtype).to(torch.float32)
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    span = float(rt(torch.tensor(1.0 - lo)))
    f = rt(one - 1.0)
    u = torch.clamp_min(rt(rt(f * span) + lo), lo)
    unit = rt(erf_inv_f32(u))
    return unit if dtype == torch.float16 else rt(unit * _SQRT2_F16)


def _z_unit(bits: torch.Tensor, dtype: torch.dtype,
            dist: str) -> torch.Tensor:
    """What the affine write multiplies: z itself, except for the f32 and
    f16 gaussian, where it is erf_inv(u) — XLA folds the √2 into the scalar
    that multiplies z (``folded_scalars``)."""
    if dist == "rademacher":
        return torch.where(bits >= (1 << 31), -1.0, 1.0).to(torch.float32)
    if dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return erf_inv_f32(torch.clamp_min((f - 1.0) * 2.0 + _LO32, _LO32))
    table = _half_table(dtype).to(bits.device)
    idx = bits & 0xFF if dtype == torch.bfloat16 else (bits & 0xFFFF) >> 6
    return table[idx]


#: dtypes whose write folds z's scalars and contracts one multiply per add
#: (f32 on every host; f16 as XLA:CPU compiles it with native half FMAs)
FOLDED = (torch.float32, torch.float16)


def folded_scalars(dtype: torch.dtype, dist: str, b: float, e: float,
                   zs: Optional[float]):
    """The scalars an f32 or f16 leaf's write multiplies its unit by.  XLA's
    algebraic simplifier reassociates a broadcast scalar times z =
    erf_inv(u)·√2 (times the z scale) into erf_inv(u) · (√2·zs·b), each
    scalar product rounded to the dtype: so b and e become rn(rn(√2·zs)·b)
    and rn(rn(√2·zs)·e); rademacher's unit is ±1.  Returns (the z form's
    multiplier, b, e)."""
    t = np.float32 if dtype == torch.float32 else np.float16
    k = t(_SQRT2 if dist == "gaussian" else 1.0)
    if zs is not None:
        k = t(k * t(zs))
    return float(k), float(t(k * t(b))), float(t(k * t(e)))


def _rt(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype).to(torch.float32)


def _fma16(a, b, c) -> torch.Tensor:
    """Exactly rounded f16 fused multiply-add of f16 values held in f32 —
    XLA:CPU's native half FMA (``vfmadd…ph`` on an AVX512-FP16 host).  a·b
    + c is rounded to odd in f64 (``_fma_odd``), to odd again in f32, then
    once to f16: a correct single rounding (24 ≥ 11 + 2 bits), where one
    f64 → f16 conversion through f32 would round twice."""
    v = _fma_odd(a, b, c)
    r = v.to(torch.float32)
    bits = r.view(torch.int32)
    inexact = r.double() != v
    bits = torch.where(inexact & (r.double().abs() > v.abs()), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return _rt(bits.view(torch.float32), torch.float16)


def _combine(form: int, x, zu, a: float, b: float, e: float, k: float,
             dtype: torch.dtype) -> torch.Tensor:
    """The affine write of ``form``: f32 and f16 on the unit ``zu`` with
    the scalars of ``folded_scalars``, one multiply contracted into each
    add; bf16 on z (already times the z scale), every op rounded to it."""
    if dtype in FOLDED:
        if dtype == torch.float32:
            fma, rn = _fma, (lambda v: v)
        else:
            fma, rn = _fma16, (lambda v: _rt(v, dtype))
        if form == FORMS["z"]:
            return rn(zu * k)
        if form == FORMS["axpbz"]:
            return fma(_full(x, a), x, rn(zu * b))
        if form == FORMS["xpbz"]:
            return fma(zu, _full(zu, b), x)
        return fma(_full(x, a), fma(zu, _full(zu, e), x), rn(zu * b))
    if form == FORMS["z"]:
        return zu
    if form == FORMS["axpbz"]:
        return _rt(x * a, dtype) + _rt(zu * b, dtype)
    if form == FORMS["xpbz"]:
        return x + _rt(zu * b, dtype)
    r = _rt(x + _rt(zu * e, dtype), dtype)
    return _rt(r * a, dtype) + _rt(zu * b, dtype)


def check_scalars(dtype: torch.dtype, *vals) -> None:
    """Half-dtype scalars must be values of the dtype (JAX casts them to
    the leaf dtype before the write)."""
    for v in vals:
        if v is not None and float(torch.tensor(v).to(dtype)) != float(v):
            raise ValueError(f"zo_affine_threefry: scalar {v!r} is not a "
                             f"{dtype} value; round it to the leaf dtype")


def zo_affine_threefry_plain(x: Optional[torch.Tensor], key, form: str,
                             a: float = 0.0, b: float = 0.0, e: float = 0.0,
                             zs: Optional[float] = None,
                             dist: str = "gaussian",
                             out: Optional[torch.Tensor] = None,
                             bands: Optional[Sequence] = None,
                             offset: int = 0, total: Optional[int] = None,
                             partitionable: bool = True) -> torch.Tensor:
    """Plain X1 on any device.  ``x=None`` (form ``z``) writes z into
    ``out``; ``bands`` is a list of flat ``(lo, hi)`` ranges, the only
    elements written (a rows plan); ``offset`` is added to every flat
    index (a chunk of a longer leaf) and ``total`` is that leaf's element
    count (default offset + numel), which the original layout's pairing
    reads."""
    fcode = FORMS[form]
    y = out if out is not None else torch.empty_like(x)
    dtype = y.dtype
    k = 1.0
    if dtype in FOLDED:
        k, b, e = folded_scalars(dtype, dist, b, e, zs)
        zs = None
    yflat = y.view(-1)
    xflat = x.reshape(-1) if x is not None else None
    ranges = [(0, yflat.numel())] if bands is None else bands
    chunk = plain_chunk(y.device)
    n = offset + yflat.numel() if total is None else int(total)
    bw = bit_width(dtype, dist)
    for lo0, hi0 in ranges:
        for lo in range(lo0, hi0, chunk):
            hi = min(lo + chunk, hi0)
            idx = torch.arange(lo + offset, hi + offset, dtype=torch.int64,
                               device=y.device)
            zu = _z_unit(random_bits(key, idx, n, bw, partitionable), dtype,
                         dist)
            if zs is not None:
                zu = _rt(zu * zs, dtype)
            xv = None if xflat is None else xflat[lo:hi].to(torch.float32)
            yflat[lo:hi] = _combine(fcode, xv, zu, a, b, e, k,
                                    dtype).to(dtype)
    return y


# --------------------------------------------------------------------------- #
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------- #
def _lib():
    lib = _build.load("zo_threefry")
    if not getattr(lib, "_typed", False):
        vp, i64, i, f, u32, u64 = (ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_float,
                                   ctypes.c_uint32, ctypes.c_uint64)
        lib.zo_threefry_whole.argtypes = [vp, vp, u32, u32, u32, i, u32, u32,
                                          u32, u32, i, i, f, f, f, f, i, f,
                                          vp]
        lib.zo_threefry_whole.restype = i
        lib.zo_threefry_bands.argtypes = [vp, vp, i, u32, u32, u64, i, i, f,
                                          f, f, f, i, f, vp, vp, i, i64, vp]
        lib.zo_threefry_bands.restype = i
        lib.zo_threefry_original.argtypes = [vp, vp, i, u32, u32, u64, u32,
                                             u32, u32, u32, u64, u64, u64,
                                             i, i, i, f, f, f, f, i, f, vp]
        lib.zo_threefry_original.restype = i
        lib.zo_threefry_original_bands.argtypes = [vp, vp, i, u32, u32, u64,
                                                   u32, u32, u64, i, i, i, f,
                                                   f, f, f, i, f, vp, vp, i,
                                                   i64, vp]
        lib.zo_threefry_original_bands.restype = i
        lib.zo_threefry_normal_f32.argtypes = [vp, i64, i64, vp]
        lib.zo_threefry_normal_f32.restype = i
        lib.zo_threefry_table.argtypes = [vp, i, vp]
        lib.zo_threefry_table.restype = i
        lib.zo_threefry_pipe_probe.argtypes = [i, vp, i, i, vp]
        lib.zo_threefry_pipe_probe.restype = i
        lib._typed = True
    return lib


#: elements of one whole-route launch at most, and the counter multiple a
#: call is split at: no launch's counters cross 2^32, so their high word is
#: a launch constant, and the kernel indexes a launch in 32 bits
LAUNCH_SPAN = 1 << 31


class Launch(NamedTuple):
    """One launch of the whole route: elements [start, start + n) of the
    leaf, counters (hi, lo + i) for element start + i; the first ``head``
    elements and those past ``head + nvec`` 16-byte vectors take the
    kernel's scalar loop."""
    start: int
    n: int
    hi: int
    lo: int
    head: int
    nvec: int


def launch_route(x_addr: Optional[int], y_addr: int, itemsize: int) -> str:
    """``"vector"`` when x and y lie alike against 16 bytes (on an element
    boundary), so a launch's body runs in 16-byte vectors; ``"scalar"``
    when every element takes the scalar loop.  x_addr is None for the z
    form."""
    ay = y_addr % 16
    ax = ay if x_addr is None else x_addr % 16
    return "vector" if ax == ay and ax % itemsize == 0 else "scalar"


def whole_launches(n: int, offset: int, x_addr: Optional[int], y_addr: int,
                   itemsize: int) -> List[Launch]:
    """The launches of a whole-leaf X1 call over ``n`` elements whose flat
    counters start at ``offset`` (x at ``x_addr``, None for the z form; y
    at ``y_addr``).  The call is cut where the counter reaches a multiple
    of ``LAUNCH_SPAN``; each launch's head runs up to y's first 16-byte
    boundary, or over every element on the ``scalar`` route."""
    per_vec = 16 // itemsize
    scalar = launch_route(x_addr, y_addr, itemsize) == "scalar"
    out, i = [], 0
    while i < n:
        c = offset + i
        m = min(n - i, LAUNCH_SPAN - c % LAUNCH_SPAN)
        if scalar:
            head, nvec = m, 0
        else:
            head = min((16 - (y_addr + i * itemsize) % 16) % 16 // itemsize,
                       m)
            nvec = (m - head) // per_vec
        out.append(Launch(i, m, c >> 32, c & _MASK, head, nvec))
        i += m
    return out


#: pairs of one original-route launch at most: the kernel indexes a launch's
#: elements in 32 bits from its first pair's words, below 2^31 at 4
#: elements a word
ORIG_LAUNCH_PAIRS = LAUNCH_SPAN // 4


class OrigLaunch(NamedTuple):
    """One launch of the original route: pairs [p0, p0 + np) of block
    ``block`` (m words from word ``wbase`` of the draw, half h)."""
    block: int
    wbase: int
    m: int
    h: int
    p0: int
    np: int


def original_launches(lo: int, hi: int, n: int, bw: int) -> List[OrigLaunch]:
    """The launches that write elements [lo, hi) of an n-element draw of
    width bw under the original layout: per block of ``BLOCK_WORDS`` words
    the window's words fall in, the pairs holding them — the window's
    words in the first half and, shifted by h, those in the second; one
    pair range when the two meet, else two; each cut into launches of at
    most ``ORIG_LAUNCH_PAIRS`` pairs."""
    if hi <= lo:
        return []
    epw = 32 // bw
    m = draw_words(n, bw)
    w_lo, w_hi = lo // epw, -(-hi // epw)
    out = []
    for b in range(w_lo // BLOCK_WORDS, (w_hi - 1) // BLOCK_WORDS + 1):
        base = b * BLOCK_WORDS
        mb = block_words(m, b)
        h = (mb + 1) // 2
        a0, a1 = max(w_lo - base, 0), min(w_hi - base, mb)
        spans = [(lo_, hi_) for lo_, hi_ in ((a0, min(a1, h)),
                                            (max(a0, h) - h, a1 - h))
                 if hi_ > lo_]
        spans.sort()
        if len(spans) == 2 and spans[1][0] <= spans[0][1]:
            spans = [(spans[0][0], max(spans[0][1], spans[1][1]))]
        out += [OrigLaunch(b, base, mb, h, p, min(p1, p + ORIG_LAUNCH_PAIRS)
                           - p)
                for p0, p1 in spans for p in range(p0, p1, ORIG_LAUNCH_PAIRS)]
    return out


#: runs of R pairs a warp walks in one chunk of the zone (``ORIG_CHUNK`` in
#: csrc/zo_threefry.cu); a junction vector joins two chunks
ORIG_CHUNK = 64


class OrigSplit(NamedTuple):
    """How ``zo_threefry_original`` splits one launch (it computes the
    same from its arguments).  Pair p of the launch (relative to p0) hashes
    its word at site 1 (word p0 + p) and at site 2 (word p0 + p + h); each
    site's elements are indexed from its base, the first element of pair
    0's word there, so pair p's word starts at element p·(32/bw) at both.

    * ``lo1, hi1`` / ``lo2, hi2``: each site's elements inside the window
      [e_lo, e_hi) and inside the block (site 2 ends at word m);
    * the ``vector`` route (x and y alike against 16 bytes and site 1's
      words on y's 16-byte grid at R words a vector; else ``scalar``, every
      pair in the scalar loop): the zone, ``nrun`` runs of R pairs from
      pair ``qz``, whose site-1 words fill one 16-byte vector each and
      whose words lie whole in the window at each site that has elements
      in it — the kernel writes them in 16-byte vectors only;
    * ``d`` = h mod R: site 2's words lie d words off the 16-byte grid, so
      its vectors take their first d words from the run before (the lane
      below, or across a chunk of runs a junction vector); 0 when site 2
      has no element in the window;
    * every other pair (the head before qz, the tail after the zone) takes
      the scalar loop, element by element inside the window."""
    route: str
    lo1: int
    hi1: int
    lo2: int
    hi2: int
    qz: int
    nrun: int
    R: int
    d: int


def original_route(ln: OrigLaunch, off: int, bw: int, itemsize: int,
                   x_addr: Optional[int], y_addr: int) -> str:
    """Launch ``ln``'s route (y[0] is draw element ``off``; x at ``x_addr``,
    None for the z form): ``vector`` when x and y lie alike against 16
    bytes and its site-1 words lie on y's 16-byte grid, else ``scalar``."""
    bpw = (32 // bw) * itemsize               # y's bytes a word
    a1 = y_addr + ((ln.wbase + ln.p0) * (32 // bw) - off) * itemsize
    vector = launch_route(x_addr, y_addr, itemsize) == "vector"
    return "vector" if vector and a1 % bpw == 0 else "scalar"


def original_split(ln: OrigLaunch, e_lo: int, e_hi: int, off: int, bw: int,
                   itemsize: int, x_addr: Optional[int],
                   y_addr: int) -> OrigSplit:
    """The split of launch ``ln`` writing draw elements [e_lo, e_hi) of y,
    whose element 0 is draw element ``off`` (x at ``x_addr``, None for the
    z form; y at ``y_addr``): see ``OrigSplit``."""
    epw = 32 // bw
    bpw = epw * itemsize                      # y's bytes a word
    R = 16 // bpw
    e1 = (ln.wbase + ln.p0) * epw
    e2 = e1 + ln.h * epw
    span1 = ln.np * epw
    span2 = max(0, min(ln.p0 + ln.np + ln.h, ln.m) - ln.p0 - ln.h) * epw

    def clip(v: int, span: int) -> int:
        return min(max(v, 0), span)

    lo1, hi1 = clip(e_lo - e1, span1), clip(e_hi - e1, span1)
    lo2, hi2 = clip(e_lo - e2, span2), clip(e_hi - e2, span2)
    if original_route(ln, off, bw, itemsize, x_addr, y_addr) == "scalar":
        return OrigSplit("scalar", lo1, hi1, lo2, hi2, ln.np, 0, R, 0)
    a1 = y_addr + (e1 - off) * itemsize       # site 1's first word in y
    qa = (-a1 % 16) // bpw                    # the first pair on the grid
    first, end = 0, ln.np
    for lo, hi in ((lo1, hi1), (lo2, hi2)):
        if hi > lo:                           # whole words inside [lo, hi)
            first, end = max(first, -(-lo // epw)), min(end, hi // epw)
    qz = first + (qa - first) % R
    nrun = max(0, (end - qz) // R)
    if nrun == 0:
        return OrigSplit("vector", lo1, hi1, lo2, hi2, ln.np, 0, R, 0)
    return OrigSplit("vector", lo1, hi1, lo2, hi2, qz, nrun, R,
                     ln.h % R if hi2 > lo2 else 0)


def _original_bands(bands: Sequence, offset: int, bw: int):
    """A rows plan's bands (flat in y, y[0] = draw element ``offset``)
    grouped by the block of words they lie in: [(block, [(lo, hi), …])]."""
    span = BLOCK_WORDS * (32 // bw)
    groups = {}
    for lo, hi in bands:
        e = lo + offset
        while e < hi + offset:
            b = e // span
            end = min(hi + offset, (b + 1) * span)
            groups.setdefault(b, []).append((e - offset, end - offset))
            e = end
    return sorted(groups.items())


def zo_affine_threefry(x: Optional[torch.Tensor], key, form: str,
                       a: float = 0.0, b: float = 0.0, e: float = 0.0,
                       zs: Optional[float] = None, dist: str = "gaussian",
                       out: Optional[torch.Tensor] = None,
                       bands: Optional[Sequence] = None,
                       offset: int = 0, total: Optional[int] = None,
                       partitionable: Optional[bool] = None) -> torch.Tensor:
    """X1: the affine write ``form`` of z(key) over one leaf (see ``FORMS``),
    in place when ``out`` is ``x``.  Scalars are f32 values (half dtypes:
    values of the leaf dtype).  ``offset`` is the leaf index of y's first
    element and ``total`` the leaf's element count (needed with an offset
    under the original layout, whose pairing spans the whole leaf);
    ``partitionable`` is the threefry layout, by default the one in force
    (``perturb.stream.threefry_partitionable``).  CPU tensors take the
    plain version; ``meta`` tensors (and DTensors on them) take the shape
    rule; CUDA tensors launch the kernel: under the partitionable
    layout the ``whole`` route (``whole_launches``, each launch counted as
    ``vector`` or ``scalar``) or, for a rows plan's ``bands``, the
    ``bands`` route; under the original layout its own kernel,
    ``zo_affine_threefry_original`` (``original_launches``, counted as
    ``pairs`` and as ``pairs/vector`` or ``pairs/scalar`` by
    ``original_route``; bands as ``bands``)."""
    if dist not in DIST_CODES:
        raise NotImplementedError(
            f"zo_affine_threefry has no generator for dist={dist!r}; sphere "
            "is the gaussian stream times sqrt(d)/||z|| (pass it as zs)")
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {sorted(FORMS)}")
    y = out if out is not None else (None if x is None
                                     else torch.empty_like(x))
    if y is None:
        raise ValueError("zo_affine_threefry: form 'z' needs out")
    if (x is None) != (form == "z"):
        raise ValueError("zo_affine_threefry: x is given for every form "
                         "but 'z'")
    if y.dtype not in DTYPE_CODES:
        raise TypeError(f"zo_affine_threefry takes float32/bfloat16/float16 "
                        f"leaves, got {y.dtype}")
    if x is not None and (x.shape != y.shape or x.dtype != y.dtype
                          or x.device != y.device):
        raise ValueError("zo_affine_threefry: out must match x in shape, "
                         "dtype and device")
    if y.dtype != torch.float32:
        check_scalars(y.dtype, a, b, e, zs)
    if partitionable is None:
        from repro_torch.perturb.stream import partitionable as _layout
        partitionable = _layout()
    if total is None:
        if offset and not partitionable:
            raise ValueError("zo_affine_threefry: the original threefry "
                             "layout pairs words across the whole leaf; "
                             "give the leaf's total with an offset")
        total = offset + y.numel()
    if costs.active():
        n = (_build.local(y).numel() if bands is None
             else sum(hi - lo for lo, hi in bands))
        costs.charge("zo_affine_threefry" if partitionable
                     else "zo_affine_threefry_original",
                     costs.zo_affine_threefry(n, y.element_size(), form))
    if _build.on_meta(y):
        return y
    if y.device.type == "cpu":
        return zo_affine_threefry_plain(x, key, form, a, b, e, zs, dist, y,
                                        bands, offset, total, partitionable)
    if y.device.type != "cuda":
        raise RuntimeError(f"zo_affine_threefry: no kernel for {y.device}")
    if not y.is_contiguous() or (x is not None and not x.is_contiguous()):
        raise ValueError("zo_affine_threefry: the CUDA kernel takes "
                         "contiguous leaves")
    if y.numel() == 0:
        return y
    k = 1.0
    if y.dtype in FOLDED:
        k, b, e = folded_scalars(y.dtype, dist, b, e, zs)
        zs = None
    lib = _lib()
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    scal = (DIST_CODES[dist], FORMS[form], float(np.float32(a)),
            float(np.float32(b)), float(np.float32(e)), float(np.float32(k)),
            int(zs is not None), float(np.float32(0.0 if zs is None else zs)))
    stream = _build.stream_of(y)
    if not partitionable:
        return _launch_original(lib, x, y, key, bands, int(offset),
                                int(total), bit_width(y.dtype, dist), scal,
                                stream)
    if bands is not None:
        bl = torch.tensor([[lo, hi] for lo, hi in bands], dtype=torch.int64)
        lens = bl[:, 1] - bl[:, 0]
        total = int(lens.sum())
        if total == 0:
            return y
        starts = bl[:, 0].to(y.device)
        cum = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(lens, 0)]).to(y.device)
        err = lib.zo_threefry_bands(
            None if x is None else _build.ptr(x), _build.ptr(y),
            DTYPE_CODES[y.dtype], k0, k1, int(offset), *scal,
            _build.ptr(starts), _build.ptr(cum), len(bands), total, stream)
        _build.check(lib, err, "zo_affine_threefry")
        _build.count("zo_affine_threefry", "bands")
        return y
    size = y.element_size()
    x_addr = None if x is None else x.data_ptr()
    route = launch_route(x_addr, y.data_ptr(), size)
    for ln in whole_launches(y.numel(), int(offset), x_addr, y.data_ptr(),
                             size):
        err = lib.zo_threefry_whole(
            None if x is None else x_addr + ln.start * size,
            y.data_ptr() + ln.start * size, ln.n, ln.head, ln.nvec,
            DTYPE_CODES[y.dtype], k0, k1, ln.hi, ln.lo, *scal, stream)
        _build.check(lib, err, "zo_affine_threefry")
        _build.count("zo_affine_threefry", route)
    return y


def _launch_original(lib, x, y, key, bands, offset: int, total: int,
                     bw: int, scal, stream) -> torch.Tensor:
    """X1's original-layout launches for a CUDA leaf (see
    ``zo_affine_threefry``)."""
    m = draw_words(total, bw)
    keys = block_keys(key, m)
    xp = None if x is None else _build.ptr(x)
    name = "zo_affine_threefry_original"
    if bands is None:
        e_hi = offset + y.numel()
        for ln in original_launches(offset, e_hi, total, bw):
            k0, k1 = keys[ln.block]
            route = original_route(ln, offset, bw, y.element_size(),
                                   None if x is None else x.data_ptr(),
                                   y.data_ptr())
            err = lib.zo_threefry_original(
                xp, _build.ptr(y), DTYPE_CODES[y.dtype], k0, k1, ln.wbase,
                ln.m, ln.h, ln.p0, ln.np, offset, e_hi, offset, bw, *scal,
                stream)
            _build.check(lib, err, name)
            _build.count(name, "pairs", f"pairs/{route}")
        return y
    for blk, group in _original_bands(bands, offset, bw):
        bl = torch.tensor(group, dtype=torch.int64)
        lens = bl[:, 1] - bl[:, 0]
        starts = bl[:, 0].to(y.device)
        cum = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(lens, 0)]).to(y.device)
        mb = block_words(m, blk)
        k0, k1 = keys[blk]
        err = lib.zo_threefry_original_bands(
            xp, _build.ptr(y), DTYPE_CODES[y.dtype], k0, k1,
            blk * BLOCK_WORDS, mb, (mb + 1) // 2, offset, bw, *scal,
            _build.ptr(starts), _build.ptr(cum), len(group), int(lens.sum()),
            stream)
        _build.check(lib, err, name)
        _build.count(name, "bands")
    return y


def normal_f32_selftest(device="cuda") -> int:
    """X1's f32 gaussian over all 2²³ uniform mantissas (bits = m << 9)
    against ``normal_f32`` run through torch on the same card; returns the
    count of mantissas whose z bits differ."""
    lib = _lib()
    n = 1 << 23
    got = torch.empty(n, dtype=torch.float32, device=device)
    _build.check(lib, lib.zo_threefry_normal_f32(_build.ptr(got), 0, n,
                                                 _build.stream_of(got)),
                 "zo_threefry_normal_f32")
    bad = 0
    for lo in range(0, n, 1 << 21):
        bits = torch.arange(lo, lo + (1 << 21), dtype=torch.int64,
                            device=device) << 9
        want = normal_f32(bits)
        bad += int((got[lo:lo + (1 << 21)].view(torch.int32)
                    != want.view(torch.int32)).sum())
    return bad


def table_selftest(dtype: torch.dtype, device="cuda") -> int:
    """The kernel's bf16 / f16 gaussian table against ``half_table``;
    returns the count of entries whose bits differ."""
    lib = _lib()
    n = 256 if dtype == torch.bfloat16 else 1024
    got = torch.empty(n, dtype=torch.float32, device=device)
    _build.check(lib, lib.zo_threefry_table(_build.ptr(got),
                                            DTYPE_CODES[dtype],
                                            _build.stream_of(got)),
                 "zo_threefry_table")
    want = _half_table(dtype).to(device)
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())

