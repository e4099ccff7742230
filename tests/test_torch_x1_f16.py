"""X1's f16 writes and the Python side of X1's whole route.

**The f16 rule.**  On a host with native half-precision FMAs (AVX512-FP16),
XLA:CPU compiles the ``xla`` backend's f16 writes as it compiles the f32
ones: its algebraic simplifier folds z's √2 (and any z scale) into the
scalar that multiplies z, each scalar product rounded to f16, and one
multiply is contracted into each add as a native f16 FMA — the exact value
rounded once.  With u the unit (gaussian: erf_inv(u16) rounded to f16,
rademacher: ±1) and k, b, e the folded scalars (``kernel.folded_scalars``):

    z        rn(u·k)
    axpbz    fma(a, x, rn(u·b))        (apply_rank1)
    xpbz     fma(u, b, x)              (perturb, perturb_many)
    restore  fma(a, fma(u, e, x), rn(u·b))   (fused_restore_update)

The port writes that rule on every host.  These tests hold the plain X1 and
every backend method to a numpy definition of it bitwise, the numpy FMA to
an exact rational rounding, and X1's unit table to JAX's erf_inv.  A host
whose XLA:CPU promotes half ops to f32 rounds some ties otherwise (the
first of ``XPBZ_TIES`` tells the two forms apart); the backend's writes
are held to JAX bitwise where this host's XLA:CPU takes the native form
(``xla_f16_native`` in ``test_torch_xla_stream.py``).

**The whole route.**  A CUDA call over a whole leaf is cut into launches
where the counter reaches a multiple of 2³¹ (``kernel.whole_launches``), so
no launch's counters cross 2³² and their high word is a launch constant;
each launch runs 16-byte vectors between a scalar head and tail.  The split
is emulated here on sizes and offsets that straddle 16 bytes, 2³¹ and 2³².
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax import lax

from repro_torch.kernels.threefry import kernel as X1
from repro_torch.perturb import get_backend
from repro_torch.perturb.stream import StreamRef, fold_in, prng_key

torch.set_num_threads(1)   # under xdist: no oversubscription

F16 = np.float16
SQRT2_F16 = F16(1.4140625)
FORMS = ["z", "axpbz", "xpbz", "restore"]
# x, z, s of x + s·z (xpbz, as bits) where one f16 FMA and "f32, then
# round to f16" part: the f32 sum lands on an f16 rounding tie
XPBZ_TIES = [  # x, z, s, fma16, f32 then f16
    (0xC019, 0x3BCF, 0x1419, 0xC019, 0xC018),     # -2.049 + 1e-3 · 0.976
    (0x3C37, 0x37CF, 0x1419, 0x3C37, 0x3C38),
    (0xC19B, 0xBBCF, 0x1419, 0xC19B, 0xC19C),
    (0xC101, 0x3BCF, 0x1419, 0xC101, 0xC100),
]
# a, x, rn(b·z) of a·x + rn(b·z) (axpbz), as bits
AXPBZ_TIES = [  # a, x, zb, fma16, f32 then f16
    (0x3BFE, 0x1001, 0x3C7D, 0x3C7D, 0x3C7E),
    (0x3BFE, 0x2401, 0x3FF7, 0x4003, 0x4004),
    (0x3BFE, 0xB001, 0xC3D7, 0xC40B, 0xC40C),
]


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _h(bits: int) -> np.float16:
    return np.array(bits, np.uint16).view(F16)[()]


# --------------------------------------------------------------------------- #
# The numpy definition of the rule
# --------------------------------------------------------------------------- #
def fma16(a, b, c) -> np.ndarray:
    """a·b + c of f16 values rounded once to f16: the f64 product is exact
    (22 significant bits), TwoSum gives the f64 sum's error, rounding to
    odd keeps the sticky bit, and numpy's f64 → f16 conversion rounds once
    (53 ≥ 11 + 2 bits)."""
    a, b, c = (np.asarray(v, F16).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64)
    odd = (err != 0) & ((bits & 1) == 0)
    bits = np.where(odd, bits + np.where((err > 0) == (s > 0), 1, -1), bits)
    return bits.view(np.float64).astype(F16)


def rn16(a, b) -> np.ndarray:
    """The f16 product of f16 values, rounded once (exact in f64)."""
    return (np.asarray(a, F16).astype(np.float64)
            * np.asarray(b, F16).astype(np.float64)).astype(F16)


def folded16(dist: str, b, e, zs):
    """(k, b, e) of an f16 write: √2 (gaussian) times the z scale, then
    times b and e, each product rounded to f16."""
    k = SQRT2_F16 if dist == "gaussian" else F16(1.0)
    if zs is not None:
        k = rn16(k, zs)
    return k, rn16(k, b), rn16(k, e)


def write16(form: str, x, u, a, b, e, k) -> np.ndarray:
    if form == "z":
        return rn16(u, k)
    if form == "axpbz":
        return fma16(a, x, rn16(u, b))
    if form == "xpbz":
        return fma16(u, b, x)
    return fma16(a, fma16(u, e, x), rn16(u, b))


def jax_unit_table() -> np.ndarray:
    """erf_inv of the 1024 f16 uniforms of ``jax.random.normal``, as JAX
    computes it: u = max(lo, 2·(m·2⁻¹⁰) + lo) in f16, erf_inv in f16."""
    m = np.arange(1024, dtype=np.uint16)
    f = (m | np.uint16(0x3C00)).view(F16) - F16(1.0)        # exact
    lo = np.nextafter(F16(-1.0), F16(0.0))
    u = np.maximum(lo, (f * F16(2.0) + lo).astype(F16))     # 2f exact
    return np.asarray(jax.jit(lax.erf_inv)(jnp.asarray(u)))


def unit16(key, n: int, dist: str, table: np.ndarray,
           offset: int = 0) -> np.ndarray:
    bits = X1.threefry_bits(key, torch.arange(offset, offset + n)).numpy()
    if dist == "rademacher":
        return np.where(bits >= 1 << 31, F16(-1.0), F16(1.0))
    return table[(bits & 0xFFFF) >> 6]


@pytest.fixture(scope="module")
def table():
    return jax_unit_table()


# --------------------------------------------------------------------------- #
# The rule's pieces
# --------------------------------------------------------------------------- #
def _exact_f16(q: Fraction) -> int:
    """The f16 nearest the rational q (ties to an even mantissa), as bits."""
    v = F16(float(q))
    cands = [np.nextafter(v, F16(-np.inf)), v, np.nextafter(v, F16(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.array(c).view(np.uint16)) & 1))
    return int(np.array(best).view(np.uint16))


def test_fma16_is_one_rounding_of_the_exact_value():
    """The numpy FMA against exact rational arithmetic, on random f16
    triples (subnormal products and cancellations among them) and the
    written-out ties."""
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(3000) * 4.0 ** rng.integers(-6, 4, 3000))
    trip = [a.astype(F16), np.roll(a, 7).astype(F16),
            (-np.roll(a, 11) * 1e-3).astype(F16)]
    trip = [np.concatenate([t, [_h(c[i]) for c in XPBZ_TIES]])
            for i, t in zip((1, 2, 0), trip)]
    got = fma16(*trip).view(np.uint16)
    for i in range(len(got)):
        q = (Fraction(float(trip[0][i])) * Fraction(float(trip[1][i]))
             + Fraction(float(trip[2][i])))
        if q != 0:       # the sign of an exact zero is the rule's, not q's
            assert int(got[i]) == _exact_f16(q), i


def test_double_rounding_ties_written_out():
    """On each tie the f16 FMA, the numpy rule and the port's ``_fma16``
    agree, and "f32, then round to f16" lands one ulp away."""
    for x, z, s, want, promoted in XPBZ_TIES:
        assert int(fma16(_h(z), _h(s), _h(x)).view(np.uint16)) == want
        f32 = np.float32(_h(x)) + np.float32(_h(s)) * np.float32(_h(z))
        assert int(F16(f32).view(np.uint16)) == promoted != want
        port = X1._fma16(*(torch.tensor([float(_h(v))]) for v in (z, s, x)))
        assert int(port.numpy().astype(F16).view(np.uint16)[0]) == want
    for a, x, zb, want, promoted in AXPBZ_TIES:
        assert int(fma16(_h(a), _h(x), _h(zb)).view(np.uint16)) == want
        f32 = np.float32(_h(a)) * np.float32(_h(x)) + np.float32(_h(zb))
        assert int(F16(f32).view(np.uint16)) == promoted != want
        port = X1._fma16(*(torch.tensor([float(_h(v))]) for v in (a, x, zb)))
        assert int(port.numpy().astype(F16).view(np.uint16)[0]) == want


def test_unit_table_is_jax_erf_inv(table):
    """X1's f16 table holds erf_inv(u) rounded to f16 — JAX's — and times
    √2 in f16 it is ``jax.random.normal``'s z."""
    port = X1._half_table(torch.float16).numpy().astype(F16)
    assert np.array_equal(port.view(np.uint16), table.view(np.uint16))
    jk = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    key = tuple(int(v) for v in jax.random.key_data(jk))
    z = np.asarray(jax.random.normal(jk, (1 << 14,), jnp.float16))
    want = rn16(unit16(key, 1 << 14, "gaussian", table), SQRT2_F16)
    assert np.array_equal(want.view(np.uint16), z.view(np.uint16))


# --------------------------------------------------------------------------- #
# The plain X1 and every backend method against the rule
# --------------------------------------------------------------------------- #
N = 4099


def _x(seed=0, n=N) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 2.0).astype(F16)


@pytest.mark.parametrize("zs", [None, 0.8125], ids=["plain", "zscaled"])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_x1_f16_is_the_rule(form, dist, zs, table):
    key = fold_in(prng_key(3), 11)
    x = _x()
    a, b, e = F16(0.999), F16(-2e-3), F16(1e-3)
    out = torch.empty(N, dtype=torch.float16)
    got = X1.zo_affine_threefry_plain(
        None if form == "z" else torch.from_numpy(x), key, form, float(a),
        float(b), float(e), zs, dist, out=out)
    k, bf, ef = folded16(dist, b, e, zs)
    want = write16(form, x, unit16(key, N, dist, table), a, bf, ef, k)
    assert np.array_equal(got.numpy().view(np.uint16), want.view(np.uint16))


def _f16_scalar(v) -> np.float16:
    """``jnp.asarray(v, f16)`` of an f32 scalar."""
    return F16(np.float32(v))


METHODS = ["perturb", "restore", "rank1", "rank1_dz", "leaf_z",
           "perturb_many"]


@pytest.mark.parametrize("dist", ["gaussian", "rademacher", "sphere"])
@pytest.mark.parametrize("method", METHODS)
def test_backend_f16_writes_are_the_rule(method, dist, table):
    """Each ``XLABackend`` method on f16 leaves, written by the plain X1,
    against the rule with the scalars the method passes (sphere: the
    port's √d/‖z‖ as the z scale of perturb and restore; rank1 and leaf_z
    take the gaussian direction, as in JAX)."""
    tb = get_backend("xla")
    key = fold_in(prng_key(3), 11)
    ref = StreamRef(key)
    shapes = [(33, 65), (7,), (16, 24)]
    xs = [_x(i, int(np.prod(s))).reshape(s) for i, s in enumerate(shapes)]
    tree = {f"l{i}": torch.from_numpy(v.copy()) for i, v in enumerate(xs)}
    kdist = "gaussian" if dist == "sphere" else dist
    sph = (F16(tb._sphere_scale(tree, ref)) if dist == "sphere" else None)
    d = [np.float32(v) for v in (0.5, 1.7, 0.93)]
    if method == "perturb":
        got = tb.perturb(tree, ref, 1e-3, dist)
    elif method == "restore":
        got = tb.fused_restore_update(tree, ref, 1e-3, np.float32(0.0123),
                                      np.float32(1e-4), dist)
    elif method == "rank1":
        got = tb.apply_rank1(tree, ref, np.float32(0.37), np.float32(1e-3),
                             dist)
    elif method == "rank1_dz":
        got = tb.apply_rank1(tree, ref, np.float32(0.37), 0.0, dist,
                             d_tree={f"l{i}": v for i, v in enumerate(d)})
    elif method == "leaf_z":
        got = {f"l{i}": tb.leaf_z(ref, i, tree[f"l{i}"], dist)
               for i in range(len(xs))}
    else:
        scales = [1e-3, -2e-3]
        sphs = ([F16(tb._sphere_scale(tree, StreamRef(fold_in(key, j))))
                 for j in range(2)] if dist == "sphere" else [None, None])
        got = tb.perturb_many(tree, [StreamRef(fold_in(key, j))
                                     for j in range(2)], scales, dist)
    for i, x in enumerate(xs):
        lkey = fold_in(key, i)
        u = unit16(lkey, x.size, kdist, table).reshape(x.shape)
        if method == "perturb":
            want = write16("xpbz", x, u, 0, *folded16(
                kdist, _f16_scalar(1e-3), 0, sph)[1:2], 0, 0)
        elif method == "restore":
            k, b, e = folded16(kdist, -_f16_scalar(0.0123),
                               _f16_scalar(1e-3), sph)
            want = write16("restore", x, u, _f16_scalar(
                np.float32(1) - np.float32(1e-4)), b, e, k)
        elif method in ("rank1", "rank1_dz"):
            zs = _f16_scalar(d[i]) if method == "rank1_dz" else None
            decay = 1e-3 if method == "rank1" else 0.0
            k, b, e = folded16(kdist, -_f16_scalar(0.37), 0, zs)
            want = write16("axpbz", x, u, _f16_scalar(
                np.float32(1) - np.float32(decay)), b, e, k)
        elif method == "leaf_z":
            k = folded16(kdist, 0, 0, None)[0]
            want = write16("z", x, u, 0, 0, 0, k)
        else:
            want = np.stack([
                write16("xpbz", x, unit16(fold_in(StreamRef(
                    fold_in(key, j)).key, i), x.size, kdist,
                    table).reshape(x.shape), 0, folded16(
                        kdist, _f16_scalar(s), 0, sphs[j])[1], 0, 0)
                for j, s in enumerate(scales)])
        have = got[f"l{i}"].numpy()
        assert have.dtype == np.float16
        assert np.array_equal(have.view(np.uint16), want.view(np.uint16)), i


# --------------------------------------------------------------------------- #
# The whole route's launches
# --------------------------------------------------------------------------- #
SPAN = X1.LAUNCH_SPAN
PLANS = [  # n, offset, x misalignment (bytes), y misalignment (bytes)
    (1, 0, 0, 0), (7, 0, 0, 0), (8 * 5 + 3, 0, 0, 0), (4099, 0, 2, 2),
    (4099, 0, 2, 6), (4099, 0, 0, 8), (40, (1 << 32) - 17, 0, 0),
    (40, (1 << 31) - 3, 4, 4), (SPAN + 100, 5, 0, 0),
    (2 * SPAN + 9, (1 << 32) - SPAN - 4, 6, 6), (33, (1 << 33) + 1, 0, 0),
]


def _kernel_indices(ln, per_vec) -> list:
    """The element indices a launch's threads write, in the order of the
    kernel's two loops: vectors of ``per_vec`` from ``head``, then the
    scalar loop's r → r (head) or head + nvec·per_vec + (r − head)."""
    vec = [ln.head + v * per_vec + j for v in range(ln.nvec)
           for j in range(per_vec)]
    body_end = ln.head + ln.nvec * per_vec
    rest = [r if r < ln.head else body_end + (r - ln.head)
            for r in range(ln.n - ln.nvec * per_vec)]
    return vec + rest


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,offset,mx,my", PLANS)
def test_whole_launches_split(n, offset, mx, my, itemsize):
    """The launches cover the leaf in order; no launch is longer than 2³¹
    or lets its counter's low word run past 2³² (so hi is constant); the
    head ends on x's first 16-byte boundary and the vectors start there,
    or every element is scalar when x and y lie differently against 16
    bytes; each launch's two loops write each of its elements once."""
    x_addr, y_addr = 4096 + mx, 8192 + my
    launches = X1.whole_launches(n, offset, x_addr, y_addr, itemsize)
    per_vec = 16 // itemsize
    start = 0
    for ln in launches:
        assert ln.start == start and 0 < ln.n <= SPAN
        c = offset + ln.start
        assert (ln.hi, ln.lo) == (c >> 32, c & 0xFFFFFFFF)
        assert ln.lo + ln.n <= 1 << 32
        assert ln.start == 0 or c % SPAN == 0       # cut at multiples of 2³¹
        xa, ya = x_addr + ln.start * itemsize, y_addr + ln.start * itemsize
        co = xa % 16 == ya % 16 and xa % itemsize == 0
        if co:
            assert (xa + ln.head * itemsize) % 16 == 0 or ln.head == ln.n
            assert ln.head < per_vec
            assert ln.n - ln.head - ln.nvec * per_vec < per_vec
        else:
            assert (ln.head, ln.nvec) == (ln.n, 0)
        if ln.n < 1 << 16:
            assert sorted(_kernel_indices(ln, per_vec)) == list(range(ln.n))
        start += ln.n
    assert start == n
    route = X1.launch_route(x_addr, y_addr, itemsize)
    aligned = (x_addr - y_addr) % 16 == 0 and x_addr % itemsize == 0
    assert route == ("vector" if aligned else "scalar")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("offset", [(1 << 32) - 17, (1 << 31) - 3,
                                    (1 << 33) + 5])
def test_whole_launches_reproduce_the_leaf(offset, dtype):
    """Each launch run as the plain X1 with its own counter base (hi, lo)
    writes exactly the whole call's elements: a call whose counters cross
    2³² is two launches, each with its constant high word."""
    key = fold_in(prng_key(4), 2)
    n = 40
    x = torch.from_numpy(_x(1, n).astype(np.float32)).to(dtype)
    whole = X1.zo_affine_threefry_plain(x, key, "axpbz", a=0.5, b=-0.25,
                                        offset=offset)
    parts = torch.empty_like(x)
    launches = X1.whole_launches(n, offset, 0, 0, x.element_size())
    if offset % (1 << 31) > (1 << 31) - n:
        assert len(launches) == 2 and launches[1].lo % (1 << 31) == 0
    for ln in launches:
        sl = slice(ln.start, ln.start + ln.n)
        X1.zo_affine_threefry_plain(x[sl], key, "axpbz", a=0.5, b=-0.25,
                                    out=parts[sl],
                                    offset=(ln.hi << 32) | ln.lo)
    assert torch.equal(parts.view(torch.int8), whole.view(torch.int8))
