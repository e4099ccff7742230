"""Port parity: K10 over many partial rows leaves in one call
(``zo_sqnorm_rows_many``) and the sphere rescale built on it.

``zo_sqnorm_rows_many`` measures every partial rows leaf of a sphere pass in
one launch on the card; each leaf's norm must keep the bits
``zo_sqnorm_rows`` gives it alone (the fixed per-tile order of
``zo_sqnorm_rows_plain``) and stay within ``SQNORM_RTOL`` of JAX's
``zo_sqnorm_rows_ref``.  The kernel maps compact to flat indices without a
hardware division, by constants that ``_rows_leaf`` computes in Python:
here they are proven — the divide against ``//`` at every block boundary
of the registry's row widths and by a property over random operands, and
the kernel's whole index walk (divide at a tile's first index, carry on
each step of 1 024) against ``compact_to_flat``.  On the CPU every call
runs the plain versions; the kernel is held to them on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.zo_fused.rows import (tile_plan, zo_sqnorm_2d_rows,
                                         zo_sqnorm_rows_ref)
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro_torch.kernels.zo_fused.kernel import IDX_MUL
from repro_torch.kernels.zo_fused.multi import TILE_ELEMS
from repro_torch.kernels.zo_fused.rows import (ROWS_MAX_LEAVES, SQNORM_RTOL,
                                               _plan, _rows_leaf,
                                               compact_to_flat,
                                               divisor_magic,
                                               zo_sqnorm_rows,
                                               zo_sqnorm_rows_many,
                                               zo_sqnorm_rows_many_plain,
                                               zo_sqnorm_rows_plain)
from repro_torch.models import all_archs, bundle
from repro_torch.perturb import CounterBackend, StreamRef, prng_key
from repro_torch.perturb import counter
from repro_torch.select import parse_selection
from repro_torch.tree_utils import tree_leaves

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

U32 = (1 << 32) - 1
TILE_THREADS = 1024

#: (n, block_elems, k, phase): be below, at and above 1 024 (and 1), be not
#: dividing n, phases 0 and k − 1, selections below, at and across one tile
PLANS = [
    (2747, 201, 2, 1),                   # be < 1024, ragged last block
    (100_003, 1, 2, 0),                  # be = 1 (a 1-D leaf's rows)
    (4 * 1024 * 40, 1024, 4, 3),         # be = 1024, phase k − 1
    (300_001, 7 * 40, 3, 2),             # ragged, phase k − 1
    (4 * TILE_ELEMS, 896, 4, 0),         # sel = TILE_ELEMS exactly
    (4 * TILE_ELEMS - 896, 896, 4, 0),   # sel just below one tile
    (4 * TILE_ELEMS + 5 * 896, 896, 4, 1),   # sel across one tile
    (3 * 5000 + 77, 5000, 2, 1),         # be > 1024, not dividing n
    (9000, 20_000, 3, 0),                # be clamped to n: one block
]
SEEDS = [11, -5, 2**31 - 1, 977, 3, 123456789, -2**31, 42]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def divide_magic(j, d_magic: tuple):
    """``j // d`` by ``divisor_magic(d)``'s multiply-high and shifts, as the
    kernel computes it (j: an int or a uint64 numpy array of 32-bit
    values)."""
    mul, sh1, sh2 = d_magic
    hi = (j * mul) >> 32
    return (hi + ((j - hi) >> sh1)) >> sh2


def _walk(n: int, block_elems: int, k: int, phase: int) -> np.ndarray:
    """e·IDX_MUL (mod 2^32) at every compact index, in compact order, as
    ``rows_tile_sums`` computes it from ``_rows_leaf``'s fields: thread t of
    a tile divides its first index j = tile·TILE_ELEMS + t by the
    multiply-high and shifts, then steps j by 1 024 with the carry."""
    sel, _, be, mul, shifts, e0, kbe, thresh, up, step0, step1 = (
        np.uint64(v) for v in _rows_leaf(n, 0, block_elems, k, phase))
    m32 = np.uint64(U32)
    down = (np.uint64(1 << 32) - thresh) & m32
    tiles = -(-int(sel) // TILE_ELEMS)
    out = np.empty((tiles, TILE_ELEMS // TILE_THREADS, TILE_THREADS),
                   dtype=np.uint64)
    j = (np.arange(tiles, dtype=np.uint64)[:, None] * np.uint64(TILE_ELEMS)
         + np.arange(TILE_THREADS, dtype=np.uint64)[None, :])
    q = divide_magic(j, (int(mul), int(shifts) & 0xFF, int(shifts) >> 8))
    r = (j - q * be) & m32
    im = ((e0 + q * kbe + r) * np.uint64(IDX_MUL)) & m32
    for step in range(out.shape[1]):
        out[:, step] = im
        carry = r >= thresh
        r = (r + np.where(carry, down, up)) & m32
        im = (im + np.where(carry, step1, step0)) & m32
    return out.reshape(-1)[:int(sel)]


# --------------------------------------------------------------------------- #
# The constants: the divide and the index walk
# --------------------------------------------------------------------------- #
#: every block_elems (clamped to the leaf) of the registry's leaves under
#: rows(block=1) and rows(block=4) — 1-D leaves give 1 and 4, the stacked
#: biases 128 and 512, the MLP leaves millions
REGISTRY_BE = [1, 2, 4, 8, 25, 100, 128, 512, 896, 1024, 1280, 1536, 1600,
               2048, 2560, 3072, 3584, 4096, 5120, 6144, 6400, 7168, 9216,
               10240, 12288, 14336, 16384, 18432, 20480, 28672, 32000, 32128,
               32768, 36864, 40000, 49280, 50304, 51968, 61440, 64000, 65536,
               73728, 114688, 128000, 128512, 131072, 151936, 152064, 160000,
               163840, 197120, 201216, 207872, 245760, 256000, 262144, 458752,
               512000, 607744, 608256, 640000, 655360, 786432, 802816, 1048576,
               1638400, 1835008, 2048000, 2097152, 2359296, 2560000, 3145728,
               3211264, 4194304, 4358144, 5120000, 6553600, 7340032, 8388608,
               8806400, 9437184, 10240000, 12845056, 16777216, 17432576,
               20480000, 22937600, 25165824, 26214400, 28311552, 31457280,
               35225600, 37748736, 45088768, 51380224, 67108864, 67895296,
               91750400, 100663296, 104857600, 113246208, 125829120, 180355072,
               205520896, 271581184, 419430400]


def test_registry_row_widths_are_the_archs():
    """REGISTRY_BE is what the archs the port carries give, from JAX's
    shapes of their leaves — those below 2^32 elements, the only ones a
    rows plan takes (a larger leaf is refused: its counter indices would
    pass the z stream's 2^32)."""
    widths = set()
    archs = jax_archs()
    for name in all_archs():
        shapes = jax.eval_shape(jax_bundle(archs[name].cfg).init,
                                jax.random.PRNGKey(0))
        for R in (1, 4):
            sel = parse_selection(f"rows(block={R},k=4)")
            for leaf in jax.tree_util.tree_leaves(shapes):
                if leaf.size >= 1 << 32:     # the rows kernels refuse it
                    continue
                rb = sel.block_mask(leaf, 0)
                widths.add(min(rb.block_elems, rb.size))
    assert sorted(widths) == REGISTRY_BE


@pytest.mark.parametrize("be", [be for be in REGISTRY_BE if be >= 128])
def test_divide_exact_at_every_block_boundary(be):
    """q·be − 1 and q·be for every q with q·be < 2^32: the only places a
    wrong multiplier could first round the quotient off."""
    d_magic = divisor_magic(be)
    last = U32 // be
    for lo in range(1, last + 1, 1 << 21):
        q = np.arange(lo, min(lo + (1 << 21), last + 1), dtype=np.uint64)
        for j, want in ((q * np.uint64(be), q),
                        (q * np.uint64(be) - np.uint64(1), q - np.uint64(1))):
            got = divide_magic(j, d_magic)
            assert np.array_equal(got, want)
            assert np.array_equal(j - got * np.uint64(be), j % np.uint64(be))


@pytest.mark.parametrize("be", [1, 2, 4, 128, 512, 65536, 1 << 31])
def test_divide_by_a_power_of_two_is_a_shift(be):
    """be = 2^s (be = 1 and 4 among the registry's 1-D leaves): the
    multiplier is 1, so hi = 0 for every 32-bit j and the divide is j >> s
    — exact for every j; checked at both ends of the range too."""
    mul, sh1, sh2 = divisor_magic(be)
    assert mul == 1 and sh1 + sh2 == be.bit_length() - 1
    j = np.concatenate([np.arange(1 << 16, dtype=np.uint64),
                        np.arange(U32 - (1 << 16), U32 + 1, dtype=np.uint64)])
    assert np.array_equal(divide_magic(j, (mul, sh1, sh2)),
                          j // np.uint64(be))


@settings(max_examples=2000, deadline=None)
@given(be=st.integers(1, U32), j=st.integers(0, U32))
def test_divide_exact_property(be, j):
    q = divide_magic(j, divisor_magic(be))
    assert q == j // be and j - q * be == j % be


def test_divisor_out_of_range_is_refused():
    for bad in (0, 1 << 32):
        with pytest.raises(ValueError):
            divisor_magic(bad)


@pytest.mark.parametrize("plan", PLANS, ids=[str(p) for p in PLANS])
def test_index_walk_is_compact_to_flat(plan):
    """The kernel's e·IDX_MUL at every compact index (divide per tile
    thread, carry per step) equals compact_to_flat's, so the kernel's z
    are the plain version's."""
    n, be, k, phase = _plan(*plan)
    got = _walk(*plan)
    j = torch.arange(got.size, dtype=torch.int64)
    e = compact_to_flat(j, be, k, phase).numpy().astype(np.uint64)
    assert np.array_equal(got, (e * np.uint64(IDX_MUL)) & np.uint64(U32))


# --------------------------------------------------------------------------- #
# The many-call: every norm with its single-leaf bits
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_many_plain_is_the_per_leaf_plain_bitwise(dist):
    ns = [p[0] for p in PLANS]
    plans = [p[1:] for p in PLANS]
    seeds = SEEDS + [7]
    got = zo_sqnorm_rows_many_plain(ns, seeds, plans, dist)
    assert got.shape == (len(ns),) and got.dtype == torch.float32
    want = torch.stack([zo_sqnorm_rows_plain(n, s, *p, dist)
                        for n, s, p in zip(ns, seeds, plans)])
    assert np.array_equal(_bits(got), _bits(want))
    # the wrapper on a CPU device is the plain version
    assert np.array_equal(_bits(zo_sqnorm_rows_many(ns, seeds, plans, dist)),
                          _bits(want))


def test_many_longer_than_one_launch_table():
    """More leaves than one launch's table holds (the kernel runs them as
    consecutive launches): each norm still its own leaf's bits."""
    count = ROWS_MAX_LEAVES + 7
    ns = [500 + 13 * i for i in range(count)]
    plans = [(1 + i % 37, 2 + i % 3, i % (2 + i % 3)) for i in range(count)]
    seeds = [977 + 31 * i for i in range(count)]
    got = zo_sqnorm_rows_many(ns, seeds, plans)
    for n, s, p, norm in zip(ns, seeds, plans, got):
        assert np.array_equal(_bits(norm.reshape(1)),
                              _bits(zo_sqnorm_rows_plain(n, s, *p)
                                    .reshape(1)))


def test_single_leaf_entry_is_the_many_call():
    one = zo_sqnorm_rows(2747, 5, 201, 2, 1)
    assert one.dim() == 0 and one.dtype == torch.float32
    assert np.array_equal(_bits(one.reshape(1)),
                          _bits(zo_sqnorm_rows_many([2747], [5],
                                                    [(201, 2, 1)])))


@pytest.mark.parametrize("case", [
    ([], [], []), ([30], [1, 2], [(3, 2, 0)]), ([30], [1], []),
    ([20], [1], [(4, 8, 6)]), ([30], [1], [(0, 2, 0)])],
    ids=["empty", "seed-count", "plan-count", "selects-nothing",
         "bad-plan"])
def test_bad_leaf_lists_are_refused(case):
    with pytest.raises(ValueError):
        zo_sqnorm_rows_many(*case)
    with pytest.raises(ValueError):
        zo_sqnorm_rows_many_plain(*case)


@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_many_within_tolerance_of_jax(dist):
    """Each norm of one many-call against JAX's zo_sqnorm_rows_ref (its
    own flat-tile order: SQNORM_RTOL)."""
    cases = [p for p in PLANS if p[0] < 400_000]
    got = zo_sqnorm_rows_many([c[0] for c in cases], SEEDS[:len(cases)],
                              [c[1:] for c in cases], dist)
    for (n, be, k, phase), s, norm in zip(cases, SEEDS, got):
        sel, _ = tile_plan(n, be, k, phase)
        want = float(zo_sqnorm_rows_ref(n, s, sel, be, k, phase, dist=dist))
        assert abs(float(norm) - want) <= SQNORM_RTOL * want


def test_many_within_tolerance_of_the_jax_kernel():
    """Against JAX's Pallas kernel in interpret mode, as its own tests run
    it, on a ragged two-tile leaf."""
    n, be, k, phase = 2 * TILE_ELEMS - 777, 96 * 128, 2, 1
    sel, _ = tile_plan(n, be, k, phase)
    want = float(zo_sqnorm_2d_rows(n, 11, sel, be, k, phase, interpret=True))
    got = float(zo_sqnorm_rows_many([n], [11], [(be, k, phase)])[0])
    assert abs(got - want) <= SQNORM_RTOL * want


# --------------------------------------------------------------------------- #
# The sphere rescale: one K10 call for every partial rows leaf
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def smoke_params():
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    return bundle(cfg).init(0, device="cpu")


def _per_leaf_scale(params, ref) -> np.float32:
    """sqrt(d)/‖z‖ with one plain K6 or K10 per selected leaf, folded in
    leaf order in f32."""
    from repro_torch.kernels.zo_fused.multi import zo_sqnorm_plain
    from repro_torch.perturb.stream import leaf_seed
    seed = ref.counter_seed()
    mask, blocks = ref.selection_mask(params), ref.selection_blocks(params)
    d, sq = 0, None
    for i, p in enumerate(tree_leaves(params)):
        if not counter._active(p, mask, i):
            continue
        rb = counter._leaf_blocks(blocks, i)
        if rb is None:
            d += p.numel()
            part = zo_sqnorm_plain(p.numel(), leaf_seed(seed, i))
        else:
            d += rb.selected_elems()
            part = zo_sqnorm_rows_plain(p.numel(), leaf_seed(seed, i),
                                        rb.block_elems, rb.k, rb.phase)
        part = np.float32(part.item())
        sq = part if sq is None else np.float32(sq + part)
    return np.float32(np.sqrt(np.float32(np.float32(d) / sq)))


@pytest.mark.parametrize("spec,step,calls", [
    ("rows(block=1,k=4)", 0, (0, 1)), ("rows(block=1,k=4)", 3, (0, 1)),
    ("rows(block=2,k=4)", 0, (1, 1)), ("rows(block=2,k=4)", 1, (0, 1))],
    ids=["rows-0", "rows-3", "mixed-0", "rows2-1"])
def test_sphere_scale_one_rows_call_bitwise(smoke_params, monkeypatch, spec,
                                            step, calls):
    """Under rows(1,4) every leaf of the smoke tree is a partial plan: one
    K10 call measures them all; under rows(2,4) the two-row stacked leaves
    are whole at phase 0 (one K6 call and one K10 call, their norms folded
    back in leaf order) and unselected at phase 1 — bitwise the per-leaf
    fold every time."""
    made = {"whole": 0, "rows": 0}

    def spy(name, fn):
        def wrapped(*args, **kw):
            made[name] += 1
            return fn(*args, **kw)
        return wrapped
    monkeypatch.setattr(counter, "zo_sqnorm_many",
                        spy("whole", counter.zo_sqnorm_many))
    monkeypatch.setattr(counter, "zo_sqnorm_rows_many",
                        spy("rows", counter.zo_sqnorm_rows_many))
    ref = StreamRef.derive(prng_key(4), step, 1).with_selection(
        parse_selection(spec), step)
    got = CounterBackend()._sphere_scale(smoke_params, ref)
    assert (made["whole"], made["rows"]) == calls
    want = _per_leaf_scale(smoke_params, ref)
    assert np.float32(got).view(np.uint32) == want.view(np.uint32)
