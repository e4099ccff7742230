"""Port: the vector walk of K7 ``zo_affine_rows`` and K9
``zo_affine_chain_rows``, emulated on the CPU.

On the card, K7 and K9 take one 16-byte vector of N = 16 / itemsize
consecutive compact indices per grid-stride step when a row-block is a
whole number of vectors and the leaf starts on 16 bytes (``rows_route`` →
``"vector"``): vector v's block is q = v // (block_elems / N), found by a
multiply-high divide whose constants ``_vector_divide`` computes, and its
first flat element is

    e0 = phase·be + v·N + q·(k − 1)·be   (mod 2^32);

the compact indices past the last whole vector take the scalar loop.  Here
that walk is repeated in numpy and held to ``compact_to_flat``: every
selected element is visited exactly once, no vector crosses a block
boundary, every vector starts on a multiple of N elements (16 bytes), and
the divide is exact at every block boundary of the registry's row widths.
The kernels are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro_torch.kernels.zo_fused.rows import (_plan, _vector_divide,
                                               compact_to_flat,
                                               divisor_magic, rows_route,
                                               selected_count)
from repro_torch.models import all_archs
from repro_torch.select import parse_selection

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

U32 = (1 << 32) - 1
#: vectors enumerated one by one up to this many, else sampled at every
#: block boundary and at both ends
FULL_WALK = 1 << 22

#: every block_elems (clamped to the leaf) of the registry's leaves under
#: rows(block=1) and rows(block=4)
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

#: the plans of the walk's sweep: 1-D leaves (1), odd widths (3, 67),
#: one vector (8), qwen2-0.5b's bias, hidden and MLP widths and its
#: stacked MLP row-block (896·4864)
SWEEP_BE = [1, 3, 8, 67, 128, 896, 4864, 896 * 4864]


def divide_magic(j, mul: int, shifts: int):
    """``j // d`` by the kernel's multiply-high and shifts (j: an int or a
    uint64 numpy array of 32-bit values)."""
    hi = (j * mul) >> 32
    return (hi + ((j - hi) >> (shifts & 0xFF))) >> (shifts >> 8)


def _ragged(be: int, k: int) -> int:
    """A leaf of k + 1 whole row-blocks and a ragged last one (phase 1 of
    k > 1, phase 0 of k = 1, selects the ragged block)."""
    return be * (k + 1) + max(1, be // 3)


def _walk(n: int, block_elems: int, k: int, phase: int, N: int) -> tuple:
    """K7 / K9's walk on the vector route: (the vectors v it checks, their
    e0, the flat indices of the scalar tail).  Every vector when there are
    at most ``FULL_WALK``, else those at both ends of every selected block."""
    n, be, k, phase = _plan(n, block_elems, k, phase)
    sel = selected_count(n, be, k, phase)
    mul, shifts = _vector_divide(be, 16 // N)
    nvec = sel // N
    if nvec <= FULL_WALK:
        v = np.arange(nvec, dtype=np.uint64)
    else:
        bv = be // N
        q = np.arange(-(-nvec // bv) + 1, dtype=np.uint64) * np.uint64(bv)
        ends = np.array([0, nvec - 1], dtype=np.uint64)
        v = np.unique(np.concatenate([q, q - np.uint64(1), ends]))
        v = v[v < nvec]
    q = divide_magic(v, mul, shifts)
    m32 = np.uint64(U32)
    gap = np.uint64(((k - 1) * be) & U32)
    e0 = (np.uint64(phase * be) + v * np.uint64(N) + q * gap) & m32
    tail = compact_to_flat(torch.arange(nvec * N, sel, dtype=torch.int64),
                           be, k, phase).numpy()
    return v, e0, tail


def _check_walk(n: int, block_elems: int, k: int, phase: int, N: int):
    n, be, k, phase = _plan(n, block_elems, k, phase)
    sel = selected_count(n, be, k, phase)
    v, e0, tail = _walk(n, be, k, phase, N)
    nvec = sel // N
    assert tail.size == sel - nvec * N < N
    want = compact_to_flat(torch.from_numpy(v.astype(np.int64)) * N, be, k,
                           phase).numpy().astype(np.uint64)
    assert np.array_equal(e0, want)
    last = e0 + np.uint64(N - 1)
    be64 = np.uint64(be)
    # one block, a selected one, inside the leaf, on 16 bytes
    assert np.array_equal(e0 // be64, last // be64)
    assert np.all((e0 // be64) % np.uint64(k) == np.uint64(phase))
    assert np.all(last < np.uint64(n)) and np.all(e0 % np.uint64(N) == 0)
    if v.size == nvec and sel <= FULL_WALK:
        # exactly once each: the lanes of every vector, then the tail, in
        # compact order
        lanes = (e0[:, None] + np.arange(N, dtype=np.uint64)[None, :])
        got = np.concatenate([lanes.reshape(-1), tail.astype(np.uint64)])
        flat = compact_to_flat(torch.arange(sel, dtype=torch.int64), be, k,
                               phase).numpy().astype(np.uint64)
        assert np.array_equal(got, flat)
        assert np.unique(got).size == sel


# --------------------------------------------------------------------------- #
# The route
# --------------------------------------------------------------------------- #
def _meta(shape, dtype=torch.bfloat16) -> torch.Tensor:
    """A leaf at address 0 (16-byte aligned) without its memory."""
    return torch.empty(shape, dtype=dtype, device="meta")


def test_rows_route_rule():
    """vector: 16-byte start and a row-block of whole 16-byte vectors
    (block_elems clamped to the leaf); scalar otherwise."""
    assert rows_route(_meta((301, 64)), 64) == "vector"
    assert rows_route(_meta((301, 64)), 3 * 64) == "vector"
    assert rows_route(_meta((301, 67)), 67) == "scalar"
    assert rows_route(_meta((896,)), 1) == "scalar"
    assert rows_route(_meta((4, 4), torch.float32), 4) == "vector"
    assert rows_route(_meta((4, 4), torch.bfloat16), 4) == "scalar"
    assert rows_route(_meta((4, 4), torch.float16), 8) == "vector"
    assert rows_route(_meta((8,)), 100) == "vector"        # be clamped to 8
    assert rows_route(_meta((9,)), 100) == "scalar"        # … to 9
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = torch.zeros(1000, dtype=dtype)
        assert x.data_ptr() % 16 == 0
        assert rows_route(x[:896], 64) == "vector"
        assert rows_route(x[1:897], 64) == "scalar"        # an offset view
        assert rows_route(x[8:904], 64) == "vector"        # 16 bytes on
    assert rows_route(_meta((1000,))[1:897], 64) == "scalar"


def test_rows_route_qwen2_leaves():
    """Under rows(block=1,k=4) every partial qwen2-0.5b leaf takes the
    vector route at every phase, except the 1-D ln_f scale (be = 1)."""
    cfg = jax_archs()["qwen2-0.5b"].cfg
    shapes = jax.eval_shape(jax_bundle(cfg).init, jax.random.PRNGKey(0))
    sel = parse_selection("rows(block=1,k=4)")
    seen = {"vector": 0, "scalar": 0}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        name = jax.tree_util.keystr(path)
        x = _meta(leaf.shape, getattr(torch, str(leaf.dtype)))
        for phase in range(4):
            rb = sel.block_mask(leaf, phase)
            assert not rb.all_selected and rb.selected_elems() > 0
            route = rows_route(x, rb.block_elems)
            want = "scalar" if name == "['ln_f']['scale']" else "vector"
            assert route == want, (name, rb.block_elems)
            seen[route] += 1
    assert seen == {"vector": 14 * 4, "scalar": 4}


# --------------------------------------------------------------------------- #
# The divide
# --------------------------------------------------------------------------- #
def test_registry_row_widths_give_these_plans():
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


#: (vectors per block, N) of every registry row width that holds whole
#: vectors, powers of two left to the shift test
VECTOR_DIVISORS = sorted({(be // N, N) for be in REGISTRY_BE for N in (4, 8)
                          if be % N == 0 and (be // N) & (be // N - 1)})


@pytest.mark.parametrize("bv,N", VECTOR_DIVISORS,
                         ids=[f"{bv}x{N}" for bv, N in VECTOR_DIVISORS])
def test_vector_divide_exact_at_every_block_boundary(bv, N):
    """q·bv − 1 and q·bv for every q with q·bv a vector index (< 2^32 / N):
    the only places a wrong multiplier could first round the quotient
    off."""
    mul, shifts = _vector_divide(bv * N, 16 // N)
    last = (U32 // N) // bv
    for lo in range(1, last + 1, 1 << 21):
        q = np.arange(lo, min(lo + (1 << 21), last + 1), dtype=np.uint64)
        for v, want in ((q * np.uint64(bv), q),
                        (q * np.uint64(bv) - np.uint64(1), q - np.uint64(1))):
            assert np.array_equal(divide_magic(v, mul, shifts), want)


@pytest.mark.parametrize("be", [8, 16, 128, 512, 65536, 262144])
@pytest.mark.parametrize("N", [4, 8])
def test_vector_divide_by_a_power_of_two_is_a_shift(be, N):
    mul, shifts = _vector_divide(be, 16 // N)
    bv = be // N
    assert mul == 1 and (shifts & 0xFF) + (shifts >> 8) == bv.bit_length() - 1
    v = np.arange(U32 // N - (1 << 16), U32 // N + 1, dtype=np.uint64)
    assert np.array_equal(divide_magic(v, mul, shifts), v // np.uint64(bv))


def test_vector_divide_is_divisor_magic_of_the_vectors_per_block():
    for be, size in ((896, 2), (896, 4), (4864, 2), (151936, 4), (8, 2),
                     (4, 4)):
        mul, sh1, sh2 = divisor_magic(be * size // 16)
        assert _vector_divide(be, size) == (mul, sh1 | sh2 << 8)
    # a block of no whole vector: the scalar route reads neither
    assert _vector_divide(3, 2) == _vector_divide(1, 4) == (1, 0)


# --------------------------------------------------------------------------- #
# The walk
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("N", [4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("be", SWEEP_BE)
def test_vector_walk_visits_every_selected_element_once(be, k, N):
    """Every phase of a leaf of k + 1 whole blocks and a ragged one, and of
    one of whole blocks only: the vector route's walk (or, where a block is
    no whole number of vectors, the scalar route's) visits
    compact_to_flat(arange(sel)) once each."""
    itemsize = 16 // N
    x = _meta((1,), {2: torch.bfloat16, 4: torch.float32}[itemsize])
    for n in (_ragged(be, k), be * (k + 2)):
        for phase in range(k):
            if selected_count(n, be, k, phase) == 0:
                continue
            if be % N:
                assert rows_route(x.expand(n), be) == "scalar"
                continue
            assert rows_route(x.expand(n), be) == "vector"
            _check_walk(n, be, k, phase, N)


@pytest.mark.parametrize("be", REGISTRY_BE)
def test_vector_walk_at_the_registry_widths(be):
    """The walk at every registry row width under k = 4, every phase, a
    ragged last block: sampled at every block boundary where a leaf holds
    more than FULL_WALK vectors."""
    for N in (4, 8):
        if be % N:
            continue
        n = min(_ragged(be, 4), U32)
        for phase in range(4):
            _check_walk(n, be, 4, phase, N)


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 5000), be=st.integers(1, 600), k=st.integers(1, 5),
       phase=st.integers(0, 4), N=st.sampled_from([4, 8]))
def test_vector_walk_property(n, be, k, phase, N):
    phase %= k
    n, be, k, phase = _plan(n, be, k, phase)
    if be % N or selected_count(n, be, k, phase) == 0:
        return
    _check_walk(n, be, k, phase, N)
