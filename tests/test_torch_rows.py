"""Port parity: the sub-leaf kernels K7–K10 (``kernels/zo_fused/rows.py``,
plain versions) against JAX.

* K7 ``zo_affine_rows``, K8 ``zo_affine_multi_rows`` and K9
  ``zo_affine_chain_rows`` are held BITWISE to what JAX's rows kernels are
  specified to equal: the oracle ``ref.zo_affine_ref`` (and its multi / chain
  forms) on the selected elements, x's bits elsewhere — over 2-D, 3-D and 1-D
  leaves, f32 / bf16 / f16, gaussian / rademacher, R ∈ {1, 3, 96},
  k ∈ {1, 2, 3} and every phase.
* JAX's interpret-mode rows kernels are compared where they agree with the
  oracle.  On the 41 × 67 f32 gaussian leaf under rows(block=3, k=2) they do
  not: XLA:CPU contracts the interpreted graph into FMAs differently (the
  reference caveat of ROADMAP Queue 3; 61 and 37 of the selected elements at
  phases 0 and 1 on the machine these tests were written on).  The port
  follows the oracle there, and the test records the disagreement.
* K8 ≡ stacked K7, K9 ≡ sequential K7, ``k=1`` ≡ the whole-leaf kernels,
  writes in place, unselected bits untouched.
* K10 ``zo_sqnorm_rows`` sums in a fixed order of its own: within
  ``SQNORM_RTOL`` of JAX's ``zo_sqnorm_rows_ref``.

``tests/data/zo_rows_golden.npz`` carries JAX-computed K7–K10 values for
``chip_smoke.py`` and ``tests/test_torch_cuda.py``, which check the CUDA
kernels against it on a machine without JAX.  Regenerate it with
``PYTHONPATH=src python tests/test_torch_rows.py``.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.zo_fused import ref
from repro.kernels.zo_fused.rows import tile_plan, zo_sqnorm_rows_ref
from repro.perturb.pallas import zo_affine as jax_affine
from repro.select import leaf_row_blocks
from repro_torch.kernels.zo_fused.kernel import zo_affine
from repro_torch.kernels.zo_fused.multi import zo_affine_chain
from repro_torch.kernels.zo_fused.rows import (SQNORM_RTOL, selected_count,
                                               zo_affine_chain_rows,
                                               zo_affine_multi_rows,
                                               zo_affine_rows,
                                               zo_sqnorm_rows,
                                               zo_sqnorm_rows_plain)

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" / "zo_rows_golden.npz"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
SHAPES = [(41, 67), (3, 17, 29), (1000,)]        # 2-D, 3-D stacked, 1-D
SEEDS = [11, -5, 2**31 - 1, 977]
A = np.float32([0.999, 1.0, 0.5, 0.9990234375])
B = np.float32([-0.0123, 0.01, 0.25, -1e-3])


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


def _tbits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return t.view(torch.int32 if t.element_size() == 4
                  else torch.int16).numpy().view(
        np.uint32 if t.element_size() == 4 else np.uint16)


def _pair(shape, dt, seed=0):
    jdt, tdt = dt
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


def _mask(shape, R, k, phase) -> np.ndarray:
    rb = leaf_row_blocks(np.zeros(shape), R, k, phase)
    n = int(np.prod(shape))
    return np.asarray(rb.element_mask(np.arange(n))).reshape(shape), rb


def _plans():
    """(shape, R, k, phase) over the sweep, skipping empty phases (the
    selection layer leaves such a leaf out of the phase)."""
    for shape in SHAPES:
        for R in (1, 3, 96):
            for k in (1, 2, 3):
                for phase in range(k):
                    m, rb = _mask(shape, R, k, phase)
                    if m.any():
                        yield shape, R, k, phase, m, rb


# --------------------------------------------------------------------------- #
# K7 / K8 / K9 against the oracle, bitwise
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rows_kernels_bitwise_vs_masked_oracle(dt, dist):
    seen = 0
    for shape, R, k, phase, m, rb in _plans():
        xj, xt = _pair(shape, DTYPES[dt], seed=R + k)
        be = rb.block_elems
        xb = _bits(np.asarray(xj))
        # K7: the oracle on the selected elements, x's bits elsewhere
        want = np.where(m, _bits(np.asarray(ref.zo_affine_ref(
            xj, SEEDS[0], A[0], B[0], dist=dist))), xb)
        got = zo_affine_rows(xt, SEEDS[0], A[0], B[0], be, k, phase, dist)
        assert np.array_equal(_tbits(got), want), (shape, R, k, phase)
        # K8: every slice is the masked multi oracle
        multi = _bits(np.asarray(ref.zo_affine_multi_ref(xj, SEEDS, A, B,
                                                         dist=dist)))
        got = zo_affine_multi_rows(xt, SEEDS, A, B, be, k, phase, dist)
        assert got.shape == (len(SEEDS),) + shape
        assert np.array_equal(_tbits(got), np.where(m[None], multi, xb[None]))
        # K9: the chain oracle on the selected elements (the fold is
        # elementwise, so masking once at the end is masking every step)
        chain = _bits(np.asarray(ref.zo_affine_chain_ref(xj, SEEDS, A, B,
                                                         dist=dist)))
        got = zo_affine_chain_rows(xt, SEEDS, A, B, be, k, phase, dist)
        assert np.array_equal(_tbits(got), np.where(m, chain, xb))
        seen += 1
    assert seen == 45                      # every non-empty plan of the sweep


@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape,R,k", [((41, 67), 3, 2), ((300, 40), 7, 3),
                                       ((2100, 130), 96, 2)],
                         ids=["41x67", "300x40", "2100x130"])
def test_rows_vs_jax_interpret_kernel(shape, R, k, dt, dist):
    """Against JAX's interpret-mode K7 (``perturb.pallas.zo_affine`` with a
    ``RowBlocks`` plan): bitwise wherever JAX agrees with its own oracle;
    the port always equals the oracle; unselected elements keep x's bits in
    both."""
    xj, xt = _pair(shape, DTYPES[dt])
    disagree = []
    for phase in range(k):
        m, rb = _mask(shape, R, k, phase)
        interp = _bits(np.asarray(jax_affine(xj, 13, 0.9, 0.05,
                                             interpret=True, dist=dist,
                                             blocks=rb)))
        oracle = np.where(m, _bits(np.asarray(ref.zo_affine_ref(
            xj, 13, 0.9, 0.05, dist=dist))), _bits(np.asarray(xj)))
        got = _tbits(zo_affine_rows(xt, 13, 0.9, 0.05, rb.block_elems, k,
                                    phase, dist))
        assert np.array_equal(got, oracle)
        agree = interp == oracle
        assert np.array_equal(got[agree], interp[agree])
        assert np.array_equal(interp[~m], _bits(np.asarray(xj))[~m])
        ulps = np.abs(interp.astype(np.int64) - oracle.astype(np.int64))
        assert int(ulps.max()) <= 4        # a few f32 ulps where they differ
        disagree.append(int((~agree).sum()))
    # the recorded reference caveat: where the interpreted kernel leaves its
    # oracle it does so on at most a few percent of the selected elements,
    # by a few ulps, never on an unselected one — on the machine these tests
    # were written on only the 41x67 f32 gaussian case did (61 and 37); how
    # many depends on how XLA:CPU contracts the graph on the host
    assert sum(disagree) < 0.05 * m.size, disagree


# --------------------------------------------------------------------------- #
# Structure: K8 ≡ stacked K7, K9 ≡ sequential K7, k=1 ≡ full, in place
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_multi_is_stacked_singles_and_chain_is_sequential(dt):
    _, x = _pair((97, 33), DTYPES[dt], seed=4)
    be, k, phase = 2 * 33, 3, 1
    multi = zo_affine_multi_rows(x, SEEDS, A, B, be, k, phase)
    for j in range(len(SEEDS)):
        one = zo_affine_rows(x, SEEDS[j], A[j], B[j], be, k, phase)
        assert torch.equal(multi[j], one)
    y = x.clone()
    for j in range(len(SEEDS)):
        zo_affine_rows(y, SEEDS[j], A[j], B[j], be, k, phase, out=y)
    assert torch.equal(zo_affine_chain_rows(x, SEEDS, A, B, be, k, phase), y)


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d", "1d"])
def test_k1_is_full(shape):
    """k = 1 selects every element: K7 ≡ K1, K9 ≡ K3, K10 ≡ the full sum."""
    _, x = _pair(shape, DTYPES["bf16"], seed=9)
    n = x.numel()
    for R in (1, 3, 96):
        be = leaf_row_blocks(x, R, 1, 0).block_elems
        assert selected_count(n, be, 1, 0) == n
        assert torch.equal(zo_affine_rows(x, 5, 0.9, -0.1, be, 1, 0),
                           zo_affine(x, 5, 0.9, -0.1))
        assert torch.equal(zo_affine_chain_rows(x, SEEDS, A, B, be, 1, 0),
                           zo_affine_chain(x, SEEDS, A, B))


def test_writes_in_place_and_leaves_unselected_bits():
    _, x = _pair((64, 48), DTYPES["bf16"], seed=2)
    x0 = x.clone()
    ptr = x.data_ptr()
    m, rb = _mask((64, 48), 5, 3, 2)
    y = zo_affine_rows(x, 7, 1.0, 0.5, rb.block_elems, 3, 2, out=x)
    assert y.data_ptr() == ptr
    y = zo_affine_chain_rows(x, SEEDS, A, B, rb.block_elems, 3, 2, out=x)
    assert y.data_ptr() == ptr
    mt = torch.from_numpy(m)
    assert torch.equal(x[~mt], x0[~mt])
    assert not torch.equal(x[mt], x0[mt])


def test_empty_phase_and_bad_plan_refuse():
    x = torch.zeros(5, 4)
    with pytest.raises(ValueError, match="selects nothing"):
        zo_affine_rows(x, 1, 1.0, 1.0, 4, 8, 6)
    with pytest.raises(ValueError, match="0 <= phase < k"):
        zo_affine_rows(x, 1, 1.0, 1.0, 4, 2, 2)
    with pytest.raises(ValueError, match="selects nothing"):
        zo_sqnorm_rows(20, 1, 4, 8, 6)


# --------------------------------------------------------------------------- #
# K10 against zo_sqnorm_rows_ref
# --------------------------------------------------------------------------- #
SQ_CASES = [(2747, 201, 2, 1), (300_001, 7 * 40, 3, 2), (262_147, 512, 4, 0),
            (1000, 3, 3, 1), (1, 1, 1, 0)]


@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("case", SQ_CASES, ids=[str(c[0]) for c in SQ_CASES])
def test_sqnorm_rows_within_rtol_of_jax(case, dist):
    n, be, k, phase = case
    sel, _ = tile_plan(n, be, k, phase)
    want = float(zo_sqnorm_rows_ref(n, 31, sel, be, k, phase, dist=dist))
    got = zo_sqnorm_rows(n, 31, be, k, phase, dist)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= SQNORM_RTOL * want
    assert torch.equal(got, zo_sqnorm_rows_plain(n, 31, be, k, phase, dist))
    if dist == "rademacher":
        assert float(got) == selected_count(n, be, k, phase)


# --------------------------------------------------------------------------- #
# The golden fixture for the card
# --------------------------------------------------------------------------- #
# (shape, R, k, phase): ragged last blocks, a 3-D stacked leaf, a 1-D leaf
GOLD_PLANS = [((41, 67), 3, 2, 1), ((3, 17, 29), 1, 3, 2), ((1000,), 96, 2, 0),
              ((130, 21), 96, 2, 1)]


def make_golden() -> dict:
    out = {"seeds": np.asarray(SEEDS, np.int64), "a": A, "b": B}
    for i, (shape, R, k, phase) in enumerate(GOLD_PLANS):
        m, rb = _mask(shape, R, k, phase)
        out[f"plan_{i}"] = np.asarray([R, k, phase, rb.block_elems], np.int64)
        x = np.random.default_rng(100 + i).standard_normal(shape)
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            xj = jnp.asarray(x.astype(np.float32), dt)
            xb = _bits(np.asarray(xj))
            out[f"{name}_x_{i}"] = xb
            out[f"{name}_affine_{i}"] = np.where(m, _bits(np.asarray(
                ref.zo_affine_ref(xj, SEEDS[0], A[0], B[0]))), xb)
            out[f"{name}_multi_{i}"] = np.where(m[None], _bits(np.asarray(
                ref.zo_affine_multi_ref(xj, SEEDS, A, B))), xb[None])
            out[f"{name}_chain_{i}"] = np.where(m, _bits(np.asarray(
                ref.zo_affine_chain_ref(xj, SEEDS, A, B))), xb)
        n = int(np.prod(shape))
        sel, _ = tile_plan(n, rb.block_elems, k, phase)
        out[f"sq_{i}"] = np.float32(zo_sqnorm_rows_ref(
            n, SEEDS[1], sel, rb.block_elems, k, phase))
    return out


def test_rows_golden_fixture_is_what_jax_computes():
    stored = np.load(GOLDEN)
    fresh = make_golden()
    assert sorted(stored.files) == sorted(fresh)
    for k, v in fresh.items():
        assert stored[k].dtype == v.dtype and np.array_equal(stored[k], v), k
    assert GOLDEN.stat().st_size < 512 * 1024


def test_port_plain_kernels_match_rows_golden():
    g = np.load(GOLDEN)
    seeds = [int(s) for s in g["seeds"]]
    for i, (shape, _, k, phase) in enumerate(GOLD_PLANS):
        be = int(g[f"plan_{i}"][3])
        for name, tdt, iv in (("f32", torch.float32, np.int32),
                              ("bf16", torch.bfloat16, np.int16)):
            x = torch.from_numpy(g[f"{name}_x_{i}"].view(iv).copy()).view(tdt)
            assert np.array_equal(_tbits(zo_affine_rows(
                x, seeds[0], float(g["a"][0]), float(g["b"][0]), be, k,
                phase)), g[f"{name}_affine_{i}"])
            assert np.array_equal(_tbits(zo_affine_multi_rows(
                x, seeds, g["a"], g["b"], be, k, phase)),
                g[f"{name}_multi_{i}"])
            assert np.array_equal(_tbits(zo_affine_chain_rows(
                x, seeds, g["a"], g["b"], be, k, phase)),
                g[f"{name}_chain_{i}"])
        n = int(np.prod(shape))
        got = float(zo_sqnorm_rows(n, seeds[1], be, k, phase))
        assert abs(got - float(g[f"sq_{i}"])) <= SQNORM_RTOL * g[f"sq_{i}"]


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **make_golden())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
