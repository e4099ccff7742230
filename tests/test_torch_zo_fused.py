"""Port parity: K1 ``zo_affine`` plain version vs JAX, bitwise.

The JAX side runs as its own tests run it on the CPU: the jitted oracle
(``ref.z_for`` / ``ref.zo_affine_ref``) and the Pallas kernel in interpret
mode (through the ``pallas`` backend's leaf wrapper, which pads to the
kernel's tiles).  The leaf size is not a tile multiple and a ≠ 1."""
import fractions
import math

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.zo_fused import ref
from repro.perturb.pallas import zo_affine as jax_zo_affine
from repro_torch.kernels.zo_fused import kernel as kernel_mod
from repro_torch.kernels.zo_fused.kernel import (_fma, _sqrt_rn, z_for,
                                                 zo_affine, zo_affine_plain)

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.float16, torch.float16)]
SHAPE = (37, 1001)                       # 37 037 elements: not a tile multiple


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("seed,n", [(0, 131_072 + 3), (-7, 20_011),
                                    (2**31 - 1, 20_011)])
def test_z_bitwise_equals_ref_z_for(dist, seed, n):
    want = np.asarray(ref.z_for((n,), seed, dist))
    got = z_for((n,), seed, dist).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [SHAPE, (33, 65)], ids=["37x1001", "33x65"])
def test_affine_bitwise_equals_ref_and_interpret_kernel(dt, dist, shape):
    """The port equals ``zo_affine_ref`` bitwise, and the interpret-mode
    kernel wherever that kernel agrees with ``zo_affine_ref``.  XLA:CPU's
    contraction of the two JAX graphs can differ (on the 33×65 f32 gaussian
    leaf the interpret kernel disagrees with the oracle on 60 elements on
    some hosts — ROADMAP Queue 3); the port follows the oracle."""
    jdt, tdt = dt
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    a, b = np.float32(0.999), np.float32(-0.0123)
    xj = jnp.asarray(x, jdt)
    want_ref = np.asarray(ref.zo_affine_ref(xj, 99, a, b, dist=dist))
    want_kernel = np.asarray(jax_zo_affine(xj, 99, a, b, interpret=True,
                                           dist=dist))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = zo_affine(xt, 99, float(a), float(b), dist)
    got_bits = got.view(torch.int32 if tdt == torch.float32
                        else torch.int16).numpy().view(_bits(want_ref).dtype)
    assert np.array_equal(got_bits, _bits(want_ref))
    if np.array_equal(_bits(want_kernel), _bits(want_ref)):
        assert np.array_equal(got_bits, _bits(want_kernel))
    # in place (the paper's trick) writes the same bits
    zo_affine(xt, 99, float(a), float(b), dist, out=xt)
    assert torch.equal(xt, got)


def test_fma_emulation_is_a_single_rounding():
    """The exact-FMA emulation against rational arithmetic, including
    operands built so that naive f64 rounding rounds twice wrongly."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = rng.standard_normal(2000).astype(np.float32)
    # a = b = 1 + 2^-12: a·b = 1 + 2^-11 + 2^-24 is exactly an f32 midpoint.
    # With c = ±2^-80 the f64 sum rounds back onto the midpoint and RNE picks
    # the even 1 + 2^-11; for c > 0 the true value is above the midpoint and
    # the correct FMA is 1 + 2^-11 + 2^-23
    m = np.float32(1 + 2.0 ** -12)
    a = np.append(a, [m, m])
    b = np.append(b, [m, m])
    c = np.append(c, [np.float32(2.0 ** -80), np.float32(-2.0 ** -80)])
    assert _fma(torch.tensor([m]), torch.tensor([m]),
                torch.tensor([np.float32(2.0 ** -80)]))[0] == np.float32(
                    1 + 2.0 ** -11 + 2.0 ** -23)
    got = _fma(torch.from_numpy(a), torch.from_numpy(b),
               torch.from_numpy(c)).numpy()
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = (fractions.Fraction(float(ai)) * fractions.Fraction(float(bi))
                 + fractions.Fraction(float(ci)))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(fractions.Fraction(float(v))
                                             - exact),
                                         int(np.float32(v).view(np.uint32)) & 1))

        assert gi == best, (ai, bi, ci, gi, best)


def test_sqrt_is_correctly_rounded():
    t = np.random.default_rng(2).random(100_000).astype(np.float32) * 20
    got = _sqrt_rn(torch.from_numpy(t)).numpy()
    assert np.array_equal(got, np.sqrt(t))          # IEEE sqrtf
    assert math.isclose(float(_sqrt_rn(torch.tensor([4.0]))[0]), 2.0)


def test_plain_version_is_chunk_invariant(monkeypatch):
    """The plain version walks a leaf in chunks; the counter must stay the
    flat index across chunk edges."""
    x = torch.randn(2_505, generator=torch.Generator().manual_seed(0))
    whole = zo_affine_plain(x, 5, 1.0, 0.5)
    monkeypatch.setattr(kernel_mod, "_CHUNK", 1_000)
    assert torch.equal(zo_affine_plain(x, 5, 1.0, 0.5), whole)


def test_unsupported_dist_and_dtype_raise():
    with pytest.raises(NotImplementedError, match="sphere"):
        zo_affine(torch.zeros(4), 0, 1.0, 1.0, "sphere")
    with pytest.raises(TypeError):
        zo_affine(torch.zeros(4, dtype=torch.float64), 0, 1.0, 1.0)
