"""The JAX golden fixture of the K1 z stream (``tests/data/zo_golden.npz``).

The machine with the card has no JAX, so ``chip_smoke.py`` holds the CUDA
K1 to this fixture bitwise — the one cross-framework check possible there.
Here the fixture is regenerated from ``repro.kernels.zo_fused.ref`` and must
equal the stored file, and the port's plain K1 must equal it too.

Regenerate after a deliberate stream change with
``PYTHONPATH=src python tests/test_torch_golden.py``.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.zo_fused import ref
from repro_torch.kernels.zo_fused.kernel import z_for, zo_affine

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" / "zo_golden.npz"
SEEDS = (0, 1234567)
N_Z = 40_000
N_AFF = 4_099
A, B = np.float32(0.999), np.float32(-0.0123)


def make_golden() -> dict:
    out = {"seeds": np.asarray(SEEDS, np.int64)}
    for i, s in enumerate(SEEDS):
        out[f"z_gauss_{i}"] = np.asarray(ref.z_for((N_Z,), s, "gaussian"))
        out[f"rad_bits_{i}"] = np.packbits(
            np.asarray(ref.z_for((N_Z,), s, "rademacher")) > 0)
    x = np.random.default_rng(2026).standard_normal(N_AFF).astype(np.float32)
    for name, dt, seed, view in (("f32", jnp.float32, 777, np.int32),
                                 ("bf16", jnp.bfloat16, 4242, np.int16)):
        xj = jnp.asarray(x, dt)
        y = np.asarray(ref.zo_affine_ref(xj, seed, A, B))
        xs = np.asarray(xj)
        out[f"aff_{name}_x"] = xs if name == "f32" else xs.view(np.int16)
        out[f"aff_{name}_y"] = y.view(view)
        out[f"aff_{name}_seed"] = np.asarray(seed, np.int64)
        out[f"aff_{name}_a"] = np.asarray(A)
        out[f"aff_{name}_b"] = np.asarray(B)
    return out


def test_golden_fixture_is_what_jax_computes():
    stored = np.load(GOLDEN)
    fresh = make_golden()
    assert sorted(stored.files) == sorted(fresh)
    for k, v in fresh.items():
        assert stored[k].dtype == v.dtype and np.array_equal(stored[k], v), k
    assert GOLDEN.stat().st_size < 512 * 1024


def test_port_plain_k1_matches_golden_fixture():
    g = np.load(GOLDEN)
    for i, s in enumerate(g["seeds"]):
        z = z_for((N_Z,), int(s), "gaussian").numpy()
        assert np.array_equal(z.view(np.uint32),
                              g[f"z_gauss_{i}"].view(np.uint32))
        r = z_for((N_Z,), int(s), "rademacher").numpy()
        assert np.array_equal(np.packbits(r > 0), g[f"rad_bits_{i}"])
    for name in ("f32", "bf16"):
        x = torch.from_numpy(g[f"aff_{name}_x"])
        if name == "bf16":
            x = x.view(torch.bfloat16)
        y = zo_affine(x, int(g[f"aff_{name}_seed"]), float(g[f"aff_{name}_a"]),
                      float(g[f"aff_{name}_b"]))
        bits = y.view(torch.int32 if name == "f32" else torch.int16).numpy()
        assert np.array_equal(bits, g[f"aff_{name}_y"]), name


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **make_golden())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
