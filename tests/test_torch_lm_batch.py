"""Port parity of the step-indexed LM data: ``lm_batch`` is JAX's batch bit
for bit — threefry ``randint`` (split into two keys, two 32-bit draws, the
``(hi % span)·((2¹⁶ % span)² % span) + lo % span`` scheme in wrapping
uint32) and the planted structure — at qwen2's vocab (151 936), 65 536
(rwkv6) and 256 (the smoke configs), under the partitionable threefry
layout the port reproduces."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.data.pipeline import DataSpec as JaxSpec
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro_torch.data import DataSpec, Pipeline
from repro_torch.data.synthetic import lm_batch, randint
from repro_torch.perturb.stream import fold_in, prng_key


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("vocab", [151_936, 65_536, 256])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (-5, 123_456)])
def test_lm_batch_bitwise_jax(vocab, seed, step):
    want = jax_lm_batch(seed, step, 3, 33, vocab)
    got = lm_batch(seed, step, 3, 33, vocab)
    for k in ("tokens", "labels", "loss_mask"):
        w = np.asarray(want[k])
        assert got[k].dtype == torch.from_numpy(w.copy()).dtype
        assert np.array_equal(got[k].numpy(), w), k


@pytest.mark.parametrize("lo,hi", [(-10, 77), (5, 5), (9, 3),
                                   (0, 2**31 - 1), (-2**31, 2**31 - 1)])
def test_randint_bitwise_jax(lo, hi):
    """Every span, including an empty one (maxval ≤ minval → minval) and
    spans past 2¹⁶ (the multiplier wraps to 0 in uint32)."""
    key = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    want = np.asarray(jax.random.randint(key, (1000,), lo, hi, jnp.int32))
    got = randint(fold_in(prng_key(1), 2), (1000,), lo, hi)
    assert np.array_equal(got.numpy(), want)


def test_pipeline_batches_equal_jax_pipelines():
    """The training loop's data: the port's ``Pipeline`` hands the same
    batch as JAX's at every step."""
    jp = JaxPipeline(JaxSpec("lm", batch=2, seq=8, vocab=300, seed=4))
    tp = Pipeline(DataSpec("lm", batch=2, seq=8, vocab=300, seed=4),
                  device="cpu")
    for step in (0, 1, 9):
        w, g = jp.batch(step), tp.batch(step)
        assert all(np.array_equal(np.asarray(w[k]), g[k].numpy()) for k in w)
