"""Port parity of the serving kernels' plain versions (the versions CPU
tensors take).

* K2 ``flash_attention`` plain vs ``flash_attention_bhsd`` (Pallas,
  interpret mode) and ``attention_ref``: f32, causal and sliding window,
  GQA, ragged S, atol 1e-5 (two summation orders of an f32 softmax).
* K12 ``paged_gather`` plain vs the JAX ``paged_gather`` (interpret):
  bitwise, it is a copy.

The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged import paged_gather as jax_paged_gather
from repro_torch.kernels.flash_attention.kernel import (aligned16,
                                                        flash_attention)
from repro_torch.kernels.paged.gather import paged_gather, upload_table

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist


@pytest.mark.parametrize("S,window", [(40, 0), (37, 8), (128, 0), (100, 16)])
def test_flash_plain_matches_pallas_and_ref(S, window):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, 4, S, 16)).astype(np.float32)      # BHSD
    k = rng.standard_normal((2, 2, S, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, S, 16)).astype(np.float32)
    want_kernel = np.asarray(flash_attention_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, block_q=32, block_k=32, interpret=True))
    want_ref = np.asarray(attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        window=window))
    bshd = [torch.from_numpy(a.transpose(0, 2, 1, 3).copy()) for a in (q, k, v)]
    got = flash_attention(*bshd, window=window).numpy().transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=0)


def test_flash_rejects_malformed_shapes():
    q = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_paged_gather_plain_bitwise_equals_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 12 * 8, 20)).astype(dtype)   # 12 blocks of 8
    table = np.asarray([5, 0, 11, 5, 2], np.int32)
    want = np.asarray(jax_paged_gather(jnp.asarray(x), jnp.asarray(table), 8,
                                       interpret=True))
    got = paged_gather(torch.from_numpy(x), table, 8).numpy()
    assert got.shape == (3, 5 * 8, 20)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    with pytest.raises(IndexError):
        paged_gather(torch.from_numpy(x), [12], 8)


def test_paged_gather_takes_host_tensors_and_uploaded_tables():
    """A host table may be a list, an array or a CPU tensor; ``upload_table``
    checks it once and, for a CPU pool, hands back an int32 CPU tensor that
    both gathers of an engine step can share."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 6 * 4, 3)).astype(np.float32))
    table = [5, 0, 0, 3]
    want = paged_gather(x, table, 4)
    tab = upload_table(np.asarray(table), 6, "cpu")
    assert tab.dtype == torch.int32 and tab.device.type == "cpu"
    for t in (np.asarray(table, np.int64), torch.tensor(table), tab):
        assert torch.equal(paged_gather(x, t, 4), want)
    with pytest.raises(IndexError):
        upload_table([6], 6, "cpu")
    with pytest.raises(ValueError, match="host table"):
        paged_gather(x, torch.zeros(1, dtype=torch.int32, device="meta"), 4)


def test_flash_bf16_alignment_rule():
    """The bf16 kernel copies rows as 16-byte chunks: a 16-byte-aligned base
    and (b, s, h) strides in multiples of 8 bf16 elements; the stride of a
    length-1 axis is never used."""
    x = torch.zeros(2, 8, 14, 64, dtype=torch.bfloat16)
    assert aligned16(x)
    assert aligned16(torch.zeros(2, 8, 18, 64, dtype=torch.bfloat16)[:, :, 14:])
    assert aligned16(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert not aligned16(torch.zeros(2, 8, 14, 65, dtype=torch.bfloat16)[..., :64])
    assert not aligned16(torch.zeros(2 * 8 * 14 * 64 + 1, dtype=torch.bfloat16)
                         [1:].view(2, 8, 14, 64))
    assert aligned16(torch.zeros(1, 8, 14, 64, dtype=torch.bfloat16)
                     .as_strided((1, 8, 14, 64), (3, 14 * 64, 64, 1)))

