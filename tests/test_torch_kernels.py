"""Port parity of the serving kernels' plain versions (the versions CPU
tensors take).

* K2 ``flash_attention`` plain vs ``flash_attention_bhsd`` (Pallas,
  interpret mode) and ``attention_ref``: f32, causal and sliding window,
  GQA, ragged S, atol 1e-5 (two summation orders of an f32 softmax); and
  at head dims 8 … 192 in f32, bf16 and f16 (one bf16 / f16 rounding of
  each output on both sides: one ulp apart).
* K2's wrapper decisions, taken from shapes, strides and addresses alone
  (``plan``): which device function and instance runs, and when q, k, v
  are copied (and zero-padded) first.
* K12 ``paged_gather`` plain vs the JAX ``paged_gather`` (interpret):
  bitwise, it is a copy.

The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged import paged_gather as jax_paged_gather
from repro_torch.kernels.flash_attention.kernel import (Plan, _copied,
                                                        aligned16,
                                                        flash_attention, plan)
from repro_torch.kernels.paged.gather import paged_gather, upload_table

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

# K2 in bf16 / f16 against an f32 reference rounded once: one ulp (as
# chip_smoke.py and test_torch_cuda.py hold the card's kernel)
K2_REL = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
K2_ABS = {"float32": 1e-5, "bfloat16": 1e-5, "float16": 1e-5}


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hd", [8, 40, 96, 128, 192])
def test_flash_plain_matches_pallas_at_head_dims(hd, dtype):
    """Every head dim JAX's kernel takes (its BlockSpec spans the whole hd):
    the plain version against the interpret-mode kernel, GQA, ragged S."""
    rng = np.random.default_rng(hd)
    S = 37
    q = rng.standard_normal((1, 2, S, hd)).astype(np.float32)      # BHSD
    k = rng.standard_normal((1, 1, S, hd)).astype(np.float32)
    v = rng.standard_normal((1, 1, S, hd)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(flash_attention_bhsd(
        *(jnp.asarray(a, dtype=jdt) for a in (q, k, v)), causal=True,
        window=0, block_q=32, block_k=32, interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    bshd = [torch.from_numpy(a.transpose(0, 2, 1, 3).copy()).to(tdt)
            for a in (q, k, v)]
    out = flash_attention(*bshd)
    assert out.dtype == tdt and out.shape == (1, S, 2, hd)
    got = out.float().numpy().transpose(0, 2, 1, 3)
    bad = np.abs(got - want) > K2_REL[dtype] * np.abs(want) + K2_ABS[dtype]
    assert not bad.any(), np.abs(got - want).max()


def _qkv(dtype, hd, H=4, KV=2, S=5):
    return (torch.zeros(2, S, H, hd, dtype=dtype),
            torch.zeros(2, S, KV, hd, dtype=dtype),
            torch.zeros(2, S, KV, hd, dtype=dtype))


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "bf16"),
                                        (torch.float16, "f16")])
def test_flash_plan_half_dtypes(dtype, name):
    """bf16 / f16: the mma kernel up to hd 256, on the inputs as they are
    when it can read them with 16-byte copies; otherwise a copy first."""
    for hd in (8, 40, 64, 96, 128, 192, 256):
        assert plan(*_qkv(dtype, hd)) == Plan("mma", False, hd, f"{name}_mma")
    # hd not a multiple of 8: copied, zero-padded to the next multiple
    assert plan(*_qkv(dtype, 20)) == Plan("mma", True, 24, f"{name}_mma+copy")
    # a non-unit head-dim stride: copied
    q, k, v = _qkv(dtype, 128)
    assert plan(q[..., ::2], k[..., ::2], v[..., ::2]) == Plan(
        "mma", True, 64, f"{name}_mma+copy")
    # a base 2 bytes off 16: copied
    flat = torch.zeros(2 * 5 * 4 * 64 + 1, dtype=dtype)
    k, v = _qkv(dtype, 64)[1:]
    assert plan(flat[1:].view(2, 5, 4, 64), k, v).route == f"{name}_mma+copy"
    # q / k / v as views of one fused projection: read in place
    qkv = torch.zeros(2, 5, 8, 64, dtype=dtype)
    assert not plan(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]).copy
    # past 256: the scalar kernel, copied only for a non-unit head-dim
    # stride
    assert plan(*_qkv(dtype, 320)) == Plan("scalar", False, 320,
                                           f"{name}_scalar")
    q, k, v = _qkv(dtype, 640)
    assert plan(q[..., ::2], k[..., ::2], v[..., ::2]).route == \
        f"{name}_scalar+copy"


def test_flash_plan_f32_is_scalar_at_every_head_dim():
    for hd in (8, 16, 20, 64, 128, 320):
        assert plan(*_qkv(torch.float32, hd)) == Plan("scalar", False, hd,
                                                      "f32_scalar")
    flat = torch.zeros(2 * 5 * 4 * 64 + 1)
    k, v = _qkv(torch.float32, 64)[1:]
    assert not plan(flat[1:].view(2, 5, 4, 64), k, v).copy   # any base
    q, k, v = _qkv(torch.float32, 64)
    assert plan(q[..., ::2], k[..., ::2], v[..., ::2]) == Plan(
        "scalar", True, 32, "f32_scalar+copy")


@pytest.mark.parametrize("pad_to", [20, 24])
def test_flash_copied_inputs_are_fresh_aligned_and_zero_padded(pad_to):
    base = torch.randn(2 * 5 * 4 * 40 + 1).to(torch.bfloat16)
    t = base[1:].view(2, 5, 4, 40)[..., ::2]            # hd 20, stride 2
    assert not aligned16(t) and t.stride(3) == 2
    c = _copied(t, pad_to)
    assert c.shape == (2, 5, 4, pad_to) and c.is_contiguous()
    assert c.data_ptr() % 16 == 0 and c.data_ptr() != t.data_ptr()
    assert torch.equal(c[..., :20], t)
    assert not c[..., 20:].any()
    if pad_to % 8 == 0:
        assert aligned16(c)


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

