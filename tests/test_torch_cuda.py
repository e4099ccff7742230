"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a card (decided inside the fixture,
never at import).  This file imports no JAX, so it runs on a machine with
the card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_plain)
from repro_torch.kernels.paged.gather import paged_gather, paged_gather_plain
from repro_torch.kernels.zo_fused.kernel import (zo_affine,
                                                 zo_affine_batched,
                                                 zo_affine_batched_plain,
                                                 zo_affine_plain)
from repro_torch.kernels.zo_fused.multi import (zo_affine_chain,
                                                zo_affine_chain_plain,
                                                zo_affine_multi,
                                                zo_affine_multi_plain,
                                                zo_sqnorm, zo_sqnorm_plain)

SEEDS = [11, -5, 2**31 - 1, 977, 3, 123456789, -2**31, 42]
A = [0.999, 1.0, 0.5, 1.0, 0.9990234375, 1.0, 1.0, 0.75]
B = [-0.0123, 0.01, 0.25, -1e-3, 0.0625, -0.5, 3e-4, 0.1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_zo_affine_bitwise(cuda, dtype, dist):
    x = torch.randn(262_147, device=cuda).to(dtype)
    yk = zo_affine(x, 4321, 0.999, -0.0123, dist)
    yp = zo_affine_plain(x, 4321, 0.999, -0.0123, dist)
    assert torch.equal(yk, yp)


@pytest.mark.cuda
@pytest.mark.parametrize("S,window", [(1, 0), (300, 0), (1000, 64)])
def test_cuda_flash_attention_within_tolerance(cuda, S, window):
    q = torch.randn(2, S, 14, 64, device=cuda)
    k = torch.randn(2, S, 2, 64, device=cuda)
    v = torch.randn(2, S, 2, 64, device=cuda)
    torch.testing.assert_close(flash_attention(q, k, v, window=window),
                               flash_attention_plain(q, k, v, window=window),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_paged_gather_bitwise(cuda):
    x = torch.randn(4, 64 * 16, 128, device=cuda).to(torch.bfloat16)
    table = [3, 0, 63, 7, 7]
    assert torch.equal(paged_gather(x, table, 16),
                       paged_gather_plain(x, torch.tensor(table, device=cuda),
                                          16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("nb", [1, 2, 8])
def test_cuda_multi_seed_kernels_bitwise(cuda, dtype, dist, nb):
    """K3 chain (in place too), K4 fan-out and K5 batched fan-out against
    their plain versions."""
    x = torch.randn(262_147, device=cuda).to(dtype)
    s, a, b = SEEDS[:nb], A[:nb], B[:nb]
    assert torch.equal(zo_affine_chain(x, s, a, b, dist),
                       zo_affine_chain_plain(x, s, a, b, dist))
    y = x.clone()
    zo_affine_chain(y, s, a, b, dist, out=y)
    assert torch.equal(y, zo_affine_chain_plain(x, s, a, b, dist))
    assert torch.equal(zo_affine_multi(x, s, a, b, dist),
                       zo_affine_multi_plain(x, s, a, b, dist))
    assert torch.equal(zo_affine_batched(x, s, a[0], b[0], dist),
                       zo_affine_batched_plain(x, s, a[0], b[0], dist))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 131_072, 300_001])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_sqnorm_bitwise(cuda, n, dist):
    k = zo_sqnorm(n, 1234, dist, cuda)
    assert k.device.type == "cuda"
    assert torch.equal(k, zo_sqnorm_plain(n, 1234, dist, cuda))
