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
from repro_torch.kernels.zo_fused.kernel import zo_affine, zo_affine_plain


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
