"""The arithmetic of K2's bf16 route, emulated on the CPU.

The CUDA kernel (``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu``, ``flash_fwd_mma``) runs only on the card.  This file
keeps its arithmetic testable here: a test-local torch emulation of the
redesigned kernel — 64-row q tiles, an online softmax over 64-key tiles
(only the tiles the causal / window bounds reach), q·k products of bf16
values summed in f32 (a product of two bf16 values is exact in f32, as on
the tensor cores), the scale applied to the f32 scores, and P split into
P_hi = bf16(P) and P_lo = bf16(P − P_hi), each multiplied by the bf16 V and
summed in f32 — held to

* ``chip_smoke.py``'s K2 tolerance (2⁻⁷·|ref| + 1e-5 on the bf16 output)
  against ``flash_attention_plain``;
* 1e-5 against JAX's ``flash_attention_bhsd`` (Pallas, interpret mode) and
  ``attention_ref`` on inputs that bf16 and f32 both represent, as
  ``tests/test_torch_kernels.py`` holds the plain version;

and pins the reason for the split: with one bf16 rounding of P the same
emulation puts outputs beyond that tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_plain

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

BM = BN = 64                         # the kernel's q and key tiles
K2_BF16_REL, K2_BF16_ABS = 2.0 ** -7, 1e-5   # chip_smoke.py's K2 tolerance


def emulate_mma_route(q, k, v, *, window=0, split=True):
    """q (B,S,H,hd), k/v (B,S,KV,hd) holding bf16 values (any float dtype)
    -> f32 (B,S,H,hd), causal, as ``flash_fwd_mma`` computes it."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = hd ** -0.5
    qh = q.float().permute(0, 2, 1, 3)
    kh = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    out = torch.empty(B, H, S, hd)
    pos = torch.arange(S)
    for q0 in range(0, S, BM):
        rows = pos[q0:q0 + BM]
        qt = qh[:, :, q0:q0 + BM]
        m = torch.full((B, H, len(rows)), -1e30)
        l = torch.zeros(B, H, len(rows))
        acc = torch.zeros(B, H, len(rows), hd)
        first = max(0, q0 - window + 1) if window else 0
        for k0 in range(first // BN * BN, int(rows[-1]) + 1, BN):
            keys = pos[k0:k0 + BN]
            s = (qt @ kh[:, :, k0:k0 + BN].transpose(-1, -2)) * scale
            keep = keys[None, :] <= rows[:, None]
            if window:
                keep &= keys[None, :] > rows[:, None] - window
            s = s.masked_fill(~keep, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            vt = vh[:, :, k0:k0 + BN]
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vt
            if split:
                pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, q0:q0 + BM] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


def _bf16_inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, n, hd))
                             .astype(np.float32)).to(torch.bfloat16)
            for n in (H, KV, KV)]


def _beyond_tolerance(got_bf16, want_bf16) -> int:
    got, want = got_bf16.float(), want_bf16.float()
    return int(((got - want).abs()
                > K2_BF16_REL * want.abs() + K2_BF16_ABS).sum())


@pytest.mark.parametrize("S,window", [(1, 0), (63, 0), (65, 64), (200, 0),
                                      (200, 64)])
def test_split_p_route_within_chip_tolerance_of_plain(S, window):
    q, k, v = _bf16_inputs(S + window, 2, S, 14, 2, 64)
    got = emulate_mma_route(q, k, v, window=window).to(torch.bfloat16)
    want = flash_attention_plain(q, k, v, window=window)
    assert bool(torch.isfinite(got.float()).all())
    assert _beyond_tolerance(got, want) == 0


@pytest.mark.parametrize("S,window", [(40, 0), (37, 8), (128, 0), (100, 16),
                                      (130, 64)])
def test_split_p_route_matches_pallas_and_ref(S, window):
    """f32 inputs that bf16 represents exactly: the emulated kernel, f32 out,
    within 1e-5 of JAX's kernel and oracle."""
    rng = np.random.default_rng(S)
    bhsd = [(rng.standard_normal((2, n, S, 16)).astype(np.float32)
             .view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
            for n in (4, 2, 2)]
    q, k, v = (jnp.asarray(a) for a in bhsd)
    want_kernel = np.asarray(flash_attention_bhsd(
        q, k, v, causal=True, window=window, block_q=32, block_k=32,
        interpret=True))
    want_ref = np.asarray(attention_ref(q, k, v, causal=True, window=window))
    bshd = [torch.from_numpy(a.transpose(0, 2, 1, 3).copy()) for a in bhsd]
    got = emulate_mma_route(*bshd, window=window).numpy().transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("window", [0, 64])
def test_one_bf16_rounding_of_p_breaks_the_tolerance(window):
    """Why P is split: the one-rounding FlashAttention-2 choice puts outputs
    beyond the tolerance at check_k2's shapes, the split puts none."""
    q, k, v = _bf16_inputs(256, 2, 256, 14, 2, 64)
    want = flash_attention_plain(q, k, v, window=window)
    one = emulate_mma_route(q, k, v, window=window, split=False)
    two = emulate_mma_route(q, k, v, window=window, split=True)
    assert _beyond_tolerance(one.to(torch.bfloat16), want) > 1000
    assert _beyond_tolerance(two.to(torch.bfloat16), want) == 0
