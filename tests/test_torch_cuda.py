"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a card (decided inside the fixture,
never at import).  This file imports no JAX, so it runs on a machine with
the card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pathlib

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_plain)
from repro_torch.kernels.paged.gather import (paged_gather,
                                              paged_gather_plain,
                                              upload_table)
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6.kernel import plan as wkv6_plan
from repro_torch.kernels.rwkv6.kernel import wkv6_chunked
from repro_torch.kernels.threefry import kernel as x1
from repro_torch.kernels.zo_fused.kernel import (zo_affine,
                                                 zo_affine_batched,
                                                 zo_affine_batched_plain,
                                                 zo_affine_plain)
from repro_torch.kernels.zo_fused.multi import (zo_affine_chain,
                                                zo_affine_chain_plain,
                                                zo_affine_multi,
                                                zo_affine_multi_plain,
                                                zo_sqnorm, zo_sqnorm_many,
                                                zo_sqnorm_plain)
from repro_torch.kernels.zo_fused.rows import (ROWS_MAX_LEAVES, SQNORM_RTOL,
                                               zo_affine_chain_rows,
                                               zo_affine_chain_rows_plain,
                                               zo_affine_multi_rows,
                                               zo_affine_multi_rows_plain,
                                               zo_affine_rows,
                                               zo_affine_rows_plain,
                                               rows_route,
                                               zo_sqnorm_rows,
                                               zo_sqnorm_rows_many,
                                               zo_sqnorm_rows_plain)

SEEDS = [11, -5, 2**31 - 1, 977, 3, 123456789, -2**31, 42]
A = [0.999, 1.0, 0.5, 1.0, 0.9990234375, 1.0, 1.0, 0.75]
B = [-0.0123, 0.01, 0.25, -1e-3, 0.0625, -0.5, 3e-4, 0.1]
ROWS_GOLDEN = (pathlib.Path(__file__).resolve().parent / "data"
               / "zo_rows_golden.npz")
WKV6_GOLDEN = (pathlib.Path(__file__).resolve().parent / "data"
               / "wkv6_golden.npz")
# K11 against its plain version: the same f32 factorization summed in
# another order — relative to the output's largest magnitude
K11_REL = 1e-5
# K11's gradients on the card against the CPU's: the VJP of the same plain
# chunk graph on both, its f32 matmuls and sums in another order
K11_GRAD_REL = 1e-4
# K2's bf16 route against its plain version, chip_smoke.py's tolerance: one
# bf16 rounding of each output on both sides of an f32 computation whose
# two orders of summation differ by ~1e-6 — at most one bf16 ulp apart
K2_BF16_REL, K2_BF16_ABS = 2.0 ** -7, 1e-5


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


def _qkv_bf16(cuda, B, S, H, KV, hd, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(B, S, n, hd, generator=g, device=cuda)
                 .to(torch.bfloat16) for n in (H, KV, KV))


def _assert_bf16_close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > K2_BF16_REL * want.abs() + K2_BF16_ABS
    assert bool(torch.isfinite(got).all())
    assert not bool(bad.any()), (f"{int(bad.sum())} of {bad.numel()} beyond "
                                 f"one bf16 ulp, max err {err.max().item()}")


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 300, 1000])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("B", [1, 3])
def test_cuda_flash_attention_bf16_within_tolerance(cuda, S, hd, G, window,
                                                    B):
    """The mma.sync route: ragged S (one row, one tile ± 1, several tiles),
    every head dim, GQA groups of 1 and 7, causal with and without a
    window."""
    q, k, v = _qkv_bf16(cuda, B, S, 2 * G, 2, hd, seed=S * 7 + hd + G + B)
    _assert_bf16_close(flash_attention(q, k, v, window=window),
                       flash_attention_plain(q, k, v, window=window))


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_reads_aligned_strides(cuda):
    """q/k/v as views of one fused projection (B, S, H + 2·KV, hd) and of a
    (B, H, S, hd) layout: the same bits as from contiguous copies."""
    B, S, H, KV, hd = 2, 200, 14, 2, 64
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(B, S, H + 2 * KV, hd, generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous() and not k.is_contiguous()
    out = flash_attention(q, k, v, window=64)
    _assert_bf16_close(out, flash_attention_plain(q, k, v, window=64))
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window=64)
    assert torch.equal(_bytes(out), _bytes(want))
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)    # (B, H, S, hd)
    assert qt.stride(1) == hd
    assert torch.equal(_bytes(flash_attention(qt, k, v, window=64)),
                       _bytes(want))


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_refuses_misaligned(cuda):
    """Inputs the mma kernel cannot read with 16-byte copies — a row stride
    of 65 elements, a base 2 bytes off 16 — are no longer refused: they are
    copied first and run the same kernel, counted under ``bf16_mma+copy``,
    with the bits of the aligned call on the same values."""
    from repro_torch.kernels import _build
    k = torch.randn(1, 32, 2, 64, device=cuda).to(torch.bfloat16)
    wide = torch.randn(1, 32, 14, 65, device=cuda)
    flat = torch.randn(32 * 14 * 64 + 1, device=cuda).to(torch.bfloat16)
    for q in (wide.to(torch.bfloat16)[..., :64],              # stride 65
              flat[1:].view(1, 32, 14, 64)):                   # base + 2 B
        _build.reset_launch_counts()
        out = flash_attention(q, k, k)
        assert _build.route_counts == {"flash_attention/bf16_mma+copy": 1,
                                       "flash_attention/hd64": 1}
        _assert_bf16_close(out, flash_attention_plain(q, k, k))
        assert torch.equal(_bytes(out),
                           _bytes(flash_attention(q.contiguous(), k, k)))
    # the scalar f32 route takes any stride as it is
    q32, k32 = wide[..., :64], k.float()
    torch.testing.assert_close(flash_attention(q32, k32, k32),
                               flash_attention_plain(q32, k32, k32),
                               atol=1e-5, rtol=0)


# K2 against its plain version by dtype: f32 absolute, bf16 / f16 one ulp
_K2_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5),
           torch.float16: (2.0 ** -10, 1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd", [8, 20, 40, 80, 96, 128, 192, 256, 320])
@pytest.mark.parametrize("S", [1, 100, 256])
def test_cuda_flash_attention_head_dims_and_dtypes(cuda, dtype, hd, S):
    """Every head dim JAX takes, in f32, bf16 and f16, causal with and
    without a window: the mma instances (rounded up, zero-padded), hd 20
    (copied to 24 columns), and the sliced scalar kernel past 256."""
    g = torch.Generator(device=cuda).manual_seed(hd * 7 + S)
    q, k, v = (torch.randn(2, S, n, hd, generator=g, device=cuda).to(dtype)
               for n in (4, 2, 2))
    rel, ab = _K2_TOL[dtype]
    for window in (0, 64):
        got = flash_attention(q, k, v, window=window).float()
        want = flash_attention_plain(q, k, v, window=window).float()
        err = (got - want).abs()
        assert bool(torch.isfinite(got).all())
        assert not bool((err > rel * want.abs() + ab).any()), \
            float(err.max())


@pytest.mark.cuda
def test_cuda_z_selftest_finds_no_mismatch(cuda):
    """Every rewrite of the z generator against zo::ref over its whole
    domain (every 24-bit uniform, every 23-bit mantissa)."""
    from repro_torch.kernels.zo_fused.kernel import z_selftest
    assert z_selftest(cuda) == dict.fromkeys(z_selftest(cuda), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("offset,n", [(0, 1), (0, 7), (1, 8), (3, 100),
                                      (0, 4099), (5, 262_147)])
def test_cuda_z_kernels_vectors_heads_and_tails(cuda, dtype, offset, n):
    """K1 and K3 on leaves that start off a 16-byte boundary and end inside
    a vector, in place and out of place, and with y aligned differently
    from x (every element then runs scalar): bitwise their plain
    versions."""
    base = torch.randn(n + 16, device=cuda).to(dtype)
    x = base[offset:offset + n]
    want1 = zo_affine_plain(x, 77, 0.999, -0.0123)
    want3 = zo_affine_chain_plain(x, SEEDS, A, B)
    assert torch.equal(zo_affine(x, 77, 0.999, -0.0123), want1)
    assert torch.equal(zo_affine_chain(x, SEEDS, A, B), want3)
    other = torch.empty(n + 16, device=cuda, dtype=dtype)[1:n + 1]
    assert torch.equal(zo_affine(x, 77, 0.999, -0.0123, out=other), want1)
    assert torch.equal(zo_affine_chain(x, SEEDS, A, B, out=other), want3)
    y = x.clone()
    zo_affine_chain(y, SEEDS, A, B, out=y)
    assert torch.equal(y, want3)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 64])
def test_cuda_flash_attention_bf16_repeatable_bitwise(cuda, window):
    """No atomics: two launches at the training shape agree bit for bit."""
    q, k, v = _qkv_bf16(cuda, 16, 256, 14, 2, 64, seed=5)
    a = flash_attention(q, k, v, window=window)
    b = flash_attention(q, k, v, window=window)
    assert torch.equal(_bytes(a), _bytes(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,block", [
    (torch.bfloat16, 128, 16),     # the serving pool: 256-byte rows
    (torch.bfloat16, 1024, 16),    # 32 KB chunks: several rounds per lane
    (torch.bfloat16, 5, 16),       # 10-byte rows, 160-byte chunks
    (torch.bfloat16, 5, 3),        # 30-byte chunks: the byte loop
    (torch.float32, 3, 1)])        # 12-byte chunks: the byte loop
def test_cuda_paged_gather_host_and_device_tables(cuda, dtype, D, block):
    """Bitwise against the plain gather with the table on the host and on
    the card: one id, repeated ids, ragged random tables, the pool's ends."""
    n_blocks = 50
    x = torch.randn(3, n_blocks * block, D, device=cuda).to(dtype)
    rng = np.random.default_rng(D * block)
    for table in ([7], [3, 3, 3], rng.integers(0, n_blocks, 37).tolist(),
                  rng.integers(0, n_blocks, 1000).tolist(),
                  [n_blocks - 1, 0, 5, 5, 0]):
        want = paged_gather_plain(x, torch.tensor(table, device=cuda), block)
        host = paged_gather(x, np.asarray(table), block)
        dev = paged_gather(x, torch.tensor(table, dtype=torch.int32,
                                           device=cuda), block)
        assert torch.equal(_bytes(host), _bytes(want))
        assert torch.equal(_bytes(dev), _bytes(want))


@pytest.mark.cuda
def test_cuda_paged_gather_staged_tables_stay_correct(cuda):
    """Host tables in quick succession go through the pinned staging buffer:
    no upload overwrites a table still in flight."""
    x = torch.randn(2, 64 * 16, 128, device=cuda).to(torch.bfloat16)
    rng = np.random.default_rng(3)
    tabs = [rng.integers(0, 64, 100 + 7 * i) for i in range(12)]
    outs = [paged_gather(x, t, 16) for t in tabs]
    shared = upload_table(tabs[0], 64, cuda)
    assert shared.dtype == torch.int32 and shared.device.type == "cuda"
    outs.append(paged_gather(x, shared, 16))
    for t, o in zip(tabs + [tabs[0]], outs):
        want = paged_gather_plain(x, torch.as_tensor(t, device=cuda), 16)
        assert torch.equal(_bytes(o), _bytes(want))


@pytest.mark.cuda
def test_cuda_paged_gather_refuses_bad_tables(cuda):
    x = torch.randn(2, 64 * 16, 128, device=cuda).to(torch.bfloat16)
    for bad in ([0, 64], [-1]):
        with pytest.raises(IndexError):
            paged_gather(x, bad, 16)
        with pytest.raises(IndexError):
            upload_table(bad, 64, cuda)
    with pytest.raises(ValueError, match="int32"):
        paged_gather(x, torch.tensor([0], device=cuda), 16)      # int64


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("nb", [1, 8, 65])
@pytest.mark.parametrize("shape,offset", [
    ((33, 65), 0), ((40_000,), 0), ((262_147,), 0), ((896, 8), 3),
    ((7,), 1)], ids=["33x65", "vector", "odd", "offset", "tiny"])
def test_cuda_fanout_is_stacked_k1_singles(cuda, dtype, dist, nb, shape,
                                           offset):
    """K4 and K5 against the stacked plain K1 singles: odd n whose slices
    j >= 1 lie off x's 16-byte grid (33×65, 262 147: the scalar route),
    x off y's offset from 16 bytes (the scalar route), whole vectors (the
    vector route), and 65 streams (two launches); each launch counted
    under the route fanout_route names."""
    from repro_torch.kernels.zo_fused.kernel import fanout_route
    n = int(np.prod(shape))
    x = torch.randn(n + 16, device=cuda).to(dtype)[offset:offset + n]
    x = x.view(shape)
    seeds = [977 + 31 * j for j in range(nb)]
    a = [A[j % len(A)] for j in range(nb)]
    b = [B[j % len(B)] for j in range(nb)]
    want = torch.stack([zo_affine_plain(x, s, aj, bj, dist)
                        for s, aj, bj in zip(seeds, a, b)])
    want5 = torch.stack([zo_affine_plain(x, s, a[0], b[0], dist)
                         for s in seeds])
    _build.reset_launch_counts()
    got4 = zo_affine_multi(x, seeds, a, b, dist)
    got5 = zo_affine_batched(x, seeds, a[0], b[0], dist)
    assert torch.equal(_bytes(got4), _bytes(want))
    assert torch.equal(_bytes(got5), _bytes(want5))
    route = fanout_route(x, got4)
    assert route == ("vector" if n % 8 == 0 and offset == 0 else "scalar")
    launches = -(-nb // 64)
    for name in ("zo_affine_multi", "zo_affine_batched"):
        assert _build.launch_counts[name] == launches
        assert _build.route_counts.get(f"{name}/{route}") == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_sqnorm_rows_many_bitwise(cuda, dist):
    """K10 over many partial rows leaves in one call: be below, at and above
    1 024 and 1, ragged blocks, every phase, selections below, at and
    across one tile, and more leaves than one launch takes — each norm the
    bits of its plain version and of a one-leaf call."""
    plans = [(2747, 201, 2, 1), (100_003, 1, 2, 0), (163_840, 1024, 4, 3),
             (300_001, 280, 3, 2), (524_288, 896, 4, 0),
             (524_288 - 896, 896, 4, 0), (524_288 + 4480, 896, 4, 1),
             (15_077, 5000, 2, 1), (9000, 20_000, 3, 0)]
    plans += [(500 + 13 * i, 1 + i % 37, 2 + i % 3, i % (2 + i % 3))
              for i in range(ROWS_MAX_LEAVES)]
    ns = [p[0] for p in plans]
    seeds = [977 + 31 * i for i in range(len(plans))]
    _build.reset_launch_counts()
    got = zo_sqnorm_rows_many(ns, seeds, [p[1:] for p in plans], dist, cuda)
    assert _build.launch_counts["zo_sqnorm_rows"] == 2   # 73 leaves
    assert got.shape == (len(plans),) and got.device.type == "cuda"
    for (n, be, k, ph), s, norm in zip(plans, seeds, got):
        want = zo_sqnorm_rows_plain(n, s, be, k, ph, dist, cuda)
        assert torch.equal(norm, want)
        assert torch.equal(zo_sqnorm_rows(n, s, be, k, ph, dist, cuda), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 131_072, 300_001])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_sqnorm_bitwise(cuda, n, dist):
    k = zo_sqnorm(n, 1234, dist, cuda)
    assert k.device.type == "cuda"
    assert torch.equal(k, zo_sqnorm_plain(n, 1234, dist, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [[1], [131_071, 131_072, 131_073],
                                [300_001, 7, 1, 262_149, 131_072] * 3])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_sqnorm_many_bitwise(cuda, ns, dist):
    """K6 over many leaves in one call: each leaf's norm has the bits its
    plain version (and a one-leaf call) gives it alone."""
    seeds = [977 + 31 * i for i in range(len(ns))]
    _build.reset_launch_counts()
    got = zo_sqnorm_many(ns, seeds, dist, cuda)
    assert _build.launch_counts["zo_sqnorm"] == 1
    assert got.shape == (len(ns),) and got.device.type == "cuda"
    for n, s, norm in zip(ns, seeds, got):
        want = zo_sqnorm_plain(n, s, dist, cuda)
        assert torch.equal(norm, want)
        assert torch.equal(zo_sqnorm(n, s, dist, cuda), want)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_sqnorm_shares_fold_to_the_whole_norm(cuda, parts, dist):
    """K6's ``share`` route: each rank's share of the tiles summed on the
    card, the shares gathered and folded by the card's fold, bitwise the
    one-call norms — also where a leaf's tiles straddle two shares and
    where a share is empty."""
    from repro_torch.kernels.zo_fused import multi as km
    ns = [300_001, 7, 131_072, 1]
    seeds = [977 + 31 * i for i in range(len(ns))]
    whole = zo_sqnorm_many(ns, seeds, dist, cuda)
    tiles = sum(-(-n // km.TILE_ELEMS) for n in ns)
    per = -(-tiles // parts)
    shares = [km.share_sums_plain(ns, seeds, dist, cuda,
                                  *_build.share_range(tiles, r, parts))
              for r in range(parts)]
    every = torch.cat([torch.nn.functional.pad(sh, (0, per - len(sh)))
                       for sh in shares])
    for r in range(parts):
        def gather(mine, r=r):
            assert torch.equal(mine[:len(shares[r])], shares[r])
            return every
        _build.reset_launch_counts()
        got = zo_sqnorm_many(ns, seeds, dist, cuda, (r, parts, gather))
        assert _build.route_counts == {"zo_sqnorm/share": 1}
        assert torch.equal(got, whole), (r, got, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_fanout_shard_route_is_the_slice(cuda, dtype, dist):
    """K4 and K5 on every rank's shard (``shard=``): bitwise their plain
    versions' shard writes and the slices of the whole fan-out, on leaves
    cut on each dim — shard rows of whole 16-byte vectors and not."""
    g = torch.Generator(device="cuda").manual_seed(9)
    for shape in ((6, 13, 20), (4, 64, 96)):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        whole5 = zo_affine_batched(x, SEEDS[:3], 0.999, -0.0123, dist)
        whole4 = zo_affine_multi(x, SEEDS[:3], A[:3], B[:3], dist)
        for dim in range(len(shape)):
            for parts in (2, 4):
                for r in range(parts):
                    sl, smap = _build.shard_window(shape, dim, parts, r)
                    loc = x[sl].contiguous()
                    got5 = zo_affine_batched(loc, SEEDS[:3], 0.999, -0.0123,
                                             dist, shard=smap)
                    got4 = zo_affine_multi(loc, SEEDS[:3], A[:3], B[:3],
                                           dist, shard=smap)
                    cut = (slice(None),) + sl
                    assert torch.equal(got5, whole5[cut].contiguous())
                    assert torch.equal(got4, whole4[cut].contiguous())
                    assert torch.equal(got5, zo_affine_batched_plain(
                        loc, SEEDS[:3], 0.999, -0.0123, dist, smap))
                    assert torch.equal(got4, zo_affine_multi_plain(
                        loc, SEEDS[:3], A[:3], B[:3], dist, smap))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("shape,R,k", [((41, 67), 3, 2), ((3, 17, 29), 1, 3),
                                       ((100_003,), 96, 2), ((130, 21), 96, 1)],
                         ids=["2d", "3d", "1d", "k1"])
def test_cuda_rows_kernels_bitwise(cuda, dtype, dist, shape, R, k):
    """K7 (in place too), K8 and K9 against their plain versions at every
    phase; K10 bitwise against its plain version."""
    x = torch.randn(shape, device=cuda).to(dtype)
    width = 1 if len(shape) == 1 else int(np.prod(shape[1:]))
    be = R * width
    for phase in range(k):
        s, a, b = SEEDS, A, B
        assert torch.equal(zo_affine_rows(x, 7, 0.999, -0.0123, be, k, phase,
                                          dist),
                           zo_affine_rows_plain(x, 7, 0.999, -0.0123, be, k,
                                                phase, dist))
        y = x.clone()
        zo_affine_rows(y, 7, 0.999, -0.0123, be, k, phase, dist, out=y)
        assert torch.equal(y, zo_affine_rows_plain(x, 7, 0.999, -0.0123, be,
                                                   k, phase, dist))
        assert torch.equal(zo_affine_multi_rows(x, s, a, b, be, k, phase,
                                                dist),
                           zo_affine_multi_rows_plain(x, s, a, b, be, k,
                                                      phase, dist))
        assert torch.equal(zo_affine_chain_rows(x, s, a, b, be, k, phase,
                                                dist),
                           zo_affine_chain_rows_plain(x, s, a, b, be, k,
                                                      phase, dist))
        n = x.numel()
        assert torch.equal(zo_sqnorm_rows(n, 99, be, k, phase, dist, cuda),
                           zo_sqnorm_rows_plain(n, 99, be, k, phase, dist,
                                                cuda))


@pytest.mark.cuda
def test_cuda_rows_kernels_match_the_jax_fixture(cuda):
    """K7–K9 bitwise, K10 within SQNORM_RTOL, against the values JAX
    computed (``tests/data/zo_rows_golden.npz``)."""
    g = np.load(ROWS_GOLDEN)
    seeds = [int(v) for v in g["seeds"]]
    i = 0
    while f"plan_{i}" in g.files:
        _, k, phase, be = (int(v) for v in g[f"plan_{i}"])
        for name, dt, iv in (("f32", torch.float32, np.int32),
                             ("bf16", torch.bfloat16, np.int16)):
            x = torch.from_numpy(g[f"{name}_x_{i}"].view(iv).copy()).view(dt)
            x = x.to(cuda)
            bits = lambda t: t.cpu().view(torch.int32 if t.element_size() == 4  # noqa: E731
                                          else torch.int16).numpy()
            assert np.array_equal(bits(zo_affine_rows(
                x, seeds[0], float(g["a"][0]), float(g["b"][0]), be, k,
                phase)), g[f"{name}_affine_{i}"].view(iv))
            assert np.array_equal(bits(zo_affine_multi_rows(
                x, seeds, g["a"], g["b"], be, k, phase)),
                g[f"{name}_multi_{i}"].view(iv))
            assert np.array_equal(bits(zo_affine_chain_rows(
                x, seeds, g["a"], g["b"], be, k, phase)),
                g[f"{name}_chain_{i}"].view(iv))
        n = g[f"{name}_x_{i}"].size
        got = float(zo_sqnorm_rows(n, seeds[1], be, k, phase, "gaussian",
                                   cuda))
        assert abs(got - float(g[f"sq_{i}"])) <= SQNORM_RTOL * g[f"sq_{i}"]
        i += 1
    assert i == 4


#: K7's and K9's routes: (shape, R, k, offset of the leaf in its buffer,
#: the route): a row-block of whole 16-byte vectors (at R = 3 with a ragged
#: last block too), odd widths, the 1-D be = 1, a leaf off 16 bytes
ROUTE_CASES = [((301, 64), 1, 4, 0, "vector"), ((301, 64), 3, 2, 0, "vector"),
               ((301, 67), 1, 4, 0, "scalar"), ((896,), 1, 4, 0, "scalar"),
               ((301, 64), 1, 4, 1, "scalar")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("shape,R,k,offset,route", ROUTE_CASES,
                         ids=["vector", "ragged", "odd", "1d", "offset"])
def test_cuda_rows_routes_bitwise(cuda, dtype, dist, shape, R, k, offset,
                                  route):
    """Both routes of K7 and K9, in place, at every phase: bitwise their
    plain versions, each launch counted under the route rows_route names,
    and no element outside the selection — nor outside the leaf in its
    buffer — changed."""
    n = int(np.prod(shape))
    be = R * (1 if len(shape) == 1 else int(np.prod(shape[1:])))
    base = torch.randn(n + 16, device=cuda).to(dtype)
    x = base[offset:offset + n].view(shape)
    for phase in range(k):
        for name, run, plain in (
                ("zo_affine_rows",
                 lambda y: zo_affine_rows(y, 7, 0.999, -0.0123, be, k, phase,
                                          dist, out=y),
                 lambda: zo_affine_rows_plain(x, 7, 0.999, -0.0123, be, k,
                                              phase, dist)),
                ("zo_affine_chain_rows",
                 lambda y: zo_affine_chain_rows(y, SEEDS, A, B, be, k, phase,
                                                dist, out=y),
                 lambda: zo_affine_chain_rows_plain(x, SEEDS, A, B, be, k,
                                                    phase, dist))):
            buf = base.clone()
            y = buf[offset:offset + n].view(shape)
            assert rows_route(y, be) == route
            _build.reset_launch_counts()
            run(y)
            assert _build.launch_counts[name] == 1
            assert _build.route_counts == {f"{name}/{route}": 1}
            assert torch.equal(_bytes(y), _bytes(plain()))
            assert torch.equal(_bytes(buf[:offset]), _bytes(base[:offset]))
            assert torch.equal(_bytes(buf[offset + n:]),
                               _bytes(base[offset + n:]))


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_rows_chain_of_70_streams_on_the_vector_route(cuda, dist):
    """70 streams run as two launches, both on the vector route, bitwise
    the plain sequential fold."""
    x = torch.randn(301, 64, device=cuda).to(torch.bfloat16)
    seeds = list(range(70))
    a, b = [0.999] * 70, [1e-3] * 70
    _build.reset_launch_counts()
    got = zo_affine_chain_rows(x, seeds, a, b, 64, 4, 1, dist)
    assert _build.route_counts == {"zo_affine_chain_rows/vector": 2}
    assert torch.equal(_bytes(got), _bytes(zo_affine_chain_rows_plain(
        x, seeds, a, b, 64, 4, 1, dist)))


@pytest.mark.cuda
def test_cuda_rows_route_is_the_launchers(cuda):
    """rows_route repeats the C launcher's rule (zo_rows_route)."""
    from repro_torch.kernels.zo_fused.kernel import DTYPE_CODES
    from repro_torch.kernels.zo_fused.rows import _lib
    lib = _lib()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        base = torch.zeros(4096, dtype=dtype, device=cuda)
        for offset in (0, 1, 4, 8):
            x = base[offset:offset + 2048]
            for be in (1, 3, 4, 8, 64, 67, 896, 2048, 5000):
                c = lib.zo_rows_route(x.data_ptr(), x.data_ptr(),
                                      min(be, x.numel()), DTYPE_CODES[dtype])
                assert c == (1 if rows_route(x, be) == "vector" else 0)


def _wkv_inputs(cuda, B, S, H, hd, lw=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    sh = (B, S, H, hd)
    r, k, v = (torch.randn(sh, generator=g, device=cuda) for _ in range(3))
    if lw is None:
        logw = -torch.exp(torch.randn(sh, generator=g, device=cuda)
                          .clamp(-8, 1))
    else:
        logw = torch.full(sh, lw, device=cuda)
    u = torch.randn(H, hd, generator=g, device=cuda)
    s0 = torch.randn(B, H, hd, hd, generator=g, device=cuda)
    return r, k, v, logw, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk,lw", [
    (2, 64, 3, 64, 16, None), (1, 36, 40, 64, 9, None), (3, 7, 2, 32, 1, None),
    (2, 48, 2, 16, 16, None), (2, 64, 2, 64, 16, -2.718281828459045),
    (2, 64, 2, 64, 16, -0.00033546262790251185)],
    ids=["C16", "C9", "C1", "hd16", "rate-e", "rate-e^-8"])
def test_cuda_wkv6_within_tolerance_of_plain(cuda, B, S, H, hd, chunk, lw):
    """K11 on the model's layout (through strides, and on a padded,
    non-contiguous view) and on JAX's (BH, S, hd) layout."""
    args = _wkv_inputs(cuda, B, S, H, hd, lw)
    y, s = wkv_ops.wkv6(*args, chunk=chunk)
    yp, sp = wkv_ops.wkv6_plain(*args, chunk=chunk)
    for got, want in ((y, yp), (s, sp)):
        assert float((got - want).abs().max()) <= K11_REL * float(
            want.abs().max())
    again = wkv_ops.wkv6(*args, chunk=chunk)
    assert torch.equal(again[0], y) and torch.equal(again[1], s)  # no atomics
    r, k, v, lw_, u, s0 = args
    wide = torch.zeros(B, S, H, 2 * hd, device=cuda)
    wide[..., :hd] = r
    y2, _ = wkv_ops.wkv6(wide[..., :hd], k, v, lw_, u, s0, chunk=chunk)
    assert torch.equal(y2, y)


@pytest.mark.cuda
def test_cuda_wkv6_matches_the_jax_fixture(cuda):
    g = np.load(WKV6_GOLDEN)
    for i in range(2):
        ins = [torch.from_numpy(g[f"{n}_{i}"]).to(cuda) for n in
               ("r", "k", "v", "lw", "u", "s0")]
        y, s = wkv6_chunked(*ins, chunk=int(g[f"chunk_{i}"]))
        for got, key in ((y, "y"), (s, "s")):
            for ref in (key, f"{key}_ref"):
                np.testing.assert_allclose(got.cpu().numpy(),
                                           g[f"{ref}_{i}"], atol=5e-4,
                                           rtol=1e-3)


@pytest.mark.cuda
def test_cuda_wkv6_refuses_outside_its_envelope(cuda):
    """C past 16 leaves the f32 envelope and is refused; a head dim is not
    (48 runs at the 64 instance, zero-padded)."""
    args = _wkv_inputs(cuda, 1, 32, 1, 64)
    with pytest.raises(ValueError, match="envelope"):
        wkv_ops.wkv6(*args, chunk=32)
    args = _wkv_inputs(cuda, 1, 16, 1, 48)
    y, s = wkv_ops.wkv6(*args, chunk=16)
    yp, sp = wkv_ops.wkv6_plain(*args, chunk=16)
    for got, want in ((y, yp), (s, sp)):
        assert float((got - want).abs().max()) <= K11_REL * float(
            want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 32, 96, 128, 320, 2048])
@pytest.mark.parametrize("S,chunk", [(1, 1), (100, 10), (256, 16)])
def test_cuda_wkv6_head_dims(cuda, hd, S, chunk):
    """K11 at head dims below, at and between its instances, past 256
    (channel slices) and past what shared memory holds (the state in global
    memory), within K11_REL of its plain version."""
    args = _wkv_inputs(cuda, 2, S, 3, hd, seed=hd + S)
    y, s = wkv_ops.wkv6(*args, chunk=chunk)
    yp, sp = wkv_ops.wkv6_plain(*args, chunk=chunk)
    for got, want in ((y, yp), (s, sp)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= K11_REL * float(
            want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,chunk", [(16, 256, 16), (1, 8, 8), (1, 40, 8),
                                       (1, 48, 16), (1, 32, 16)])
def test_cuda_wkv6_tiled_route_within_tolerance(cuda, B, S, chunk):
    """rwkv6-3b's heads (H 40, hd 64) at the training shape and at
    single-request prefills (S 8 and 40 at C 8; 40 tokens padded to 48 at
    C 16, as the model pads them) take the tiled route, within K11_REL of
    the plain version, and two launches agree bit for bit."""
    args = _wkv_inputs(cuda, B, S, 40, 64, seed=B + S)
    assert wkv6_plan(*args[:4]) == "tile"
    _build.reset_launch_counts()
    y, s = wkv_ops.wkv6(*args, chunk=chunk)
    assert _build.route_counts == {"wkv6_chunked/tile": 1}
    yp, sp = wkv_ops.wkv6_plain(*args, chunk=chunk)
    for got, want in ((y, yp), (s, sp)):
        assert float((got - want).abs().max()) <= K11_REL * float(
            want.abs().max())
    again = wkv_ops.wkv6(*args, chunk=chunk)
    assert torch.equal(again[0], y) and torch.equal(again[1], s)


@pytest.mark.cuda
def test_cuda_wkv6_unaligned_rows_take_the_scalar_route(cuda):
    """Rows of r that do not start on 16 bytes cannot be copied by the
    tiled kernel's cp.async: the launch takes the scalar route, and both
    routes agree within K11_REL."""
    args = _wkv_inputs(cuda, 2, 32, 3, 64, seed=5)
    r = args[0]
    wide = torch.zeros(2, 32, 3, 65, device=cuda)
    wide[..., 1:] = r
    shifted = wide[..., 1:]
    assert wkv6_plan(shifted, *args[1:4]) == "scalar"
    _build.reset_launch_counts()
    y, s = wkv_ops.wkv6(shifted, *args[1:], chunk=16)
    assert _build.route_counts == {"wkv6_chunked/scalar": 1}
    yt, st = wkv_ops.wkv6(*args, chunk=16)
    for got, want in ((y, yt), (s, st)):
        assert float((got - want).abs().max()) <= K11_REL * float(
            want.abs().max())


@pytest.mark.cuda
def test_cuda_wkv6_tiled_route_empty_sequence(cuda):
    """S = 0 on the tiled route: no chunk is read, y is empty and the
    final state is s0, bit for bit."""
    r, k, v, lw, u, s0 = _wkv_inputs(cuda, 2, 0, 40, 64, seed=3)
    assert wkv6_plan(r, k, v, lw) == "tile"
    y, s = wkv_ops.wkv6(r, k, v, lw, u, s0, chunk=16)
    assert y.shape == (2, 0, 40, 64) and torch.equal(s, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("form", ["z", "axpbz", "xpbz", "restore"])
def test_cuda_x1_equals_plain(cuda, dtype, dist, form):
    """X1 ≡ its plain version bitwise: odd widths, a leaf off 16 bytes, a z
    scale and a band list."""
    g = torch.Generator().manual_seed(0)
    base = torch.randn(1 + 1001 * 3, generator=g).to(dtype).to(cuda)
    x = base[1:]                                   # off 16 bytes
    for zs, bands in ((None, None), (0.75, None),
                      (None, [(3, 700), (1500, 2999)])):
        kw = dict(a=0.5, b=-0.25, e=0.125, zs=zs, dist=dist, bands=bands)
        xin = None if form == "z" else x
        got = x1.zo_affine_threefry(xin, (5, 9), form, out=x.clone(), **kw)
        want = x1.zo_affine_threefry_plain(xin, (5, 9), form, out=x.clone(),
                                           **kw)
        assert torch.equal(got.view(torch.int16 if dtype != torch.float32
                                    else torch.int32),
                           want.view(torch.int16 if dtype != torch.float32
                                     else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_x1_routes_and_counter_words(cuda, dtype, dist):
    """X1 ≡ its plain version bitwise on each route — ``vector`` (x and y
    alike against 16 bytes), ``scalar`` (x off by one element), ``bands``
    — on leaves of 1, 7 and 8·37 + 3 elements, at counter offsets whose
    launch crosses 2³² (cut into two launches, each with its own high
    word), crosses 2³¹, or does neither; each launch counted under its
    route."""
    g = torch.Generator().manual_seed(1)
    base = torch.randn(1 + 8 * 37 + 3, generator=g).to(dtype).to(cuda)
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    _build.reset_launch_counts()
    calls = {"vector": 0, "scalar": 0, "bands": 0}
    for n in (1, 7, 8 * 37 + 3):
        for off in ((1 << 32) - 150, (1 << 31) - 2, (1 << 32) + 5, 0):
            for route in calls:
                x = base[1:n + 1] if route == "scalar" else base[:n].clone()
                bands = [(0, n // 2 + 1)] if route == "bands" else None
                for form in ("z", "axpbz", "xpbz", "restore"):
                    kw = dict(a=0.5, b=-0.25, e=0.125, dist=dist,
                              bands=bands, offset=off)
                    xin = None if form == "z" else x
                    y = torch.empty(n, dtype=dtype, device=cuda)
                    got = x1.zo_affine_threefry(xin, (7, 3), form,
                                                out=y, **kw)
                    want = x1.zo_affine_threefry_plain(
                        xin, (7, 3), form, out=torch.empty_like(y), **kw)
                    if bands is not None:
                        got, want = got[:n // 2 + 1], want[:n // 2 + 1]
                    assert torch.equal(got.view(ints), want.view(ints)), (
                        n, off, route, form)
                    r = "vector" if form == "z" and route == "scalar" \
                        else route
                    launches = (1 if bands is not None else len(
                        x1.whole_launches(n, off, None, y.data_ptr(),
                                          y.element_size())))
                    calls[r] += launches
    assert {r: _build.route_counts.get(f"zo_affine_threefry/{r}", 0)
            for r in calls} == calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_cuda_x1_original_layout_equals_plain(cuda, dtype, dist):
    """X1's original-layout route ≡ its plain version bitwise, every form:
    whole leaves with odd and even word counts, windows (offset and the
    leaf's total) that straddle the half h, a band list, and windows of
    virtual leaves past 2^32 − 1 words (one key per block), each launch
    counted under ``zo_affine_threefry_original``; then the cases of the
    pairs route's vector design (``_hold_x1_original_vector_design``)."""
    g = torch.Generator().manual_seed(2)
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    big = (1 << 32) + 10 if dtype == torch.float32 else 17_179_869_201
    cases = [(n, 0, n, None) for n in (1, 3, 5, 33 * 65, 4097, 4102)]
    cases += [(1000, 2000, 4097, None), (40, 2030, 4097, None),
              (4097, 0, 4097, [(3, 700), (1500, 2999), (4000, 4097)]),
              (64, big - 80, big, None), (64, big - 64, big, [(0, 30)])]
    _build.reset_launch_counts()
    for n, off, total, bands in cases:
        x = torch.randn(n, generator=g).to(dtype).to(cuda)
        for form in ("z", "axpbz", "xpbz", "restore"):
            kw = dict(a=0.5, b=-0.25, e=0.125, dist=dist, bands=bands,
                      offset=off, total=total)
            xin = None if form == "z" else x
            got = x1.zo_affine_threefry(xin, (5, 9), form, out=x.clone(),
                                        partitionable=False, **kw)
            want = x1.zo_affine_threefry_plain(xin, (5, 9), form,
                                               out=x.clone(),
                                               partitionable=False, **kw)
            assert torch.equal(got.view(ints), want.view(ints)), (
                n, off, form)
    assert _build.launch_counts["zo_affine_threefry_original"] > 0
    assert _build.launch_counts["zo_affine_threefry"] == 0
    _hold_x1_original_vector_design(cuda, dtype, dist)


def _hold_x1_original_vector_design(cuda, dtype, dist):
    """The pairs route's 16-byte design ≡ its plain version bitwise, every
    form, in place: whole leaves of odd and even m at every residue of h
    mod R (site 2's shift), more than one chunk of runs (junctions); x or
    y one element off the other's 16-byte grid (all-scalar launches); and
    windows off the grid, inside one half, straddling h with their pair
    ranges meeting, and nearly the whole leaf."""
    g = torch.Generator().manual_seed(4)
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    epw = 32 // x1.bit_width(dtype, dist)
    R = 16 // (epw * dtype.itemsize)

    def hold(n, off, total, form, xshift=0, yshift=0):
        x = torch.randn(n + 8, generator=g).to(dtype).to(cuda)
        x = x[xshift:xshift + n]
        y = (x if xshift == yshift else
             torch.empty(n + 8, dtype=dtype, device=cuda)[yshift:yshift + n])
        kw = dict(a=0.5, b=-0.25, e=0.125, dist=dist, offset=off,
                  total=total, partitionable=False)
        want = x1.zo_affine_threefry_plain(
            None if form == "z" else x.clone(), (5, 9), form,
            out=torch.empty_like(x), **kw)
        got = x1.zo_affine_threefry(None if form == "z" else x, (5, 9),
                                    form, out=y, **kw)
        assert torch.equal(got.view(ints), want.view(ints)), (
            n, off, total, form, xshift, yshift)

    _build.reset_launch_counts()
    for res in range(R):
        h = 70 * 32 * R + res               # 70 warp-runs: two chunks
        for m in (2 * h, 2 * h - 1):
            for form in ("z", "axpbz", "xpbz", "restore"):
                hold(m * epw - (res % 2) * (epw - 1), 0,
                     m * epw - (res % 2) * (epw - 1), form)
    n = 9000 * epw + 3
    H = ((-(-n // epw) + 1) // 2) * epw
    for form in ("axpbz", "z"):
        hold(n, 0, n, form, xshift=1)
        hold(n, 0, n, form, yshift=1)
        for lo, hi in ((3, H // 2), (H + 5, n - 1), (H - 700, H + 900),
                       (H // 3, H + H // 2), (8, n - 8)):
            hold(hi - lo, lo, n, form)
    routes = dict(_build.route_counts)
    assert routes["zo_affine_threefry_original/pairs/vector"] > 0
    assert routes["zo_affine_threefry_original/pairs/scalar"] > 0


@pytest.mark.cuda
def test_cuda_x1_exhaustive_f32_and_tables(cuda):
    """The f32 gaussian over all 2^23 uniform mantissas and the bf16 / f16
    tables: the kernel's against the plain version's, bitwise."""
    assert x1.normal_f32_selftest(cuda) == 0
    for dt in (torch.bfloat16, torch.float16):
        assert x1.table_selftest(dt, cuda) == 0


# --------------------------------------------------------------------------- #
# Leaves of 2^32 elements and more; the initializer's peak
# --------------------------------------------------------------------------- #
BIG_N = (1 << 32) + (3 << 20) + 5       # one bf16 leaf past 2^32, 8.6 GB
BIG_WINDOW = 1 << 16


@pytest.mark.cuda
def test_cuda_k1_and_x1_across_2_31_and_2_32_on_one_leaf(cuda):
    """K1 (counter = flat index mod 2^32, JAX's uint32 wrap) and X1 (the
    64-bit index in threefry's two counter words), each in place over one
    bf16 leaf of more than 2^32 elements, bitwise their plain versions on
    windows at its start, across counters 2^31, 2^32 and 3·2^31, and at its
    end — when the card has room for the leaf."""
    free, _ = torch.cuda.mem_get_info()
    if free < 2 * BIG_N * 2:
        pytest.skip(f"needs {2 * BIG_N * 2 / 2**30:.0f} GiB free on the card")
    leaf = torch.empty(BIG_N, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    for lo in range(0, BIG_N, 1 << 28):
        hi = min(lo + (1 << 28), BIG_N)
        leaf[lo:hi] = torch.randn(hi - lo, generator=g, device=cuda)
    starts = [0, (1 << 31) - BIG_WINDOW // 2, (1 << 32) - BIG_WINDOW // 2,
              (3 << 31) - BIG_WINDOW // 2, BIG_N - BIG_WINDOW]
    key, b = (31337, 7), -0.0001220703125
    for kernel in ("K1", "X1"):
        saved = [(s, leaf[s:s + BIG_WINDOW].clone()) for s in starts]
        if kernel == "K1":
            zo_affine(leaf, 987654321, 1.0, 1e-3, out=leaf)
        else:
            x1.zo_affine_threefry(leaf, key, "axpbz", a=1.0, b=b, out=leaf)
        for s, x in saved:
            want = (zo_affine_plain(x, 987654321, 1.0, 1e-3, offset=s)
                    if kernel == "K1" else
                    x1.zo_affine_threefry_plain(x, key, "axpbz", a=1.0, b=b,
                                                offset=s))
            got = leaf[s:s + BIG_WINDOW]
            assert torch.equal(got.view(torch.int16),
                               want.view(torch.int16)), (kernel, s)


@pytest.mark.cuda
def test_cuda_init_peak_is_one_layer_over_the_parameters(cuda):
    """The registry's initializer at one opt-30b layer's shapes (2 layers,
    full width): the card's peak allocation over what it allocated before
    is the parameters plus the largest f32 draw — one layer's slice of a
    stacked leaf (7168 × 28672 f32 for w1) or the whole embedding / head —
    never a whole stacked leaf in f32."""
    from repro_torch.models import all_archs, bundle
    from repro_torch.tree_utils import tree_leaves
    cfg = all_archs()["opt-30b"].cfg.replace(n_layers=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = bundle(cfg).init(0, device=cuda)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    nbytes = sum(p.numel() * p.element_size() for p in leaves)
    draw = 4 * max(p[0].numel() if p.dim() == 3 else p.numel()
                   for p in leaves)
    extra = torch.cuda.max_memory_allocated() - base - nbytes
    assert 0 <= extra <= draw + (64 << 20), (extra, draw)
    stacked = 4 * cfg.n_layers * cfg.d_model * cfg.d_ff
    assert extra < stacked            # w1 drawn whole would need this much


@pytest.mark.cuda
def test_cuda_k2_refuses_autograd_and_k11_card_grads_equal_cpu(cuda):
    """K2 has no backward (nor has JAX's Pallas flash): on the card an
    input that requires grad under grad mode raises before any launch;
    under ``no_grad`` it launches.  K11 differentiates on the card: its
    forward is the kernel (one launch) and its backward the VJP of the
    plain chunk form (one ``wkv6_chunked_backward`` record); dr, dk, dv,
    dlw, du and ds0 for dy and ds_final within ``K11_GRAD_REL`` of each
    gradient's largest |value| of the CPU's (the plain version's autograd
    there) — the forward's f32 summation order differs, the backward is
    the same graph."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 16, 2, 8, generator=g, device=cuda).requires_grad_()
    kv = torch.randn(1, 16, 2, 8, generator=g, device=cuda)
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention .* no backward"):
        flash_attention(q, kv, kv)
    assert _build.launch_counts["flash_attention"] == 0
    with torch.no_grad():
        flash_attention(q, kv, kv)
    assert _build.launch_counts["flash_attention"] == 1
    B, S, H, hd = 2, 48, 3, 16
    r, k, v = (torch.randn(B, S, H, hd, generator=g, device=cuda)
               for _ in range(3))
    lw = -torch.exp(torch.randn(B, S, H, hd, generator=g, device=cuda)
                    .clamp(-8, 1))
    u = torch.randn(H, hd, generator=g, device=cuda)
    s0 = torch.randn(B, H, hd, hd, generator=g, device=cuda)
    dy = torch.randn(B, S, H, hd, generator=g, device=cuda)
    ds = torch.randn(B, H, hd, hd, generator=g, device=cuda)
    grads = {}
    for dev in ("cpu", "cuda"):
        ins = [t.to(dev).requires_grad_() for t in (r, k, v, lw, u, s0)]
        _build.reset_launch_counts()
        y, s = wkv_ops.wkv6(*ins, chunk=16)
        grads[dev] = torch.autograd.grad((y, s), ins,
                                         (dy.to(dev), ds.to(dev)))
        if dev == "cuda":
            assert _build.launch_counts["wkv6_chunked"] == 1
            assert _build.record_counts["wkv6_chunked_backward"] == 1
    for gc, gg in zip(grads["cpu"], grads["cuda"]):
        scale = float(gc.abs().max())
        assert float((gg.cpu() - gc).abs().max()) <= K11_GRAD_REL * scale


@pytest.mark.cuda
def test_cuda_adam_step_is_the_cpu_step(cuda):
    """One Adam step of the qwen2-0.5b smoke model in f32 (TF32 off) on the
    card against the same step on the CPU: the loss, the gradient norm and
    θ within the f32 summation-order gap (cuBLAS against the CPU's BLAS)."""
    from repro_torch.models import all_archs, bundle
    from repro_torch.train import Adam, AdamConfig
    from repro_torch.tree_utils import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    cpu = bundle(cfg).init(0, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.arange(64, dtype=torch.int32).reshape(2, 32) % 256
    out = {}
    for name, params in (("cpu", cpu), ("cuda", card)):
        opt = Adam(AdamConfig(lr=1e-3))
        dev = tree_leaves(params)[0].device
        batch = {"tokens": toks.to(dev), "labels": toks.roll(1).to(dev)}
        p, _, m = opt.step_fn(bundle(cfg).loss_fn())(params, opt.init(params),
                                                     batch)
        out[name] = (float(m["loss"]), float(m["grad_norm"]),
                     [t.cpu() for t in tree_leaves(p)])
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-5
    assert abs(out["cpu"][1] - out["cuda"][1]) < 1e-5 * out["cpu"][1]
    for a, b in zip(out["cpu"][2], out["cuda"][2]):
        assert float((a - b).abs().max()) <= 2e-3   # ≤ 2η: Adam's sign step


def _spsa_step_card_vs_cpu(cuda, arch, make_batch, selection="full"):
    """One mezo spsa step on the ``xla`` stream of ``arch``'s smoke config
    (f32, TF32 off), on the card and on the CPU, from the same θ₀ and
    batch: the losses at θ ± εz within the f32 summation-order gap (1e-5),
    so g within 1e-5 / ε, and θ within lr · |Δg| · 6 (|z| < 6) plus 1e-6 —
    z is X1's on the card and its plain version on the CPU, bitwise."""
    from repro_torch import zo
    from repro_torch.models import all_archs, bundle
    from repro_torch.tree_utils import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = all_archs()[arch].smoke_cfg
    cpu = bundle(cfg).init(0, device="cpu")
    card = tree_map(lambda t: t.to(cuda, copy=True), cpu)
    batch = make_batch(bundle(cfg))
    out = {}
    lr, eps = 1e-3, 1e-3
    for name, params in (("cpu", cpu), ("cuda", card)):
        opt = zo.mezo(lr=lr, eps=eps, backend="xla", selection=selection)
        dev = tree_leaves(params)[0].device
        p, _, m = opt.step_fn(bundle(cfg).loss_fn())(
            params, opt.init(params, seed=0),
            {k: t.to(dev) for k, t in batch.items()})
        out[name] = (float(m["loss"]), float(m["projected_grad"]),
                     [t.cpu() for t in tree_leaves(p)])
    assert abs(out["cpu"][0] - out["cuda"][0]) < 1e-5
    dg = abs(out["cpu"][1] - out["cuda"][1])
    assert dg <= 1e-5 / eps
    for a, b in zip(out["cpu"][2], out["cuda"][2]):
        assert float((a - b).abs().max()) <= lr * dg * 6 + 1e-6


def _lm_batch(b):
    toks = (torch.arange(64, dtype=torch.int32).reshape(2, 32) * 7) % 256
    return {"tokens": toks, "labels": toks.roll(1)}


@pytest.mark.cuda
def test_cuda_granite_smoke_spsa_step_is_the_cpu_step(cuda):
    """granite-moe-3b-a800m's smoke config (experts in 5 single leaves)
    under its default selection: ``_spsa_step_card_vs_cpu``."""
    from repro_torch.models import all_archs, bundle
    _spsa_step_card_vs_cpu(cuda, "granite-moe-3b-a800m", _lm_batch,
                           bundle(all_archs()["granite-moe-3b-a800m"]
                                  .smoke_cfg).default_selection())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-large-v3"])
def test_cuda_hybrid_and_encdec_smoke_spsa_step_is_the_cpu_step(cuda, arch):
    """hymba-smoke (SSD heads beside the windowed attention) on an lm
    batch, and whisper-smoke on ``make_batch``'s frames and tokens:
    ``_spsa_step_card_vs_cpu``."""
    from repro_torch.perturb.stream import prng_key

    def batch(b):
        if arch == "hymba-1.5b":
            return _lm_batch(b)
        return b.make_batch(prng_key(0), 2, 16, device="cpu")

    _spsa_step_card_vs_cpu(cuda, arch, batch)


@pytest.mark.cuda
def test_cuda_dense_slab_serving_ids_are_the_cpus(cuda):
    """The engine's dense slab on hymba-smoke in f32 (window 16, the SSM
    state per slot): 5 requests over 2 slots, 24 new tokens each, so every
    ring wraps; the greedy ids on the card equal the CPU's."""
    from repro_torch.models import all_archs, bundle
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree_utils import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = all_archs()["hymba-1.5b"].smoke_cfg
    cpu = bundle(cfg).init(0, device="cpu")
    tpl = [(7 * i) % 200 + 3 for i in range(13)]
    prompts = ([tpl + [50 + i] for i in range(3)] + [[3, 5, 7, 9] * 3]
               + [[4, 8, 15]])
    ids = {}
    for dev, params in (("cpu", cpu),
                        (cuda, tree_map(lambda t: t.to(cuda), cpu))):
        eng = ServeEngine(cfg, params, slots=2, max_len=48, device=dev)
        reqs = [Request(i, p, max_new_tokens=24)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert not eng.paged
        ids[str(dev)] = [r.out_ids for r in reqs]
    assert ids[str(cuda)] == ids["cpu"]
    assert all(len(x) == 24 for x in ids["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_functional_api_launches_x1_out_of_place(cuda, dtype):
    """``perturb.xla``'s functional writes on the card: each launches X1
    into a fresh leaf (counted), the caller's leaves keep their bits, and
    the result equals the same write on the CPU (X1's plain version) and
    the backend's in-place write, bitwise; under a rows plan the bands
    route runs and the unselected rows are θ's."""
    from repro_torch.perturb import StreamRef, get_backend
    from repro_torch.perturb import xla as fx
    from repro_torch.perturb.stream import fold_in, prng_key
    from repro_torch.select import rows
    g = torch.Generator().manual_seed(5)
    cpu = {f"l{i}": torch.randn(s, generator=g).to(dtype)
           for i, s in enumerate([(64, 96), (33, 65), (1000,)])}
    dev = {k: v.to(cuda) for k, v in cpu.items()}
    before = {k: v.clone() for k, v in dev.items()}
    key = fold_in(prng_key(3), 11)
    ref = StreamRef(key).with_selection(rows(block=2, k=3), 1)
    kw = {"mask": ref.selection_mask(cpu), "blocks": ref.selection_blocks(cpu)}
    for sel in ({}, kw):
        for write in (lambda t: fx.perturb(t, key, 1e-3, **sel),
                      lambda t: fx.fused_restore_update(
                          t, key, 1e-3, np.float32(1.2e-3), 1e-4, **sel),
                      lambda t: fx.apply_rank1(
                          t, key, np.float32(1.2e-3), np.float32(1e-3),
                          **sel)):
            _build.reset_launch_counts()
            got = write(dev)
            torch.cuda.synchronize()
            assert _build.launch_counts["zo_affine_threefry"] > 0
            if sel:
                assert _build.route_counts.get("zo_affine_threefry/bands")
            want = write(cpu)
            for k in dev:
                assert got[k] is not dev[k]
                assert torch.equal(dev[k], before[k])
                assert torch.equal(got[k].cpu(), want[k])
    inplace = {k: v.clone() for k, v in dev.items()}
    get_backend("xla").perturb(inplace, StreamRef(key), 1e-3)
    got = fx.perturb(dev, key, 1e-3)
    assert all(torch.equal(got[k], inplace[k]) for k in dev)
