#!/usr/bin/env python3
"""Chip smoke of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py                  # from the root of a checkout; one card
    python3 chip_smoke.py --kernels-only   # build and check the kernels, stop

In order: prints the card's name and power limit; builds the five CUDA
sources under ``src/repro_torch/kernels/*/csrc`` (one nvcc per source, in
parallel); holds every kernel against its plain torch version on the card —
K1 ``zo_affine``, K3 ``zo_affine_chain``, K4 ``zo_affine_multi``, K5
``zo_affine_batched``, K6 ``zo_sqnorm`` and K12 ``paged_gather`` bitwise, K1
and K3–K6 also against fixtures that JAX computed (``tests/data``, K6 within
``SQNORM_RTOL``), K2 ``flash_attention`` within a stated tolerance.  Then it
drives the port's paths at the full width of qwen2-0.5b (random bf16
weights from a seeded ``torch.Generator``, all 24 layers, ``pallas_flash``
attention), each with the launch counts set to 0 just before it and read
just after:

* serve: replay an in-process ``pallas+z2`` ledger (K1) and serve a
  shared-template workload through the paged engine (K2, K12);
* train, through ``repro_torch.train.loop.train`` with a ledger and a
  checkpoint directory, on 16 × 256-token batches: (a) ``mezo`` spsa (K1,
  K2), (b) ``fzoo(batch_seeds=8)`` (K5, K3, K2), (c) ``fzoo(batch_seeds=8,
  dist="sphere")`` (K6, K4, K3, K2), (d) ``mezo`` under ``seed_parallel(2)``
  on the one card (K3 for the group updates);
* serve the fine-tune: ``composition_for_ledger`` on phase (b)'s ledger →
  batched replay (K3) → the paged engine (K2, K12).

Checks: finite losses; two replays of each phase's ledger from θ₀ bitwise
equal; fzoo replay bitwise equal to the trained θ; sequential-spsa replay
within a stated bound in bf16 ulps of the trained θ; the spsa step's peak
memory within 10 % of one forward's; every kernel launched on its path.

Prints the step times, the ``kernels`` JSON line (launches, error, kernel /
plain / library times in ms and the roofline bound), and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero; there
is no fallback to the CPU or to a plain version on any path.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "data" / "zo_golden.npz"
MULTI_GOLDEN = ROOT / "tests" / "data" / "zo_multi_golden.npz"
RUN_DIR = ROOT / "build" / "chip_smoke_runs"

# H100 SXM peaks (NVIDIA data sheet, dense): the roofline bound's rates
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# the serving path's shapes
N_RECORDS = 4
SLOTS = 8
MAX_LEN = 1024
BLOCK = 16
TEMPLATE_LEN = 320
N_REQUESTS = 12
NEW_TOKENS = 16
# K2: one bf16 rounding of each output on both sides of an f32 computation
# whose two orders of summation differ by ~1e-6: at most one bf16 ulp apart
K2_BF16_REL, K2_BF16_ABS = 2.0 ** -7, 1e-5
K2_F32_ABS = 1e-5

# the training paths' shapes (the paper's batch of 16)
TRAIN_BATCH, TRAIN_SEQ = 16, 256
SEED = 0
LR, EPS = 1e-6, 1e-3
B_SEEDS = 8
STEPS = {"a_spsa": 20, "b_fzoo": 4, "c_sphere": 3, "d_sp2": 8}
MLP_LEAF = (24, 896, 4864)           # the stacked MLP weight (w1 / w3)
# live and replay of a sequential-spsa ledger round differently in bf16.
# Every rounding happens at a magnitude of at most |θ| + ε·Z_MAX (the chain
# visits θ ± εz; |z| < 5.9 by construction, u ≥ 2^-25) and moves the value
# by at most half a bf16 ulp there, so after T steps live and replay differ
# by at most T · (live + replay roundings per step) / 2 such ulps, doubled
# because a value may cross a binade between a rounding and the end.
# (a): live θ+εz, θ−εz, restore-update = 3, replay 1 → 2·2 per step.
# (d): 2 groups × 3 live roundings + the 2-stream K3 fold (2), replay 2 →
# 5·2 per step.
ULPS_PER_STEP = {"a_spsa": 4.0, "d_sp2": 10.0}
Z_MAX = 6.0
MEM_SLACK = 1.10
SEEDS8 = [11, -5, 2**31 - 1, 977, 3, 123456789, -2**31, 42]
A8 = [0.999, 1.0, 0.5, 1.0, 0.9990234375, 1.0, 1.0, 0.75]
B8 = [-0.0123, 0.01, 0.25, -1e-3, 0.0625, -0.5, 3e-4, 0.1]


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs, by CUDA events, after one
    warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn) -> float:
    """ms of one ``fn()`` on the host clock, synchronized on both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bits_of(t):
    import torch
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(bits_of(a), bits_of(b))


# --------------------------------------------------------------------------- #
# Kernel checks
# --------------------------------------------------------------------------- #
def check_k1(torch, np, kz) -> float:
    """K1 vs its plain version on the card, bitwise, and vs the JAX golden
    fixture; returns the max abs error seen (0 when bitwise)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for dist in ("gaussian", "rademacher"):
            for n in (1, 40_000, 262_147, 1_048_583):
                x = torch.randn(n, generator=g, device="cuda").to(dt)
                yk = kz.zo_affine(x, 987654321, 0.9990234375, -0.0123, dist)
                yp = kz.zo_affine_plain(x, 987654321, 0.9990234375, -0.0123,
                                        dist)
                if not same_bits(yk, yp):
                    fail(f"K1 {dt} {dist} n={n}: kernel != plain")
    gold = np.load(GOLDEN)
    for i, seed in enumerate(gold["seeds"]):
        n = int(gold[f"z_gauss_{i}"].shape[0])
        ones = torch.ones(n, dtype=torch.float32, device="cuda")
        zk = kz.zo_affine(ones, int(seed), 0.0, 1.0, "gaussian").cpu().numpy()
        if not np.array_equal(zk.view(np.uint32),
                              gold[f"z_gauss_{i}"].view(np.uint32)):
            fail(f"K1 gaussian z (seed {seed}) != the JAX golden fixture")
        rk = kz.zo_affine(ones, int(seed), 0.0, 1.0, "rademacher").cpu()
        if not np.array_equal(np.packbits(rk.numpy() > 0),
                              gold[f"rad_bits_{i}"]):
            fail(f"K1 rademacher z (seed {seed}) != the JAX golden fixture")
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = torch.from_numpy(gold[f"aff_{name}_x"])
        if dt == torch.bfloat16:
            x = x.view(torch.bfloat16)
        y = kz.zo_affine(x.cuda(), int(gold[f"aff_{name}_seed"]),
                         float(gold[f"aff_{name}_a"]),
                         float(gold[f"aff_{name}_b"]), "gaussian")
        if not np.array_equal(bits_of(y).cpu().numpy(),
                              gold[f"aff_{name}_y"]):
            fail(f"K1 {name} affine != the JAX golden fixture")
    log("K1 zo_affine: bitwise vs plain (f32/bf16/f16 × gaussian/"
        "rademacher, odd sizes) and vs the JAX golden fixture")
    return 0.0


def check_k2(torch, kf) -> float:
    """K2 vs plain on the card at qwen2-0.5b head shapes."""
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for S in (1, 100, 256, 512, 2048):
        for window in (0, 64):
            mk = lambda kv: torch.randn(2, S, kv, 64, generator=g,  # noqa
                                        device="cuda").to(torch.bfloat16)
            q, k, v = mk(14), mk(2), mk(2)
            ok = kf.flash_attention(q, k, v, window=window).float()
            op = kf.flash_attention_plain(q, k, v, window=window).float()
            err = (ok - op).abs()
            if not torch.isfinite(ok).all() or bool(
                    (err > K2_BF16_REL * op.abs() + K2_BF16_ABS).any()):
                fail(f"K2 bf16 S={S} window={window}: max err "
                     f"{err.max().item()} beyond one bf16 ulp")
            worst = max(worst, err.max().item())
            of = kf.flash_attention(q.float(), k.float(), v.float(),
                                    window=window)
            opf = kf.flash_attention_plain(q.float(), k.float(), v.float(),
                                           window=window)
            e32 = (of - opf).abs().max().item()
            if e32 > K2_F32_ABS:
                fail(f"K2 f32 S={S} window={window}: max err {e32}")
    log(f"K2 flash_attention: bf16 within one ulp of plain (max abs err "
        f"{worst}), f32 within {K2_F32_ABS}, S up to 2048, H=14 KV=2 hd=64")
    return worst


def check_k3_k4_k5(torch, np, kz, km) -> None:
    """K3 chain, K4 fan-out and K5 batched fan-out vs their plain versions,
    bitwise: f32/bf16/f16 × gaussian/rademacher, odd sizes, B ∈ {1, 2, 8};
    one leaf at qwen2-0.5b's real shape (the stacked MLP weight) at B = 8;
    a chain longer than one launch takes; and the JAX-computed fixture."""
    g = torch.Generator(device="cuda").manual_seed(7)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for dist in ("gaussian", "rademacher"):
            for n in (1, 40_000, 262_147):
                x = torch.randn(n, generator=g, device="cuda").to(dt)
                for nb in (1, 2, 8):
                    s, a, b = SEEDS8[:nb], A8[:nb], B8[:nb]
                    _hold_k345(kz, km, x, s, a, b, dist,
                               f"{dt} {dist} n={n} B={nb}")
    x = torch.randn(MLP_LEAF, generator=g, device="cuda").to(torch.bfloat16)
    _hold_k345(kz, km, x, SEEDS8, A8, B8, "gaussian",
               f"the {MLP_LEAF} bf16 leaf at B=8")
    del x
    n_long = kz.MAX_STREAMS + 6
    x = torch.randn(70_001, generator=g, device="cuda").to(torch.bfloat16)
    seeds = list(range(n_long))
    if not same_bits(km.zo_affine_chain(x, seeds, [1.0] * n_long,
                                        [1e-3] * n_long),
                     km.zo_affine_chain_plain(x, seeds, [1.0] * n_long,
                                              [1e-3] * n_long)):
        fail(f"K3 with {n_long} streams (two launches) != plain")
    gold = np.load(MULTI_GOLDEN)
    seeds = [int(v) for v in gold["seeds"]]
    for name, dt, view in (("f32", torch.float32, np.int32),
                           ("bf16", torch.bfloat16, np.int16)):
        x = torch.from_numpy(gold[f"{name}_x"].view(view).copy()).view(dt)
        x = x.cuda()
        for what, got in (
                ("chain", km.zo_affine_chain(x, seeds, gold["a"], gold["b"])),
                ("multi", km.zo_affine_multi(x, seeds, gold["a"], gold["b"])),
                ("batched", kz.zo_affine_batched(x, seeds,
                                                 float(gold["a"][0]),
                                                 float(gold["b"][0])))):
            if not np.array_equal(bits_of(got).cpu().numpy().view(
                    gold[f"{name}_{what}"].dtype), gold[f"{name}_{what}"]):
                fail(f"K3-K5 {what} {name} != the JAX golden fixture")
    log("K3 zo_affine_chain, K4 zo_affine_multi, K5 zo_affine_batched: "
        "bitwise vs plain (f32/bf16/f16 × gaussian/rademacher, odd sizes, "
        f"B ∈ {{1, 2, 8}}, the {MLP_LEAF} leaf at B=8, {n_long} streams) "
        "and vs the JAX golden fixture")


def _hold_k345(kz, km, x, seeds, a, b, dist, what) -> None:
    pairs = (
        ("K3", km.zo_affine_chain(x, seeds, a, b, dist),
         lambda: km.zo_affine_chain_plain(x, seeds, a, b, dist)),
        ("K4", km.zo_affine_multi(x, seeds, a, b, dist),
         lambda: km.zo_affine_multi_plain(x, seeds, a, b, dist)),
        ("K5", kz.zo_affine_batched(x, seeds, a[0], b[0], dist),
         lambda: kz.zo_affine_batched_plain(x, seeds, a[0], b[0], dist)))
    for name, got, plain in pairs:
        if not same_bits(got, plain()):
            fail(f"{name} {what}: kernel != plain")
        del got


def check_k6(torch, np, km) -> None:
    """K6 vs its plain version bitwise (odd sizes, several tiles, the
    embedding leaf), and within SQNORM_RTOL of JAX's zo_sqnorm_ref."""
    gold = np.load(MULTI_GOLDEN)
    cases = [(int(n), int(s)) for n, s in zip(gold["sq_n"], gold["sq_seed"])]
    cases += [(151_936 * 896, 5), (24 * 896 * 4864, -77)]
    worst = 0.0
    for n, s in cases:
        for dist in ("gaussian", "rademacher"):
            k = km.zo_sqnorm(n, s, dist, "cuda")
            p = km.zo_sqnorm_plain(n, s, dist, "cuda")
            if not same_bits(k, p):
                fail(f"K6 n={n} seed={s} {dist}: kernel {k.item()} != plain "
                     f"{p.item()}")
    for n, s, want in zip(gold["sq_n"], gold["sq_seed"], gold["sq_jax"]):
        got = km.zo_sqnorm(int(n), int(s), "gaussian", "cuda").item()
        rel = abs(got - float(want)) / float(want)
        worst = max(worst, rel)
        if rel > km.SQNORM_RTOL:
            fail(f"K6 n={n}: {got} vs JAX {want}: rel err {rel} > "
                 f"{km.SQNORM_RTOL}")
    log(f"K6 zo_sqnorm: bitwise vs plain (n up to {cases[-2][0]}, gaussian/"
        f"rademacher), within {worst:.2e} relative of JAX's zo_sqnorm_ref "
        f"(tolerance {km.SQNORM_RTOL})")


def check_k12(torch, kp, L: int, n_blocks: int, D: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(L, n_blocks * BLOCK, D, generator=g,
                    device="cuda").to(torch.bfloat16)
    tab = torch.randint(0, n_blocks, (SLOTS * (MAX_LEN // BLOCK),),
                        generator=torch.Generator().manual_seed(4))
    a = kp.paged_gather(x, tab.numpy(), BLOCK)
    b = kp.paged_gather_plain(x, tab.cuda(), BLOCK)
    if not same_bits(a, b):
        fail("K12 paged_gather != plain")
    log("K12 paged_gather: bitwise vs plain")


# --------------------------------------------------------------------------- #
# The serving path (ledger replay + paged engine)
# --------------------------------------------------------------------------- #
def plain_replay(params, led, np):
    """The ledger replay with K1's plain version on the card — the same
    coefficients as ``CounterBackend.apply_rank1`` (f32 scalars)."""
    from repro_torch.kernels.zo_fused.kernel import zo_affine_plain
    from repro_torch.perturb.stream import (StreamRef, leaf_seed, prng_key,
                                            step_key)
    from repro_torch.tree_utils import is_floating, tree_leaves
    f32 = np.float32
    base = prng_key(led.base_seed)
    for step, g, lr in zip(led.steps, led.grads, led.lrs):
        seed = StreamRef(step_key(base, step)).counter_seed()
        a = float(f32(1.0) - f32(lr) * f32(0.0))
        b = float(-(f32(lr) * f32(g)))
        for i, p in enumerate(tree_leaves(params)):
            if is_floating(p):
                zo_affine_plain(p, leaf_seed(seed, i), a, b, out=p)


def workload(np, vocab: int):
    rng = np.random.default_rng(11)
    tpl = [int(t) for t in rng.integers(1, vocab - 1, TEMPLATE_LEN)]
    return [tpl + [int(t) for t in rng.integers(1, vocab - 1,
                                                int(rng.integers(8, 41)))]
            for _ in range(N_REQUESTS)]


def serve(cfg, params, prompts, prefix_cache: bool, new_tokens=NEW_TOKENS):
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN, block=BLOCK,
                      prefix_cache=prefix_cache, device="cuda")
    reqs = [Request(i, p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    wall = time.perf_counter() - t0
    return eng, reqs, wall


def device_busy(torch, fn, n: int = 1) -> tuple:
    """(wall ms, kernel ms, launches, top kernels) per call of ``fn`` under
    torch.profiler; kernel ms is 0 when the profiler saw no kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n
    launches = sum(e.count for e in kern) / n
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    tops = ", ".join(f"{e.key[:40]} {e.self_device_time_total / n / 1e3:.3f}"
                     " ms" for e in top)
    return wall_ms, dev_ms, launches, tops


def busy_line(what: str, wall_ms, dev_ms, launches, tops) -> str:
    if dev_ms == 0:
        return (f"{what}: {wall_ms:.2f} ms wall; device time not measured "
                "(the profiler saw no kernels)")
    return (f"{what}: {wall_ms:.2f} ms wall, {dev_ms:.2f} ms of kernels "
            f"({100 * dev_ms / wall_ms:.1f}% device busy), {launches:.0f} "
            f"kernel launches; top: {tops}")


def profile_decode(torch, cfg, params, prompts) -> str:
    """Device-busy share of steady decode steps (outside the counted run)."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN, block=BLOCK,
                      device="cuda")
    for i, p in enumerate(prompts[:SLOTS]):
        eng.submit(Request(i, p, max_new_tokens=NEW_TOKENS))
    eng.step()                        # admission (cold prefill) + decode
    eng.step()
    return busy_line(f"decode step ({SLOTS} slots, T={MAX_LEN})",
                     *device_busy(torch, eng.step, 3))


def serving_path(torch, np, cfg, params, twin, card, _build, counts):
    """PR 11's path: replay a 4-record ledger through K1, serve through the
    paged engine (K2 on cold prefill, K12 on prefix hits and decode)."""
    from repro_torch.core import TrajectoryLedger, replay
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import tree_leaves
    led = TrajectoryLedger(base_seed=7, grad_dtype="float32",
                           backend="pallas+z2")
    rng = np.random.default_rng(5)
    for step in range(N_RECORDS):
        led.append(step, float(rng.standard_normal()), 1e-5)
    led = TrajectoryLedger.from_bytes(led.to_bytes())
    prompts = workload(np, cfg.vocab_size)
    warm_eng, _, _ = serve(cfg, params, prompts[:1], True)   # cuBLAS warm-up
    del warm_eng

    _build.reset_launch_counts()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    replay(params, led, composition_for_ledger(led))
    e1.record()
    torch.cuda.synchronize()
    replay_ms = e0.elapsed_time(e1) / N_RECORDS
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, wall = serve(cfg, params, prompts, True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    add_counts(counts, _build, ("zo_affine", "flash_attention",
                                "paged_gather"), "serve")

    k1_plain_ms = host_ms(lambda: plain_replay(twin, led, np)) / N_RECORDS
    for a, b in zip(tree_leaves(params), tree_leaves(twin)):
        if not same_bits(a, b):
            fail("K1 ledger replay != the plain replay on the card")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)):
        fail("replayed params are not finite")
    log(f"ledger replay: {N_RECORDS} pallas+z2 records, {replay_ms:.3f} ms "
        f"per record through K1 on the serving path ({k1_plain_ms:.1f} ms "
        f"plain), bitwise equal")
    ids_on = [r.out_ids for r in reqs]
    if any(len(ids) != NEW_TOKENS for ids in ids_on):
        fail("a request did not produce its tokens")
    # bf16: the warm path (prefix KV from the pool, chunked attention) and
    # the cold path (K2 over the whole prompt) round differently, and random
    # weights give near-flat logits, so greedy ids may flip on near-ties —
    # reported, not asserted.  The identity contract is held in f32, as the
    # JAX package's own paged-engine tests hold it.
    _, reqs_off, _ = serve(cfg, params, prompts, False)
    same_bf16 = sum(a == b for r, o in zip(reqs, reqs_off)
                    for a, b in zip(r.out_ids, o.out_ids))
    cfg32 = cfg.replace(dtype="float32")
    params32 = _cast_tree(params, torch.float32)
    ids32 = {}
    for pc in (True, False):
        eng32, reqs32, _ = serve(cfg32, params32, prompts, pc)
        ids32[pc] = [r.out_ids for r in reqs32]
        if pc and eng32.prefix_stats()["prefix_hits"] == 0:
            fail("the f32 run never hit the prefix cache")
    if ids32[True] != ids32[False]:
        fail("f32 token ids differ with the prefix cache on and off")
    del params32, eng32
    log(f"prefix cache on vs off: f32 ids identical ({tokens_of(ids32[True])}"
        f" tokens); bf16 ids agree on {same_bf16}/{tokens_of(ids_on)}")
    ps = eng.prefix_stats()
    tokens = tokens_of(ids_on)
    ttft = sorted(r.times["prefill"] - r.times["queued"] for r in reqs)
    log(f"served {len(reqs)} requests / {tokens} tokens in {wall:.3f} s: "
        f"{tokens / wall:.1f} tok/s, TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f}"
        f" ms, peak memory {peak / 2**30:.2f} GiB, prefill "
        f"{ps['prefill_tokens_computed']}/{ps['prefill_tokens_submitted']} "
        f"tokens computed, prefix hit rate {ps['prefix_hit_rate']:.2f} — "
        f"on {card}")
    log(profile_decode(torch, cfg, params, prompts))
    return eng, prompts


# --------------------------------------------------------------------------- #
# The training paths
# --------------------------------------------------------------------------- #
def add_counts(counts: dict, _build, required, path: str) -> None:
    """Read the counts of the path just driven, require its kernels."""
    got = dict(_build.launch_counts)
    for name in required:
        if got[name] == 0:
            fail(f"the {path} path never launched {name}")
    for name, n in got.items():
        counts[name] = counts.get(name, 0) + n
    log(f"{path} path launches: "
        + ", ".join(f"{k} {v}" for k, v in got.items() if v))


def make_opts():
    from repro_torch import exec as zexec
    from repro_torch import zo
    return {
        "a_spsa": (lambda: zo.mezo(lr=LR, eps=EPS, backend="pallas"), None),
        "b_fzoo": (lambda: zo.fzoo(lr=LR, eps=EPS, batch_seeds=B_SEEDS,
                                   backend="pallas"), None),
        "c_sphere": (lambda: zo.fzoo(lr=LR, eps=EPS, batch_seeds=B_SEEDS,
                                     dist="sphere", backend="pallas"), None),
        "d_sp2": (lambda: zo.mezo(lr=LR, eps=EPS, backend="pallas"),
                  lambda: zexec.seed_parallel(2)),
    }


REQUIRED = {"a_spsa": ("zo_affine", "flash_attention"),
            "b_fzoo": ("zo_affine_batched", "zo_affine_chain",
                       "flash_attention"),
            "c_sphere": ("zo_sqnorm", "zo_affine_multi", "zo_affine_chain",
                         "flash_attention"),
            "d_sp2": ("zo_affine_chain", "zo_affine", "flash_attention")}


class StepClock:
    """HeartbeatMonitor that keeps the host-clock gap between beats (one
    step each: the step's losses sync the card)."""

    def __init__(self):
        from repro_torch.train.loop import HeartbeatMonitor
        self.mon = HeartbeatMonitor()
        self.dts = []
        self.mon.on_beat = lambda step, dt: self.dts.append(dt)


def train_phase(torch, cfg, params0, name, make_opt, make_plan, _build,
                counts):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import TrajectoryLedger
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.exec import StepProgram
    from repro_torch.models import bundle
    from repro_torch.train.loop import train
    params = _clone_tree(params0)
    opt = make_opt()
    prog = StepProgram(opt, make_plan()) if make_plan else opt
    ledger = TrajectoryLedger(base_seed=SEED, grad_dtype="float32",
                              backend=opt.backend_name,
                              batch_seeds=opt.batch_seeds)
    run = RUN_DIR / name
    shutil.rmtree(run, ignore_errors=True)
    ckpt = CheckpointManager(str(run), interval=10**9)
    pipe = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             vocab=cfg.vocab_size, seed=SEED), device="cuda")
    clock = StepClock()
    _build.reset_launch_counts()
    res = train(bundle(cfg).loss_fn(), params, prog, pipe,
                total_steps=STEPS[name], ckpt=ckpt, ledger=ledger,
                monitor=clock.mon, log_every=1, seed=SEED)
    torch.cuda.synchronize()
    add_counts(counts, _build, REQUIRED[name], f"train {name}")
    saved = ckpt.load_ledger()
    if saved is None or saved.to_bytes() != ledger.to_bytes():
        fail(f"{name}: the ledger on disk != the run's ledger")
    if not ckpt.steps() == [STEPS[name]]:
        fail(f"{name}: no final checkpoint at step {STEPS[name]}")
    shutil.rmtree(run)
    losses = [loss for _, loss in res.losses]
    if len(losses) != STEPS[name] or not all(
            map(lambda v: v == v and abs(v) < 1e30, losses)):
        fail(f"{name}: losses not finite: {losses}")
    step_ms = 1e3 * sum(clock.dts[1:]) / max(1, len(clock.dts) - 1)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    log(f"train {name}: {STEPS[name]} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, {step_ms:.1f} ms per step (steps 2..), "
        f"{tok_s:.0f} batch tokens/s, ledger {ledger.to_bytes()[:5].decode()} "
        f"{ledger.nbytes()} bytes")
    return res.params, ledger, opt, step_ms


def ulp_diff(torch, a, b) -> tuple:
    """(max difference in bf16 ulps at the magnitude the chain rounds at,
    max(|a|, |b|) + ε·Z_MAX; share of differing elements; max abs
    difference) of two bf16 leaves."""
    af, bf = a.float(), b.float()
    m = torch.maximum(af.abs(), bf.abs()) + EPS * Z_MAX
    _, e = torch.frexp(m)
    ulp = torch.ldexp(torch.ones_like(m), e - 8)
    d = (af - bf).abs()
    ulps = torch.where(d > 0, d / ulp, torch.zeros_like(d))
    return (ulps.max().item(), (d > 0).float().mean().item(),
            d.max().item())


def check_replays(torch, name, params0, trained, ledger, opt_factory):
    from repro_torch.core import replay
    from repro_torch.tree_utils import tree_leaves
    r1 = replay(_clone_tree(params0), ledger, opt_factory())
    r2 = replay(_clone_tree(params0), ledger, opt_factory())
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(r1), tree_leaves(r2)):
        if not same_bits(a, b):
            fail(f"{name}: two replays of the ledger differ")
    pairs = list(zip(tree_leaves(r1), tree_leaves(trained)))
    if name in ULPS_PER_STEP:
        bound = ULPS_PER_STEP[name] * STEPS[name]
        worst_ulps, worst_abs, n_diff, n_all = 0.0, 0.0, 0.0, 0
        for a, b in pairs:
            u, share, mx = ulp_diff(torch, a, b)
            worst_ulps, worst_abs = max(worst_ulps, u), max(worst_abs, mx)
            n_diff += share * a.numel()
            n_all += a.numel()
        if worst_ulps > bound:
            fail(f"{name}: replay vs trained θ differ by {worst_ulps} bf16 "
                 f"ulps (at |θ| + ε·{Z_MAX}) > the bound {bound}")
        log(f"{name}: replay ≡ replay bitwise; replay vs trained θ: max "
            f"{worst_ulps:.2f} bf16 ulps at |θ| + ε·{Z_MAX} (bound "
            f"{bound:.0f}), max abs "
            f"{worst_abs:.3e}, {100 * n_diff / n_all:.3f}% of elements "
            "differ (the live chain rounds θ±εz in bf16)")
    else:
        for a, b in pairs:
            if not same_bits(a, b):
                fail(f"{name}: replay != the trained θ (fzoo's update and "
                     "its replay make the same affine_many call)")
        log(f"{name}: replay ≡ replay ≡ trained θ, bitwise")
    del r1, r2


def memory_and_busy(torch, cfg, params0):
    """Peak device memory of one spsa step vs one forward on the same batch
    (no_grad), on a scratch copy of θ₀; and the device-busy share of a
    step under torch.profiler."""
    from repro_torch import zo
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import bundle
    base = torch.cuda.memory_allocated()
    params = _clone_tree(params0)
    batch = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                              vocab=cfg.vocab_size, seed=SEED),
                     device="cuda").batch(0)
    loss_fn = bundle(cfg).loss_fn()
    opt = zo.mezo(lr=LR, eps=EPS, backend="pallas")
    state = opt.init(params, seed=SEED)
    step = opt.step_fn(loss_fn)
    with torch.no_grad():
        loss_fn(params, batch).item()                    # warm-up
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        loss_fn(params, batch).item()
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    stp = torch.cuda.max_memory_allocated() - base
    if stp > MEM_SLACK * fwd:
        fail(f"spsa step peak {stp / 2**30:.3f} GiB > {MEM_SLACK} × one "
             f"forward's {fwd / 2**30:.3f} GiB")
    log(f"memory: one spsa step peaks at {stp / 2**30:.3f} GiB, one forward "
        f"(no_grad) at {fwd / 2**30:.3f} GiB — ratio {stp / fwd:.4f} "
        "(the parameters under training and the activations, over what was "
        "allocated before)")
    holder = {"p": params, "s": state}

    def one():
        holder["p"], holder["s"], _ = step(holder["p"], holder["s"], batch)

    line = busy_line("one spsa step (16 × 256 tokens, 24 layers)",
                     *device_busy(torch, one, 2))
    log(line)
    del holder, params
    return stp, fwd


def serve_finetune(torch, np, cfg, params0, trained_b, ledger_b, prompts,
                   _build, counts):
    """Serve the fzoo fine-tune: rebuild the composition from the ledger
    header, replay it (K3) onto θ₀, serve through the paged engine."""
    from repro_torch.core import replay
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import tree_leaves
    params = _clone_tree(params0)
    _build.reset_launch_counts()
    replay(params, ledger_b, composition_for_ledger(ledger_b))
    _, reqs, wall = serve(cfg, params, prompts[:4], True, new_tokens=8)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_chain", "flash_attention",
                                "paged_gather"), "serve the fine-tune")
    for a, b in zip(tree_leaves(params), tree_leaves(trained_b)):
        if not same_bits(a, b):
            fail("the served fine-tune != the trained fzoo θ")
    if any(len(r.out_ids) != 8 for r in reqs):
        fail("a fine-tune request did not produce its tokens")
    log(f"served the fzoo fine-tune ({len(ledger_b)} MZOL3 records replayed "
        f"through composition_for_ledger): {len(reqs)} requests, "
        f"{sum(len(r.out_ids) for r in reqs)} tokens in {wall:.3f} s")


# --------------------------------------------------------------------------- #
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels against their plain "
                         "versions and the JAX fixtures, then stop")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on the card")
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.exists() \
            or not MULTI_GOLDEN.exists():
        fail(f"run from the root of a checkout ({SRC / 'repro_torch'}, "
             f"{GOLDEN} or {MULTI_GOLDEN} missing)")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card, flush=True)
    t_start = time.perf_counter()

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as kf
    from repro_torch.kernels.paged import gather as kp
    from repro_torch.kernels.zo_fused import kernel as kz
    from repro_torch.kernels.zo_fused import multi as km
    build_s = _build.build_all()
    log(f"built {len(_build.SOURCES)} CUDA sources "
        f"({len(_build.launch_counts)} kernels) in {build_s:.1f} s")

    k1_err = check_k1(torch, np, kz)
    k2_err = check_k2(torch, kf)
    check_k3_k4_k5(torch, np, kz, km)
    check_k6(torch, np, km)
    if args.kernels_only:
        log(f"kernels only: all checks passed in "
            f"{time.perf_counter() - t_start:.1f} s on {card}")
        return

    # ---- full width ---------------------------------------------------- #
    from repro_torch.models import all_archs, bundle
    from repro_torch.tree_utils import is_floating, tree_leaves
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(attention_impl="pallas_flash")
    t0 = time.perf_counter()
    params0 = bundle(cfg).init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params0))
    log(f"qwen2-0.5b: {n_params} params bf16, {cfg.n_layers} layers, "
        f"init {time.perf_counter() - t0:.1f} s")
    check_k12(torch, kp, cfg.n_layers, 1 + 2 * SLOTS * (MAX_LEN // BLOCK),
              cfg.kv_heads * cfg.hd)
    counts: dict = {}

    # ---- path 1: serve (PR 11) ----------------------------------------- #
    params = _clone_tree(params0)
    twin = _clone_tree(params0)
    eng, prompts = serving_path(torch, np, cfg, params, twin, card, _build,
                                counts)
    with torch.no_grad():
        probe = bundle(cfg).prefill_fn()(
            params, {"tokens": torch.tensor([prompts[0][:64]], device="cuda")})
    if probe[0].shape != (1, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(probe[0]).all()):
        fail("prefill logits not finite or of the wrong shape")
    pool_k = eng.pool.k
    nblk_slot = eng._nblk_slot
    del params, twin, eng

    # ---- memory and device-busy share of the spsa step ----------------- #
    memory_and_busy(torch, cfg, params0)

    # ---- paths 2-5: train (a)-(d) -------------------------------------- #
    opts = make_opts()
    trained, ledgers, step_ms = {}, {}, {}
    for name in STEPS:
        make_opt, make_plan = opts[name]
        p, led, _, ms = train_phase(torch, cfg, params0, name, make_opt,
                                    make_plan, _build, counts)
        check_replays(torch, name, params0, p, led, make_opt)
        step_ms[name] = ms
        if name == "b_fzoo":
            trained[name], ledgers[name] = p, led
        del p

    # ---- path 6: serve the fine-tune ----------------------------------- #
    serve_finetune(torch, np, cfg, params0, trained["b_fzoo"],
                   ledgers["b_fzoo"], prompts, _build, counts)
    del trained

    # ---- kernel times at the main paths' shapes ------------------------ #
    leaves = [p for p in tree_leaves(params0) if is_floating(p)]
    n_all = sum(p.numel() for p in leaves)
    leaf_bytes = sum(p.numel() * p.element_size() for p in leaves)
    flops = kz.GAUSSIAN_FLOPS_PER_ELEMENT
    seeds = [[1000003 * i + 17 + j for j in range(B_SEEDS)]
             for i in range(len(leaves))]
    ones, tiny = [1.0] * B_SEEDS, [1e-12] * B_SEEDS

    def k1_record():
        for i, p in enumerate(leaves):
            kz.zo_affine(p, seeds[i][0], 1.0, 1e-12, out=p)

    def k3_update(chain=km.zo_affine_chain):
        for i, p in enumerate(leaves):
            chain(p, seeds[i], ones, tiny, out=p)

    def k4_fanout(multi=km.zo_affine_multi):
        for i, p in enumerate(leaves):
            multi(p, seeds[i], ones, tiny)

    def k5_fanout(batched=kz.zo_affine_batched):
        for i, p in enumerate(leaves):
            batched(p, seeds[i], 1.0, 1e-12)

    def k6_pass(sq=km.zo_sqnorm):
        for i, p in enumerate(leaves):
            sq(p.numel(), seeds[i][0], "gaussian", "cuda")

    def k1_plain_record():
        for i, p in enumerate(leaves):
            kz.zo_affine_plain(p, seeds[i][0], 1.0, 1e-12, out=p)

    times = {
        "zo_affine": (cuda_ms(k1_record, 10), host_ms(k1_plain_record)),
        "zo_affine_chain": (cuda_ms(k3_update, 5), host_ms(
            lambda: k3_update(km.zo_affine_chain_plain))),
        "zo_affine_multi": (cuda_ms(k4_fanout, 5), host_ms(
            lambda: k4_fanout(km.zo_affine_multi_plain))),
        "zo_affine_batched": (cuda_ms(k5_fanout, 5), host_ms(
            lambda: k5_fanout(kz.zo_affine_batched_plain))),
        "zo_sqnorm": (cuda_ms(k6_pass, 10), host_ms(
            lambda: k6_pass(km.zo_sqnorm_plain))),
    }

    g = torch.Generator(device="cuda").manual_seed(6)
    S = TRAIN_SEQ
    q = torch.randn(TRAIN_BATCH, S, cfg.n_heads, cfg.hd, generator=g,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn(TRAIN_BATCH, S, cfg.kv_heads, cfg.hd, generator=g,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn_like(k)
    k2_ms = cuda_ms(lambda: kf.flash_attention(q, k, v), 20)
    k2_plain_ms = cuda_ms(lambda: kf.flash_attention_plain(q, k, v), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k2_lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                     enable_gqa=True), 20)
    k2_bytes = 2 * (q.numel() * 2 + k.numel() * 2)
    k2_ops = 4 * cfg.hd * kf.attended_pairs(S) * TRAIN_BATCH * cfg.n_heads
    log(f"K2 flash_attention at the training shape ({TRAIN_BATCH}, {S}, "
        f"{cfg.n_heads}, {cfg.hd}) bf16: {k2_ms:.3f} ms, one SDPA call "
        f"{k2_lib_ms:.3f} ms, plain {k2_plain_ms:.3f} ms — on {card}")

    L, NT = cfg.n_layers, pool_k.shape[1]
    D = cfg.kv_heads * cfg.hd
    pool = pool_k.view(L, NT, D)
    tab = np.arange(SLOTS * nblk_slot, dtype=np.int32) % (NT // BLOCK)
    tab_dev = torch.as_tensor(tab).cuda()
    k12_ms = cuda_ms(lambda: kp.paged_gather(pool, tab, BLOCK), 20)
    k12_plain_ms = cuda_ms(lambda: kp.paged_gather_plain(pool, tab_dev,
                                                         BLOCK), 20)
    k12_lib_ms = cuda_ms(lambda: pool.view(L, NT // BLOCK, BLOCK * D)
                         .index_select(1, tab_dev.long()), 20)
    k12_bytes = 2 * L * tab.size * BLOCK * D * 2

    def bound(nbytes, ops, rate):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        return (max(by_bytes, by_ops) * 1e3,
                "bytes" if by_bytes >= by_ops else "operations")

    zf = "src/repro_torch/kernels/zo_fused/csrc/"
    zr = "src/repro/kernels/zo_fused/"
    rows = []
    # K6: z (the gaussian stream without the affine combine's 3 flops) plus
    # the square and the add
    k6_ops = (flops - 3 + 2) * n_all
    for name, src, rep, err, lib_ms, nb, ops, rate in (
            ("zo_affine", zf + "zo_affine.cu", zr + "kernel.py:233", k1_err,
             None, 2 * leaf_bytes, flops * n_all, F32_FLOPS),
            ("zo_affine_chain", zf + "zo_multi.cu", zr + "multi.py:137", 0.0,
             None, 2 * leaf_bytes, flops * B_SEEDS * n_all, F32_FLOPS),
            ("zo_affine_multi", zf + "zo_multi.cu", zr + "multi.py:80", 0.0,
             None, (1 + B_SEEDS) * leaf_bytes, flops * B_SEEDS * n_all,
             F32_FLOPS),
            ("zo_affine_batched", zf + "zo_multi.cu", zr + "kernel.py:283",
             0.0, None, (1 + B_SEEDS) * leaf_bytes, flops * B_SEEDS * n_all,
             F32_FLOPS),
            ("zo_sqnorm", zf + "zo_sqnorm.cu", zr + "multi.py:200", 0.0,
             None, 0, k6_ops, F32_FLOPS)):
        ms, pms = times[name]
        bms, by = bound(nb, ops, rate)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts.get(name, 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    for name, src, rep, err, ms, pms, lms, nb, ops, rate in (
            ("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:89", k2_err, k2_ms,
             k2_plain_ms, k2_lib_ms, k2_bytes, k2_ops, BF16_TENSOR_FLOPS),
            ("paged_gather", "src/repro_torch/kernels/paged/csrc/paged_gather.cu",
             "src/repro/kernels/paged/gather.py:54", 0.0, k12_ms,
             k12_plain_ms, k12_lib_ms, k12_bytes, 0, BF16_TENSOR_FLOPS)):
        bms, by = bound(nb, ops, rate)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts.get(name, 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": lms})
    log(f"shapes: zo_affine = one record over all {len(leaves)} leaves; "
        f"zo_affine_chain = one {B_SEEDS}-stream update over all leaves; "
        f"zo_affine_multi / zo_affine_batched = one {B_SEEDS}-stream fan-out "
        f"over all leaves; zo_sqnorm = one stream's ||z||^2 over all leaves "
        f"({n_all} elements); flash_attention = the training shape "
        f"({TRAIN_BATCH}, {S}, {cfg.n_heads}, {cfg.hd}) bf16; paged_gather "
        f"= one decode-step gather of {tab.size} blocks × {L} layers; "
        f"launches summed over the six counted paths")
    log("training step ms: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in step_ms.items())
        + f" — on {card}; smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def tokens_of(ids) -> int:
    return sum(len(x) for x in ids)


if __name__ == "__main__":
    main()
