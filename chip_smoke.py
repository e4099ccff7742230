#!/usr/bin/env python3
"""Chip smoke of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout; one card

In order: prints the card's name and power limit; builds the three CUDA
kernels of the serving path from ``src/repro_torch/kernels/*/csrc`` (one
nvcc per source, in parallel); holds each kernel against its plain torch
version on the card — K1 ``zo_affine`` and K12 ``paged_gather`` bitwise,
K1 also against a golden fixture that JAX computed (``tests/data``), K2
``flash_attention`` within a stated tolerance; then drives the main path at
the full width of qwen2-0.5b (random bf16 weights from a seeded
``torch.Generator``, all 24 layers): replays an in-process MeZO ledger of
``pallas+z2`` records through K1, and serves a shared-template workload
through the paged engine with the radix prefix cache and ``pallas_flash``
attention (K2 on cold prefill, K12 on prefix hits and every decode step).
The launch counts of that run must be non-zero for every kernel; the outputs
must be finite, the kernel replay bitwise-equal to the plain replay, and the
token ids equal with the prefix cache on and off.

Prints a ``kernels`` JSON line (launches, error, kernel / plain / library
times in ms and the roofline bound), and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero; there is
no fallback to the CPU or to a plain version on the main path.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "data" / "zo_golden.npz"

# H100 SXM peaks (NVIDIA data sheet, dense): the roofline bound's rates
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# the main path's shapes
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


def bits_of(t):
    import torch
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


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
                if not torch.equal(bits_of(yk), bits_of(yp)):
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
    for S in (1, 100, 512, 2048):
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


def check_k12(torch, kp, L: int, n_blocks: int, D: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(L, n_blocks * BLOCK, D, generator=g,
                    device="cuda").to(torch.bfloat16)
    tab = torch.randint(0, n_blocks, (SLOTS * (MAX_LEN // BLOCK),),
                        generator=torch.Generator().manual_seed(4))
    a = kp.paged_gather(x, tab.numpy(), BLOCK)
    b = kp.paged_gather_plain(x, tab.cuda(), BLOCK)
    if not torch.equal(bits_of(a), bits_of(b)):
        fail("K12 paged_gather != plain")
    log("K12 paged_gather: bitwise vs plain")


# --------------------------------------------------------------------------- #
def plain_replay(params, led, np):
    """The ledger replay with K1's plain version on the card — the same
    coefficients as ``CounterBackend.apply_rank1`` (f32 scalars)."""
    from repro_torch.kernels.zo_fused.kernel import zo_affine_plain
    from repro_torch.perturb.stream import StreamRef, leaf_seed, prng_key, step_key
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


def serve(cfg, params, prompts, prefix_cache: bool):
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN, block=BLOCK,
                      prefix_cache=prefix_cache, device="cuda")
    reqs = [Request(i, p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    wall = time.perf_counter() - t0
    return eng, reqs, wall


def profile_decode(torch, cfg, params, prompts) -> str:
    """Device-busy share of steady decode steps: torch.profiler over three
    ``step()`` calls of a full engine (outside the counted run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN, block=BLOCK,
                      device="cuda")
    for i, p in enumerate(prompts[:SLOTS]):
        eng.submit(Request(i, p, max_new_tokens=NEW_TOKENS))
    eng.step()                        # admission (cold prefill) + decode
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / 3
    launches = sum(e.count for e in kern) / 3
    if dev_ms == 0:
        return (f"decode step {wall_ms:.2f} ms wall; device time not "
                "measured (the profiler saw no kernels)")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    tops = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 3e3:.3f} ms"
                     for e in top)
    return (f"decode step ({SLOTS} slots, T={MAX_LEN}): {wall_ms:.2f} ms wall,"
            f" {dev_ms:.2f} ms of kernels ({100 * dev_ms / wall_ms:.1f}% "
            f"device busy), {launches:.0f} kernel launches; top: {tops}")


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on the card")
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.exists():
        fail(f"run from the root of a checkout ({SRC / 'repro_torch'} or "
             f"{GOLDEN} missing)")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card, flush=True)

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as kf
    from repro_torch.kernels.paged import gather as kp
    from repro_torch.kernels.zo_fused import kernel as kz
    build_s = _build.build_all()
    log(f"built {len(_build.SOURCES)} kernels in {build_s:.1f} s")

    k1_err = check_k1(torch, np, kz)
    k2_err = check_k2(torch, kf)

    # ---- main path at full width --------------------------------------- #
    from repro_torch.core import TrajectoryLedger, replay
    from repro_torch.models import all_archs, bundle
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import is_floating, tree_leaves
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(attention_impl="pallas_flash")
    t0 = time.perf_counter()
    params = bundle(cfg).init(0, device="cuda")
    twin = _clone_tree(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"qwen2-0.5b: {n_params} params bf16, {cfg.n_layers} layers, "
        f"init {time.perf_counter() - t0:.1f} s")
    check_k12(torch, kp, cfg.n_layers, 1 + 2 * SLOTS * (MAX_LEN // BLOCK),
              cfg.kv_heads * cfg.hd)

    led = TrajectoryLedger(base_seed=7, grad_dtype="float32",
                           backend="pallas+z2")
    rng = np.random.default_rng(5)
    for step in range(N_RECORDS):
        led.append(step, float(rng.standard_normal()), 1e-5)
    led = TrajectoryLedger.from_bytes(led.to_bytes())
    prompts = workload(np, cfg.vocab_size)
    warm_eng, _, _ = serve(cfg, params, prompts[:1], True)   # cuBLAS warm-up
    del warm_eng

    # the counted run: ledger replay, then serving, nothing else
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
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched {name}")
    log(f"main path launches: {launches}")

    # ---- is what came out right? --------------------------------------- #
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_replay(twin, led, np)
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t0) * 1e3 / N_RECORDS
    for a, b in zip(tree_leaves(params), tree_leaves(twin)):
        if not torch.equal(bits_of(a), bits_of(b)):
            fail("K1 ledger replay != the plain replay on the card")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)):
        fail("replayed params are not finite")
    del twin
    log(f"ledger replay: {N_RECORDS} pallas+z2 records, {replay_ms:.3f} ms "
        f"per record through K1 on the main path ({k1_plain_ms:.1f} ms "
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
    with torch.no_grad():
        probe = bundle(cfg).prefill_fn()(
            params, {"tokens": torch.tensor([prompts[0][:64]], device="cuda")})
    if probe[0].shape != (1, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(probe[0]).all()):
        fail("prefill logits not finite or of the wrong shape")
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

    # ---- kernel times at the main path's shapes ------------------------ #
    leaves = [p for p in tree_leaves(params) if is_floating(p)]

    def one_record():
        for i, p in enumerate(leaves):
            kz.zo_affine(p, 1000003 * i + 17, 1.0, 1e-12, out=p)
    k1_ms = cuda_ms(one_record, 10)
    k1_bytes = sum(2 * p.numel() * p.element_size() for p in leaves)
    k1_ops = sum(kz.GAUSSIAN_FLOPS_PER_ELEMENT * p.numel() for p in leaves)

    cold = sorted({len(p) for p in prompts[:SLOTS]})
    from repro_torch.serve.paged import bucket_for, prefill_buckets
    S = bucket_for(cold[-1], prefill_buckets(MAX_LEN - 1))
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(SLOTS, S, cfg.n_heads, cfg.hd, generator=g,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn(SLOTS, S, cfg.kv_heads, cfg.hd, generator=g,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn_like(k)
    k2_ms = cuda_ms(lambda: kf.flash_attention(q, k, v), 20)
    k2_plain_ms = cuda_ms(lambda: kf.flash_attention_plain(q, k, v), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k2_lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                     enable_gqa=True), 20)
    k2_bytes = 2 * (q.numel() * 2 + k.numel() * 2)
    k2_ops = 4 * cfg.hd * kf.attended_pairs(S) * SLOTS * cfg.n_heads

    L, NT = cfg.n_layers, eng.pool.k.shape[1]
    D = cfg.kv_heads * cfg.hd
    pool = eng.pool.k.view(L, NT, D)
    tab = np.arange(SLOTS * eng._nblk_slot, dtype=np.int32) % (NT // BLOCK)
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

    rows = []
    for name, src, rep, err, ms, pms, lms, nb, ops, rate in (
            ("zo_affine", "src/repro_torch/kernels/zo_fused/csrc/zo_affine.cu",
             "src/repro/kernels/zo_fused/kernel.py:233", k1_err, k1_ms,
             k1_plain_ms, None, k1_bytes, k1_ops, F32_FLOPS),
            ("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:89", k2_err, k2_ms,
             k2_plain_ms, k2_lib_ms, k2_bytes, k2_ops, BF16_TENSOR_FLOPS),
            ("paged_gather", "src/repro_torch/kernels/paged/csrc/paged_gather.cu",
             "src/repro/kernels/paged/gather.py:54", 0.0, k12_ms,
             k12_plain_ms, k12_lib_ms, k12_bytes, 0, BF16_TENSOR_FLOPS)):
        bms, by = bound(nb, ops, rate)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": lms})
    log(f"shapes: zo_affine = one record over all {len(leaves)} "
        f"leaves; flash_attention = cold prefill group ({SLOTS}, {S}, "
        f"{cfg.n_heads}, {cfg.hd}) bf16; paged_gather = one decode-step "
        f"gather of {tab.size} blocks × {L} layers")
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
