"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> --smoke``.

The port of ``repro.launch.serve``, with its flags plus ``--device``:
builds the model from a seeded ``torch.Generator``, optionally replays a
MeZO scalar ledger onto the init params (a JAX- or port-written MZOL file of
the ``xla`` stream — MZOL1 implies it — or of ``pallas+z2``), then serves
a synthetic request workload through
the engine: paged for dense archs and moe ones without a sliding window
(``--arch granite-moe-3b-a800m``), the dense slab for the rest — per-slot
ring caches for a sliding window (``--arch mixtral-8x7b``), with the SSM
state beside them for hybrid (``--arch hymba-1.5b``), the recurrent state
alone for ssm (``--arch rwkv6-3b``).  An encdec arch is not served (JAX's
engine takes none).

Multi-tenant mode (``--tenants N``): trains N synthetic peft(lora)
fine-tunes over the frozen base (the ``xla`` stream, X1 on the card),
registers their ledgers in an ``AdapterStore``, optionally folds each to a
delta + ``--compact-every``-record tail, and serves a skewed request mix
(``--templates K``: K shared templates per tenant) across all of them
through one engine — materialized deltas ride a byte-budgeted LRU
(``--cache-mb``); see ``repro_torch.serve.tenants``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from repro_torch.core import TrajectoryLedger, replay
from repro_torch.device import resolve_device
from repro_torch.models import all_archs, bundle
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.tenants import (composition_for_ledger, lora_runtime,
                                       make_lora_tenants, serve_load,
                                       synthetic_requests, template_requests)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--ledger", default=None,
                    help="MeZO ledger file: replay onto the init params")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve N synthetic LoRA tenants over the frozen "
                         "base through one engine (0 = single-model mode)")
    ap.add_argument("--cache-mb", type=float, default=64.0,
                    help="delta-cache byte budget in MB (tenant mode)")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="fold each tenant ledger to delta + an N-record "
                         "replayable tail before serving (0 = no compaction)")
    ap.add_argument("--tenant-steps", type=int, default=10,
                    help="fine-tune steps per synthetic tenant")
    ap.add_argument("--block", type=int, default=16,
                    help="paged KV block size in tokens")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="KV pool size in blocks (default: 2x slot demand)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the radix prefix cache (paged pool stays)")
    ap.add_argument("--templates", type=int, default=0,
                    help="tenant mode: draw prompts from N shared task "
                         "templates per tenant (Zipf) instead of fully "
                         "random prompts — exercises the prefix cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain torch versions of the kernels)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    archs = all_archs()
    if args.arch not in archs:
        sys.exit(f"--arch {args.arch!r} is not a ported config; the port "
                 f"has {', '.join(sorted(archs))}")
    arch = archs[args.arch]
    cfg = arch.smoke_cfg if args.smoke else arch.cfg
    params = bundle(cfg).init(args.seed, device=device)
    if args.ledger and os.path.exists(args.ledger):
        with open(args.ledger, "rb") as f:
            led = TrajectoryLedger.from_bytes(f.read())
        params = replay(params, led, composition_for_ledger(led))
        print(f"[serve] replayed {len(led)} ledger steps "
              f"({os.path.getsize(args.ledger)} bytes, "
              f"backend={led.backend})")

    engine = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                         seed=args.seed, block=args.block,
                         pool_blocks=args.pool_blocks,
                         prefix_cache=not args.no_prefix_cache, device=device)
    if engine.paged:
        print(f"[serve] paged KV: block={args.block} tokens, "
              f"pool={engine.pool.n_blocks} blocks, prefix cache "
              f"{'off' if args.no_prefix_cache else 'on'}, device={device}")
    elif cfg.family == "ssm":
        print(f"[serve] recurrent state: {args.slots} slots, exact-length "
              f"prefill, scan mode {cfg.scan_mode}, device={device}")
    else:
        cap = engine.cache["k"].shape[2]
        rows = (f"a ring of the window {cap}" if cap == cfg.sliding_window
                else "per slot")
        state = (f", SSM state, exact-length prefill, scan mode "
                 f"{cfg.scan_mode}" if cfg.family == "hybrid" else "")
        print(f"[serve] dense slab: {args.slots} slots × {cap} KV rows "
              f"({rows}){state}, device={device}")

    if args.tenants > 0:
        serve_tenants(args, cfg, params, engine)
        return

    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(2, 9))
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size - 1, plen)]
        r = Request(i, prompt, max_new_tokens=args.new_tokens)
        reqs.append(r)
        engine.submit(r)

    t0 = time.time()
    steps = 0
    while any(not r.done for r in reqs):
        engine.step()
        steps += 1
    dt = time.time() - t0
    tokens = sum(len(r.out_ids) for r in reqs)
    print(f"[serve] {len(reqs)} requests / {tokens} tokens in {steps} decode "
          f"steps, {dt:.2f}s ({tokens / dt:.1f} tok/s on {device})")
    if engine.paged:
        ps = engine.prefix_stats()
        print(f"[serve] prefill: {ps['prefill_tokens_computed']}/"
              f"{ps['prefill_tokens_submitted']} tokens computed, prefix "
              f"hit rate {ps['prefix_hit_rate']:.2f}")
    for r in reqs[:4]:
        print(f"  req {r.rid}: {r.prompt_ids} -> {r.out_ids}")


def serve_tenants(args, cfg, params, engine) -> None:
    """``--tenants N``: JAX's multi-tenant flow and its report lines."""
    t0 = time.time()
    store = make_lora_tenants(cfg, params, args.tenants,
                              steps=args.tenant_steps, seed0=args.seed + 100)
    print(f"[serve] trained {len(store)} LoRA tenants in "
          f"{time.time() - t0:.1f}s; ledgers total {store.nbytes()} bytes")
    runtime = lora_runtime(cfg, params, store,
                           cache_bytes=int(args.cache_mb * 1e6))
    if args.compact_every > 0:
        for t in store.tenants():
            comp = runtime.compact_tenant(t, keep_tail=args.compact_every)
        print(f"[serve] compacted every ledger to delta + "
              f"{args.compact_every}-record tail (last: {comp.nbytes} bytes)")
    if args.templates > 0:
        tagged = template_requests(
            args.requests, cfg.vocab_size, store.tenants(),
            n_templates=args.templates,
            template_len=min(48, args.max_len // 2), seed=args.seed,
            max_new_tokens=args.new_tokens)
    else:
        tagged = synthetic_requests(args.requests, cfg.vocab_size,
                                    store.tenants(), seed=args.seed,
                                    max_new_tokens=args.new_tokens)
    t0 = time.time()
    rows = serve_load(engine, runtime, tagged)
    dt = time.time() - t0
    tokens = sum(r["n_out"] for r in rows)
    ttfts = sorted(r["ttft_s"] for r in rows)
    st = runtime.stats
    print(f"[serve] {len(rows)} requests / {len(store)} tenants / "
          f"{tokens} tokens in {dt:.2f}s ({tokens / dt:.1f} tok/s)")
    print(f"[serve] cache hit rate {st.get('hit_rate', 0):.2f} "
          f"({st.get('hits', 0)} hits, {st.get('misses', 0)} misses, "
          f"{st.get('evictions', 0)} evictions); "
          f"{st['records_replayed']} ledger records replayed")
    print(f"[serve] TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms / "
          f"p99 {ttfts[int(len(ttfts) * 0.99)] * 1e3:.1f} ms")
    ps = engine.prefix_stats()
    print(f"[serve] prefill: {ps['prefill_tokens_computed']}/"
          f"{ps['prefill_tokens_submitted']} tokens computed "
          f"({ps['token_reuse_rate']:.0%} reused), prefix hit rate "
          f"{ps['prefix_hit_rate']:.2f}, "
          f"{ps['prefill_batches']} prefill batches, "
          f"{ps['evicted_blocks']} blocks evicted")


if __name__ == "__main__":
    main()
