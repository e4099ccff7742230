"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> --smoke``.

The port of ``repro.launch.serve``, with its flags plus ``--device``:
builds the model from a seeded ``torch.Generator``, optionally replays a
MeZO scalar ledger onto the init params (a JAX- or port-written MZOL file of
the ``xla`` stream — MZOL1 implies it — or of ``pallas+z2``), then serves
a synthetic request workload through
the engine: paged for dense archs and moe ones without a sliding window
(``--arch granite-moe-3b-a800m``), the per-slot recurrent path for ssm ones
(``--arch rwkv6-3b``); a sliding-window arch (mixtral-8x7b) needs the
dense-slab caches, which come with the other-families slice, and is
refused.  Multi-tenant mode (``--tenants``) arrives with the tenants
slice.
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
from repro_torch.serve.tenants import composition_for_ledger


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
                    help="serve N synthetic LoRA tenants (tenants slice; "
                         "0 = single-model mode)")
    ap.add_argument("--cache-mb", type=float, default=64.0)
    ap.add_argument("--compact-every", type=int, default=0)
    ap.add_argument("--tenant-steps", type=int, default=10)
    ap.add_argument("--block", type=int, default=16,
                    help="paged KV block size in tokens")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="KV pool size in blocks (default: 2x slot demand)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the radix prefix cache (paged pool stays)")
    ap.add_argument("--templates", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain torch versions of the kernels)")
    args = ap.parse_args(argv)

    if args.tenants > 0:
        sys.exit("--tenants: multi-tenant serving is ported with the tenants "
                 "slice; run without --tenants for single-model serving")
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
    else:
        print(f"[serve] recurrent state: {args.slots} slots, exact-length "
              f"prefill, scan mode {cfg.scan_mode}, device={device}")

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


if __name__ == "__main__":
    main()
