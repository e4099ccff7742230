"""Multi-tenant serving demo: N LoRA fine-tunes of ONE frozen base, each
persisted as nothing but its scalar trajectory ledger, served through a
single continuous-batching engine — the paper's §2.1 storage trick turned
into a serving story end to end — the port of ``examples/serve_batch.py``:

    train N tenants -> N ledgers (~130 B each)
                    -> AdapterStore (content-hash keyed)
                    -> compact()    (delta + replayable tail)
                    -> DeltaCache   (byte-budgeted LRU; warm hits do ZERO
                                     replay folds)
                    -> one decode step batches requests from different
                       tenants (stacked LoRA deltas, vmap over slots)

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]
"""
import argparse
import time

from repro_torch.device import resolve_device
from repro_torch.models import bundle
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.tenants import (lora_runtime, make_lora_tenants,
                                       serve_load, synthetic_requests)

N_TENANTS = 6
N_REQUESTS = 18


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = ModelConfig(name="serve-lm", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                      max_seq=128, dtype="float32")
    params0 = bundle(cfg).init(0, device=dev)

    # --- N tenants fine-tune LoRA over the SAME frozen base --------------- #
    t0 = time.time()
    store = make_lora_tenants(cfg, params0, N_TENANTS, steps=8, batch=8)
    print(f"trained {len(store)} LoRA tenants in {time.time() - t0:.1f}s; "
          f"ALL their checkpoints together: {store.nbytes()} bytes")

    # --- a serving host: delta cache + compaction over the store ---------- #
    runtime = lora_runtime(cfg, params0, store, cache_bytes=32_000_000)
    for t in store.tenants():
        comp = runtime.compact_tenant(t, keep_tail=2)
    print(f"compacted every ledger to delta + {len(comp.tail)}-record tail "
          f"(cold materialization is O(tail), bitwise-equal to full replay)")

    # --- one engine serves a skewed mix across every tenant --------------- #
    engine = ServeEngine(cfg, params0, slots=3, max_len=96, device=dev)
    tagged = synthetic_requests(N_REQUESTS, cfg.vocab_size, store.tenants(),
                                seed=0, max_new_tokens=8)
    t0 = time.time()
    rows = serve_load(engine, runtime, tagged)
    dt = time.time() - t0

    for tenant, req in tagged[:6]:
        print(f"  [{tenant}] req {req.rid}: {req.prompt_ids} -> {req.out_ids}")
    st = runtime.stats
    tokens = sum(r["n_out"] for r in rows)
    print(f"served {len(rows)} requests / {N_TENANTS} tenants / {tokens} "
          f"tokens on 3 slots in {dt:.2f}s — mixed-adapter decode batches "
          "different tenants in ONE step")
    print(f"cache: {st['hits']} hits / {st['misses']} misses "
          f"(hit rate {st['hit_rate']:.2f}); ledger records replayed: "
          f"{st['records_replayed']} (warm hits replay nothing)")


if __name__ == "__main__":
    main()
