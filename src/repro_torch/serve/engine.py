"""Continuous-batching serving engine — the port of ``repro.serve.engine``,
single-model paths: the paged path for dense and moe models without a
sliding window, the per-slot recurrent path for the ssm family.

* ``submit`` queues a request (refusing over-long prompts and unknown
  adapters); ``step`` admits queued requests into free slots and runs one
  lockstep decode over every live slot.
* KV lives in a refcounted ``KVBlockPool``; each slot holds a block table.
  A ``RadixCache`` finds the longest cached prompt prefix, so admission
  prefills only the suffix: one admission wave's suffixes are grouped by
  (prefix pad, power-of-two suffix bucket) and each group runs as ONE
  batched ``chunk_prefill`` resuming from the prefix KV gathered from the
  pool (K12).  A group with no cached prefix is a plain causal prefill,
  which the ``pallas_flash`` attention impl sends to K2.
* Decode assembles each slot's cache row from its block table (K12, one
  launch for K and one for V), runs the registry decode, and writes the new
  row back into the slot's tail block.
* Sampling is greedy (argmax) or temperature (``torch.multinomial`` on the
  engine's ``torch.Generator``).

The contract is token identity: output ids with the prefix cache on equal
the ids with it off.

The ssm family (rwkv6) keeps JAX's legacy per-slot path (``paged=False``):
the engine holds one stacked recurrent state with a slot axis; admission
prefills each request at its EXACT prompt length (padding after the prompt
would run through the recurrence and corrupt the state), through the chunk
scan (K11 on the card), and writes the request's state into its slot; the
lockstep decode carries the state for every slot.  Adapters and
mixed-adapter decode come with the tenants slice; the hybrid family and the
dense-slab caches (a sliding window, as mixtral-8x7b's, or ``paged=False``
on a dense or moe model) with the other-families slice.  A moe model's
routing groups follow the forward's rule in every phase: a chunk prefill's
padded rows share groups with the real tokens, and a decode step is one
token per group (capacity 8, nothing dropped).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels.paged.gather import paged_gather, upload_table
from repro_torch.models import bundle as make_bundle
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv6 import init_rwkv_state
from repro_torch.serve.paged import (KVBlockPool, RadixCache, bucket_for,
                                     pow2ceil, prefill_buckets)


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: list
    max_new_tokens: int = 16
    temperature: float = 0.0
    adapter: Optional[str] = None           # registered adapter name, or base
    times: dict = dataclasses.field(default_factory=dict)  # lifecycle stamps
    out_ids: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 seed: int = 0, block: int = 16,
                 pool_blocks: Optional[int] = None, prefix_cache: bool = True,
                 paged: Optional[bool] = None, device: DeviceSpec = None):
        paged_ok = cfg.family in ("dense", "moe") and cfg.sliding_window == 0
        if cfg.family != "ssm" and (not paged_ok or paged is False):
            raise NotImplementedError(
                f"family={cfg.family!r} sliding_window={cfg.sliding_window} "
                f"paged={paged}: the port serves dense and moe models "
                "without a sliding window through the paged engine and the "
                "ssm family through the per-slot recurrent path; a sliding "
                "window (SWA ring caches) and paged=False need the engine's "
                "dense-slab path, which comes with the other-families slice "
                "(ROADMAP Queue 1 item 7), as does the hybrid family")
        self.paged = paged_ok if paged is None else bool(paged)
        if self.paged and not paged_ok:
            raise ValueError(
                f"paged KV requires absolute-position cache rows; family="
                f"{cfg.family!r} sliding_window={cfg.sliding_window} keeps "
                "the legacy dense-slab path (pass paged=None/False)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.bundle = make_bundle(cfg)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

        self.cache = None                      # assembled per decode step
        self.pool = self.radix = self.state = None
        if self.paged:
            self.block = block
            self._nblk_slot = -(-max_len // block)
            if pool_blocks is None:
                pool_blocks = 1 + 2 * slots * self._nblk_slot
            self.pool = KVBlockPool(cfg, pool_blocks, block, cfg.param_dtype,
                                    self.device)
            self.radix = RadixCache(self.pool) if prefix_cache else None
            self.tables: list = [[] for _ in range(slots)]
            self._chunk_prefill = self.bundle.chunk_prefill_fn()
            self._buckets = prefill_buckets(self._prompt_limit())
        else:
            self.state = init_rwkv_state(cfg, slots, self.device)
            self._prefill = self.bundle.prefill_fn()

        self.queue: deque = deque()
        self.active: list = [None] * slots
        self.pos = np.zeros((slots,), np.int32)       # next position per slot
        self.adapters: dict = {}

        self._decode = self.bundle.decode_fn()
        self.stats = {"requests": 0, "prefill_tokens_submitted": 0,
                      "prefill_tokens_computed": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0, "prefill_batches": 0,
                      "evicted_blocks": 0}

    # ------------------------------------------------------------------ #
    def register_adapter(self, name: str, delta) -> None:
        raise NotImplementedError(
            "adapters (register_adapter, mixed-adapter decode) are ported "
            "with the tenants slice")

    def _prompt_limit(self) -> int:
        """Longest admissible prompt: one decode position must remain below
        ``max_len``."""
        return self.max_len - 1

    def submit(self, req: Request) -> None:
        limit = self._prompt_limit()
        if len(req.prompt_ids) > limit:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt_ids)} tokens "
                f"exceeds this engine's limit of {limit} (max_len="
                f"{self.max_len}); raise max_len or truncate the prompt "
                "upstream")
        if req.adapter is not None and req.adapter not in self.adapters:
            raise KeyError(
                f"request {req.rid}: adapter {req.adapter!r} is not "
                f"registered (have: {sorted(self.adapters)[:8]}); call "
                "register_adapter first")
        req.times.setdefault("queued", time.perf_counter())
        self.queue.append(req)

    def _activate(self, slot: int, req: Request) -> None:
        self.active[slot] = req
        self.pos[slot] = len(req.prompt_ids)
        req.times.setdefault("prefill", time.perf_counter())

    def _release_slot(self, slot: int) -> None:
        self.active[slot] = None
        if self.paged:
            for b in self.tables[slot]:
                self.pool.unref(b)
            self.tables[slot] = []

    # ------------------------------------------------------------------ #
    # Recurrent admission: exact-length prefill, state into the slot
    # ------------------------------------------------------------------ #
    def _admit_recurrent(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            npr = len(req.prompt_ids)
            toks = torch.as_tensor([req.prompt_ids],
                                   dtype=torch.int64).to(self.device)
            logits, state = self._prefill(self.params, {"tokens": toks})
            for full, one in zip(self.state, state):
                full[:, slot] = one[:, 0]
            req.out_ids.append(self._sample(logits[0, -1, :self.cfg.vocab_size],
                                            req.temperature))
            st = self.stats
            st["requests"] += 1
            st["prefill_tokens_submitted"] += npr
            st["prefill_tokens_computed"] += npr
            st["prefill_batches"] += 1
            self._activate(slot, req)

    # ------------------------------------------------------------------ #
    # Admission: radix match -> bucketed batched suffix prefill
    # ------------------------------------------------------------------ #
    def _alloc_blocks(self, n: int) -> list:
        if n == 0:
            return []
        if self.radix is not None and n > self.pool.n_free:
            self.stats["evicted_blocks"] += self.radix.evict(
                n - self.pool.n_free)
        return self.pool.alloc(n)

    def _gather_blocks(self, tabs: np.ndarray):
        """(L, B, nblk·block, KV, hd) K and V from per-row block tables
        ``tabs (B, nblk)`` (trash-padded) — K12."""
        L, NT, KV, hd = self.pool.k.shape
        B, nblk = tabs.shape
        # one checked upload of the table serves both gathers
        flat = upload_table(tabs.reshape(-1), NT // self.block,
                            self.pool.k.device)
        gk = paged_gather(self.pool.k.view(L, NT, KV * hd), flat, self.block)
        gv = paged_gather(self.pool.v.view(L, NT, KV * hd), flat, self.block)
        shape = (L, B, nblk * self.block, KV, hd)
        return gk.view(shape), gv.view(shape)

    def _admit(self) -> None:
        if not self.paged:
            self._admit_recurrent()
            return
        free = [s for s in range(self.slots) if self.active[s] is None]
        pending = []
        while free and self.queue:
            pending.append((free.pop(0), self.queue.popleft()))
        if not pending:
            return
        blk = self.block
        plans = []
        for slot, req in pending:
            if self.radix is not None:
                cached, nc = self.radix.match(req.adapter, req.prompt_ids)
            else:
                cached, nc = [], 0
            npr = len(req.prompt_ids)
            new_blocks = self._alloc_blocks(-(-npr // blk) - nc // blk)
            for b in cached:
                self.pool.ref(b)          # slot's own pin on shared prefix
            st = self.stats
            st["requests"] += 1
            st["prefill_tokens_submitted"] += npr
            st["prefill_tokens_computed"] += npr - nc
            if nc:
                st["prefix_hits"] += 1
                st["prefix_tokens_reused"] += nc
            plans.append((slot, req, nc, cached, new_blocks))
        groups: dict = {}
        for plan in plans:
            _, req, nc, _, _ = plan
            pcap = blk * pow2ceil(nc // blk) if nc else 0
            scap = bucket_for(len(req.prompt_ids) - nc, self._buckets)
            groups.setdefault((req.adapter, pcap, scap), []).append(plan)
        for (_, pcap, scap), grp in groups.items():
            self._prefill_group(pcap, scap, grp)

    def _prefill_group(self, pcap: int, scap: int, grp: list) -> None:
        """One batched chunk-prefill for every request sharing (prefix pad,
        suffix bucket): gather cached prefix KV, run the suffix forward,
        write the suffix KV into each request's fresh blocks, thread the
        full chunks into the radix cache, and activate the slots."""
        cfg, blk, dev = self.cfg, self.block, self.device
        L, _, KV, hd = self.pool.k.shape
        B = len(grp)
        dtype = cfg.param_dtype
        toks = np.zeros((B, scap), np.int64)
        plens = np.zeros((B,), np.int64)
        for i, (_, req, nc, _, _) in enumerate(grp):
            suf = req.prompt_ids[nc:]
            toks[i, :len(suf)] = suf
            plens[i] = nc
        ck = torch.zeros((L, B, pcap + scap, KV, hd), dtype=dtype, device=dev)
        cv = torch.zeros_like(ck)
        cpos = np.full((B, pcap + scap), -1, np.int32)
        if pcap:
            tabs = np.zeros((B, pcap // blk), np.int32)
            for i, (_, _, nc, cached, _) in enumerate(grp):
                tabs[i, :len(cached)] = cached
                cpos[i, :nc] = np.arange(nc, dtype=np.int32)
            pk, pv = self._gather_blocks(tabs)
            ck[:, :, :pcap] = pk
            cv[:, :, :pcap] = pv
        cache = {"k": ck, "v": cv,
                 "pos": torch.as_tensor(cpos).to(dev)[None].repeat(L, 1, 1)}
        plens_t = torch.as_tensor(plens).to(dev)
        logits, cache = self._chunk_prefill(
            self.params, {"tokens": torch.as_tensor(toks).to(dev),
                          "cache": cache, "cache_pos": plens_t})
        self.stats["prefill_batches"] += 1
        # the last real prompt logit of each request
        s_last = torch.as_tensor([len(req.prompt_ids) - nc - 1
                                  for _, req, nc, _, _ in grp]).to(dev)
        last = logits[torch.arange(B, device=dev), s_last, :cfg.vocab_size]
        # suffix KV sits at cache rows [plen, plen+npr-nc) — the row index IS
        # the absolute position; copy the real rows into the fresh blocks
        src_b, src_r, rows = [], [], []
        for i, (slot, req, nc, cached, new_blocks) in enumerate(grp):
            npr = len(req.prompt_ids)
            req.out_ids.append(self._sample(last[i], req.temperature))
            for p in range(nc, npr):
                src_b.append(i)
                src_r.append(p)
                rows.append(new_blocks[(p - nc) // blk] * blk + p % blk)
            self.tables[slot] = list(cached) + list(new_blocks)
            if self.radix is not None:
                chunk_blocks = (list(cached)
                                + list(new_blocks[:npr // blk - nc // blk]))
                if chunk_blocks:
                    self.radix.insert(req.adapter, req.prompt_ids,
                                      chunk_blocks)
            self._activate(slot, req)
        bi = torch.as_tensor(src_b).to(dev)
        ri = torch.as_tensor(src_r).to(dev)
        self.pool.write(np.asarray(rows), cache["k"][:, bi, ri],
                        cache["v"][:, bi, ri])

    # ------------------------------------------------------------------ #
    # Decode: block-table gather -> registry decode -> row writeback
    # ------------------------------------------------------------------ #
    def _ensure_decode_blocks(self, live: list) -> None:
        blk = self.block
        for s in live:
            bi = int(self.pos[s]) // blk
            while len(self.tables[s]) <= bi:
                self.tables[s].extend(self._alloc_blocks(1))

    def _assemble_decode_cache(self) -> dict:
        """Dense (L, slots, T, KV, hd) view of every slot's block table
        (T = ceil(max_len/block)·block); inactive slots gather the trash
        block with pos = −1 everywhere."""
        blk = self.block
        T = self._nblk_slot * blk
        tabs = np.zeros((self.slots, self._nblk_slot), np.int32)
        valid = np.zeros((self.slots, 1), np.int32)
        for s in range(self.slots):
            tabs[s, :len(self.tables[s])] = self.tables[s]
            if self.active[s] is not None:
                valid[s, 0] = int(self.pos[s])
        gk, gv = self._gather_blocks(tabs)
        ar = np.arange(T, dtype=np.int32)[None]
        pos_rows = torch.as_tensor(np.where(ar < valid, ar, -1)).to(self.device)
        L = self.pool.k.shape[0]
        return {"k": gk, "v": gv,
                "pos": pos_rows[None].expand(L, self.slots, T).contiguous()}

    def _writeback_decode(self, live: list) -> None:
        """Copy each live slot's freshly written decode row (cache row
        pos[s]) back into its tail pool block."""
        blk = self.block
        idx = torch.as_tensor(live).to(self.device)
        pj = torch.as_tensor(self.pos[np.asarray(live)].astype(np.int64)).to(
            self.device)
        rows = np.array(
            [self.tables[s][int(self.pos[s]) // blk] * blk
             + int(self.pos[s]) % blk for s in live], np.int64)
        self.pool.write(rows, self.cache["k"][:, idx, pj],
                        self.cache["v"][:, idx, pj])
        self.cache = None

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        if temperature <= 0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """One lockstep decode over all live slots; returns #live slots."""
        self._admit()
        live = [s for s, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        toks = np.zeros((self.slots, 1), np.int64)
        for s in live:
            toks[s, 0] = self.active[s].out_ids[-1]
        batch = {"token": torch.as_tensor(toks).to(self.device),
                 "cache_pos": torch.as_tensor(self.pos.astype(np.int64)).to(
                     self.device)}
        if self.paged:
            self._ensure_decode_blocks(live)
            self.cache = batch["cache"] = self._assemble_decode_cache()
            logits, self.cache = self._decode(self.params, batch)
            self._writeback_decode(live)
        else:
            # every slot steps in lockstep; an inactive slot's state is junk
            # that its next admission overwrites
            batch["state"] = self.state
            logits, self.state = self._decode(self.params, batch)
        now = time.perf_counter()
        for s in live:
            req = self.active[s]
            tok = self._sample(logits[s, 0, :self.cfg.vocab_size],
                               req.temperature)
            req.out_ids.append(tok)
            req.times.setdefault("decode", now)
            self.pos[s] += 1
            if ((self.eos_id is not None and tok == self.eos_id)
                    or len(req.out_ids) >= req.max_new_tokens
                    or self.pos[s] >= self.max_len - 1):
                req.done = True
                req.times["done"] = time.perf_counter()
                self._release_slot(s)
        return len(live)

    def prefix_stats(self) -> dict:
        """Prefill-economy counters: tokens submitted vs computed, prefix
        hits, evictions; ``token_reuse_rate`` is the fraction of submitted
        prompt tokens served from the radix cache."""
        st = dict(self.stats)
        st["prefix_hit_rate"] = (st["prefix_hits"] / st["requests"]
                                 if st["requests"] else 0.0)
        st["token_reuse_rate"] = (
            st["prefix_tokens_reused"] / st["prefill_tokens_submitted"]
            if st["prefill_tokens_submitted"] else 0.0)
        if self.pool is not None:
            st["pool_blocks"] = self.pool.n_blocks
            st["pool_free_blocks"] = self.pool.n_free
            st["radix_nodes"] = self.radix.n_nodes if self.radix else 0
        return st

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.active):
                break
            self.step()
