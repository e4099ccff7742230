"""Continuous-batching serving engine — the port of ``repro.serve.engine``,
single-model paths: the paged path for dense and moe models without a
sliding window, and the dense-slab path for everything else it serves
(hybrid, ssm, a sliding window, ``paged=False``).

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

Multi-tenant serving (``repro_torch.serve.tenants``): ``register_adapter``
hands the engine a named changed-leaf delta over the frozen base, requests
carry an ``adapter`` name, and each slot remembers the adapter it decodes
with.  Prefills run with the request's adapter on both paths (a paged
prefill group shares one adapter), and each adapter name roots its own
radix subtree, so KV computed under one tenant's weights is never served to
another.  One decode step batches heterogeneous adapters as JAX's does:

* only the base live: the single-model decode above, unchanged;
* dense or moe with no full-tree delta: the STACKED decode — the union of
  the live adapters' changed leaves stacked along a slot axis (rebuilt only
  when the slot assignment changes) and ``torch.func.vmap`` of the
  registry decode over the slots, one call for every slot (the varying
  projections become batched matmuls; base leaves are shared, never
  copied; the cache rows are written in place through the vmap);
* anything else (ssm, hybrid, a full-tree delta): the GROUPED decode — one
  call per distinct live adapter on that group's slots, taken from the
  pre-step cache and state, its rows merged back.

``decode_calls`` counts the calls of the registry decode itself, booked
under the path of the step that made them, and ``decode_steps`` the steps:
``vmap`` runs the decode once for all the slots, so a stacked step books
one call, where a loop over slots would book one per slot.

The dense slab is JAX's legacy per-slot path (``paged=False``, or any
model the paged path cannot take): the engine holds per-slot KV caches
(``init_cache(..., per_slot=True)``: one ``pos`` row per slot, a ring of
``min(max_len, window)`` rows under a sliding window, so hymba-1.5b and
mixtral-8x7b decode in O(window)) and, for the recurrent families, one
stacked state with a slot axis (rwkv6's, or hybrid's SSM state).
Admission prefills one request at a time: at its EXACT prompt length for
ssm and hybrid (padding after the prompt would run through the recurrence
and corrupt the state; the ssm prefill runs the chunk scan, K11 on the
card), bucketed to a power of two for dense and moe; a causal prefill is
K2's under ``pallas_flash``.  Its first ``min(prompt, cap)`` KV rows and
its state are copied into the slot.  A prompt longer than the slot's
capacity is refused at ``submit``, as JAX refuses it.  The lockstep decode
writes each slot's new row at ``pos % cap``.  The slab has no block pool
(no K12) and no prefix cache.  encdec is not served, as in JAX (its engine
asserts the family): whisper decodes through the registry's ``prefill_fn`` /
``decode_fn``.  A moe model's routing groups follow the forward's rule in
every phase: a chunk prefill's padded rows share groups with the real
tokens, and a decode step is one token per group (capacity 8, nothing
dropped).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels.paged.gather import paged_gather, upload_table
from repro_torch.models import bundle as make_bundle
from repro_torch.models import rwkv6, transformer
from repro_torch.models.attention import init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import init_ssm_state
from repro_torch.serve.paged import (KVBlockPool, RadixCache, bucket_for,
                                     pow2ceil, prefill_buckets)
from repro_torch.tree_utils import tree_leaves, tree_map, tree_unflatten


def _slot_rows(tree, idx):
    """Copies of slots ``idx`` (axis 1 of every leaf) of a cache or state
    tree, or None."""
    return None if tree is None else tree_map(lambda a: a[:, idx], tree)


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
        if cfg.family not in ("dense", "moe", "hybrid", "ssm"):
            raise NotImplementedError(
                f"family {cfg.family!r}: the serving engine takes dense, moe, "
                "hybrid and ssm models, as JAX's does (its engine asserts "
                "the family); an encdec model decodes through the "
                "registry's prefill_fn / decode_fn")
        paged_ok = cfg.family in ("dense", "moe") and cfg.sliding_window == 0
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

        # paged: assembled per decode step; slab: the per-slot caches
        self.cache = None
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
        else:
            if cfg.family != "ssm":
                self.cache = init_cache(cfg, slots, max_len, cfg.param_dtype,
                                        self.device, per_slot=True)
            if cfg.family == "hybrid":
                self.state = init_ssm_state(cfg, slots, device=self.device)
            elif cfg.family == "ssm":
                self.state = rwkv6.init_rwkv_state(cfg, slots, self.device)
        self._buckets = prefill_buckets(self._prompt_limit())

        self.queue: deque = deque()
        self.active: list = [None] * slots
        self.pos = np.zeros((slots,), np.int32)       # next position per slot

        # adapter identity: name -> delta; per-slot assignment; derived trees
        self.adapters: dict = {}
        self.slot_adapter: list = [None] * slots
        self._adapter_params: dict = {None: params}   # name -> full tree view
        self._base_leaves = tree_leaves(params)
        self._stack_sig = None           # slot_adapter snapshot the stack fits
        self._stack = None               # (vidx, [stacked leaf tensors])
        self.decode_calls = {"base": 0, "stacked": 0, "grouped": 0}
        self.decode_steps = {"base": 0, "stacked": 0, "grouped": 0}

        self._registry_decode = self.bundle.decode_fn()
        self._decode_count = 0          # registry decode calls, every path
        self.stats = {"requests": 0, "prefill_tokens_submitted": 0,
                      "prefill_tokens_computed": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0, "prefill_batches": 0,
                      "evicted_blocks": 0}

    # ------------------------------------------------------------------ #
    def register_adapter(self, name: str, delta) -> None:
        """Attach a named ``AdapterDelta`` over the frozen base.  Applying a
        delta is pure leaf replacement, so the adapter's full tree is a view
        sharing every unchanged buffer with the base.  Re-registering the
        same delta object is a no-op (the cache-hit path); a different delta
        under an existing name drops that name's radix scope (its cached
        prefix KV was computed under the old weights)."""
        if self.adapters.get(name) is delta:
            return
        if self.radix is not None and name in self.adapters:
            self.radix.drop_scope(name)
        self._adapter_params[name] = delta.apply(self.params)  # shape check
        self.adapters[name] = delta
        self._stack_sig = None          # stacked leaves may be stale

    def _params_for(self, adapter: Optional[str]):
        return self._adapter_params[adapter]

    def _prompt_limit(self) -> int:
        """Longest admissible prompt: one decode position must remain below
        ``max_len``, and a slab slot's capacity (``sliding_window`` rows
        under a window) must hold the whole prompt."""
        limit = self.max_len - 1
        if not self.paged and self.cache is not None:
            limit = min(limit, int(self.cache["k"].shape[2]))
        return limit

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
        if self.slot_adapter[slot] != req.adapter:
            self.slot_adapter[slot] = req.adapter
            self._stack_sig = None
        self.pos[slot] = len(req.prompt_ids)
        req.times.setdefault("prefill", time.perf_counter())

    def _release_slot(self, slot: int) -> None:
        self.active[slot] = None
        # an idle slot holds no adapter: its last one's leaves must not stay
        # in the stacked union
        self.slot_adapter[slot] = None
        if self.paged:
            for b in self.tables[slot]:
                self.pool.unref(b)
            self.tables[slot] = []

    # ------------------------------------------------------------------ #
    # Dense-slab admission: one prefill per request, KV rows and state
    # copied into the slot
    # ------------------------------------------------------------------ #
    def _prefill_slab(self, params, tokens: torch.Tensor):
        """One request's prefill on its (1, plen) tokens under ``params``:
        (logits (1, plen, V), KV cache of ``plen`` rows (ring-capped) or
        None, state or None)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            logits, st = rwkv6.forward(
                cfg, params, tokens=tokens,
                state=rwkv6.init_rwkv_state(cfg, 1, self.device))
            return logits, None, st
        plen = tokens.shape[1]
        cache = init_cache(cfg, 1, plen, cfg.param_dtype, self.device)
        state = (init_ssm_state(cfg, 1, device=self.device)
                 if cfg.family == "hybrid" else None)
        r = transformer.forward(cfg, params, tokens=tokens, cache=cache,
                                cache_pos=None, ssm_state=state)
        return r.logits, r.cache, r.ssm_state

    def _admit_slab(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            npr = len(req.prompt_ids)
            # a recurrent state integrates every token it sees: exact length
            plen = (npr if self.cfg.family in ("ssm", "hybrid")
                    else bucket_for(npr, self._buckets))
            toks = np.zeros((1, plen), np.int64)
            toks[0, :npr] = req.prompt_ids
            logits, kv, state = self._prefill_slab(
                self._params_for(req.adapter),
                torch.as_tensor(toks).to(self.device))
            if self.cache is not None and kv is not None:
                span = min(npr, self.cache["k"].shape[2])
                self.cache["k"][:, slot, :span] = kv["k"][:, 0, :span]
                self.cache["v"][:, slot, :span] = kv["v"][:, 0, :span]
                self.cache["pos"][:, slot, :span] = torch.arange(
                    span, dtype=torch.int32, device=self.device)[None]
                self.cache["pos"][:, slot, span:] = -1
            if isinstance(self.state, torch.Tensor):
                self.state[:, slot] = state[:, 0]
            elif self.state is not None:
                for full, one in zip(self.state, state):
                    full[:, slot] = one[:, 0]
            req.out_ids.append(self._sample(
                logits[0, npr - 1, :self.cfg.vocab_size], req.temperature))
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
            self._admit_slab()
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
        for (adapter, pcap, scap), grp in groups.items():
            self._prefill_group(adapter, pcap, scap, grp)

    def _prefill_group(self, adapter, pcap: int, scap: int,
                       grp: list) -> None:
        """One batched chunk-prefill for every request sharing (adapter,
        prefix pad, suffix bucket): gather cached prefix KV, run the suffix
        forward under the adapter's weights, write the suffix KV into each
        request's fresh blocks, thread the full chunks into the radix cache,
        and activate the slots."""
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
            self._params_for(adapter),
            {"tokens": torch.as_tensor(toks).to(dev), "cache": cache,
             "cache_pos": plens_t})
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
    # Decode: the single-model call, and the mixed-adapter paths
    # ------------------------------------------------------------------ #
    def _decode(self, params, batch):
        """The registry decode, each call counted (``decode_calls``)."""
        self._decode_count += 1
        return self._registry_decode(params, batch)

    def _run_decode(self, params, token, cache_pos, cache, state):
        """One registry decode call: (logits, cache, state) — the family
        decides which of cache and state it carries (the other is None)."""
        batch = {"token": token, "cache_pos": cache_pos}
        if self.cfg.family == "ssm":
            batch["state"] = state
            logits, state = self._decode(params, batch)
            return logits, None, state
        batch["cache"] = cache
        if self.cfg.family == "hybrid":
            batch["state"] = state
            logits, (cache, state) = self._decode(params, batch)
            return logits, cache, state
        logits, cache = self._decode(params, batch)
        return logits, cache, None

    def _stacked_leaves(self):
        """(vidx, stacked) for the current slot → adapter assignment: the
        union of the live adapters' changed-leaf indices, each stacked
        (slot axis 0) from the slot's adapter value or the base leaf.
        Rebuilt only when the assignment changes (``_stack_sig``)."""
        sig = tuple(self.slot_adapter)
        if self._stack_sig == sig:
            return self._stack
        names = {a for a in sig if a is not None}
        vidx = tuple(sorted({i for n in names
                             for i in self.adapters[n].indices}))
        by_name = {n: dict(zip(self.adapters[n].indices,
                               self.adapters[n].values)) for n in names}
        stacked = [torch.stack([by_name.get(a, {}).get(
            i, self._base_leaves[i]) for a in sig]) for i in vidx]
        self._stack_sig, self._stack = sig, (vidx, stacked)
        return self._stack

    def _stacked_decode(self, token, cache_pos) -> torch.Tensor:
        """Every slot in ONE call: ``vmap`` over slots of a batch-1 registry
        decode whose ``vidx`` leaves arrive stacked with a leading slot axis
        (base leaves shared).  Each slot's KV row is written in place into
        ``self.cache`` through the vmap; returns the (slots, 1, V) logits."""
        vidx, stacked = self._stacked_leaves()
        base, decode = self._base_leaves, self._decode

        def one(varying, tok, cpos, cache):
            leaves = list(base)
            for i, v in zip(vidx, varying):
                leaves[i] = v
            batch = {"token": tok[None], "cache_pos": cpos[None],
                     "cache": {k: a[:, None] for k, a in cache.items()}}
            logits, _ = decode(tree_unflatten(self.params, leaves), batch)
            return logits[0]

        return vmap(one, in_dims=(0, 0, 0, 1))(stacked, token, cache_pos,
                                                self.cache)

    def _grouped_decode(self, token, cache_pos, live: list) -> torch.Tensor:
        """One call per distinct live adapter on that group's slots: their
        token, position, cache rows and state rows taken from the pre-step
        cache and state (copies), decoded under the adapter's weights, and
        only those rows merged back (cache / state axis 1, logits axis 0)."""
        groups: dict = {}
        for s in live:
            groups.setdefault(self.slot_adapter[s], []).append(s)
        logits_all = None
        for name, slots_g in groups.items():
            idx = torch.as_tensor(slots_g, device=self.device)
            logits, cache_g, state_g = self._run_decode(
                self._params_for(name), token[idx], cache_pos[idx],
                _slot_rows(self.cache, idx), _slot_rows(self.state, idx))
            if logits_all is None:
                logits_all = logits.new_zeros((self.slots,)
                                              + tuple(logits.shape[1:]))
            logits_all[idx] = logits
            for full, part in ((self.cache, cache_g), (self.state, state_g)):
                if full is not None:
                    for f, p in zip(tree_leaves(full), tree_leaves(part)):
                        f[:, idx] = p
        return logits_all

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
        token = torch.as_tensor(toks).to(self.device)
        cache_pos = torch.as_tensor(self.pos.astype(np.int64)).to(self.device)
        if self.paged:
            self._ensure_decode_blocks(live)
            self.cache = self._assemble_decode_cache()
        names = {self.slot_adapter[s] for s in live}
        calls = self._decode_count
        if names == {None}:
            # every slot steps in lockstep; an inactive slot writes masked
            # junk (cache) or junk state that its next admission overwrites
            path = "base"
            logits, self.cache, self.state = self._run_decode(
                self.params, token, cache_pos, self.cache, self.state)
        elif self.cfg.family in ("dense", "moe") and not any(
                self.adapters[n].full_tree for n in names if n is not None):
            path = "stacked"
            logits = self._stacked_decode(token, cache_pos)
        else:
            path = "grouped"
            logits = self._grouped_decode(token, cache_pos, live)
        self.decode_calls[path] += self._decode_count - calls
        self.decode_steps[path] += 1
        if self.paged:
            self._writeback_decode(live)
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
