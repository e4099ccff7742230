"""Paged KV-block pool + radix prefix cache — the port of
``repro.serve.paged`` (host bookkeeping unchanged; the pool tensors live on
the engine's device).

``KVBlockPool``
    One pool tensor per K and V, ``(L, n_blocks·block, KV, hd)``; blocks are
    refcounted host-side, block 0 is the pinned *trash block* that absorbs
    padding writes so block tables can be padded to a static width.
``RadixCache``
    A trie over ``block``-sized token chunks, scoped per adapter identity;
    each node pins one pool block.  ``match`` returns the longest cached
    prefix that still leaves ≥ 1 prompt token to prefill; eviction is LRU
    over leaves whose block nobody but the trie holds.

``pow2ceil`` / ``prefill_buckets`` / ``bucket_for`` give the power-of-two
prefill pad widths derived from the engine's prompt limit.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch


class PoolExhaustedError(RuntimeError):
    """The pool has fewer free blocks than an allocation needs — after radix
    eviction has already been tried."""


def pow2ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def prefill_buckets(limit: int, lo: int = 16) -> tuple:
    """Powers of two from ``lo`` up to ``pow2ceil(limit)``."""
    top = pow2ceil(max(limit, lo))
    return tuple(itertools.takewhile(
        lambda b: b <= top, (lo * 2 ** i for i in range(64))))


def bucket_for(n: int, buckets: tuple) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"length {n} exceeds largest prefill bucket "
                     f"{buckets[-1]} (buckets={buckets})")


# --------------------------------------------------------------------------- #
class KVBlockPool:
    """Refcounted pool of fixed-size KV token blocks.  ``k``/``v`` are
    ``(L, n_blocks·block, KV, hd)``; block ``b`` owns token rows
    ``[b·block, (b+1)·block)``; 0 = free refcount; block 0 is pinned."""

    def __init__(self, cfg, n_blocks: int, block: int, dtype, device):
        if n_blocks < 2:
            raise ValueError("pool needs the trash block plus one real block")
        L, KV, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
        self.block = block
        self.n_blocks = n_blocks
        shape = (L, n_blocks * block, KV, hd)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.refs = [0] * n_blocks
        self.refs[0] = 1                          # trash: pinned forever
        self.trash = 0
        self._free = list(range(n_blocks - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list:
        """Take ``n`` blocks (refcount 1 each), or raise
        ``PoolExhaustedError`` if the free list is short."""
        if n > len(self._free):
            raise PoolExhaustedError(
                f"need {n} KV blocks, only {len(self._free)} of "
                f"{self.n_blocks} free (block={self.block} tokens); raise "
                "pool_blocks or let the prefix cache evict")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.refs[b] = 1
        return out

    def ref(self, b: int) -> None:
        if self.refs[b] <= 0:
            raise RuntimeError(f"ref on free block {b}")
        self.refs[b] += 1

    def unref(self, b: int) -> None:
        if self.refs[b] <= 0:
            raise RuntimeError(f"unref on free block {b}")
        self.refs[b] -= 1
        if self.refs[b] == 0:
            self._free.append(b)

    def write(self, rows: np.ndarray, k: torch.Tensor, v: torch.Tensor) -> None:
        """Scatter token rows: ``k``/``v`` ``(L, n, KV, hd)`` land at pool
        rows ``rows (n,)`` (row = block_id·block + offset).  Rows that point
        into the trash block may repeat; it holds junk by contract."""
        idx = torch.as_tensor(np.asarray(rows, np.int64)).to(self.k.device)
        self.k[:, idx] = k
        self.v[:, idx] = v


# --------------------------------------------------------------------------- #
class _Node:
    __slots__ = ("chunk", "block", "children", "parent", "last_use")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk          # tuple of ``block``-many token ids
        self.block = block          # pool block id this node pins
        self.children = {}          # chunk tuple -> _Node
        self.parent = parent        # _Node, or None at a scope root
        self.last_use = 0


class RadixCache:
    """Prefix trie over block-sized token chunks, scoped per adapter."""

    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self._roots: dict = {}               # scope -> {chunk: _Node}
        self._clock = 0
        self.n_nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, scope, tokens) -> tuple:
        """(cached block ids, cached token count) of the longest cached
        prefix, strictly shorter than the prompt."""
        blk = self.pool.block
        cur = self._roots.get(scope)
        blocks: list = []
        end = 0
        t = self._tick()
        while cur is not None and end + blk < len(tokens):
            child = cur.get(tuple(tokens[end:end + blk]))
            if child is None:
                break
            child.last_use = t
            blocks.append(child.block)
            end += blk
            cur = child.children
        return blocks, end

    def insert(self, scope, tokens, chunk_blocks: list) -> None:
        """Record a prefilled prompt's full chunks (``chunk_blocks[i]`` holds
        tokens ``[i·blk, (i+1)·blk)``); new nodes take one trie ref."""
        blk = self.pool.block
        cur = self._roots.setdefault(scope, {})
        parent = None
        t = self._tick()
        for i, b in enumerate(chunk_blocks):
            chunk = tuple(tokens[i * blk:(i + 1) * blk])
            node = cur.get(chunk)
            if node is None:
                node = _Node(chunk, b, parent)
                cur[chunk] = node
                self.pool.ref(b)
                self.n_nodes += 1
            node.last_use = t
            parent = node
            cur = node.children

    def _leaves(self):
        out = []
        stack = [n for root in self._roots.values() for n in root.values()]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, n_blocks: int) -> int:
        """Release up to ``n_blocks`` blocks, LRU evictable leaves first."""
        freed = 0
        while freed < n_blocks:
            cands = [n for n in self._leaves() if self.pool.refs[n.block] == 1]
            if not cands:
                break
            victim = min(cands, key=lambda n: n.last_use)
            holder = (victim.parent.children if victim.parent is not None
                      else self._first_root_holding(victim))
            del holder[victim.chunk]
            self.pool.unref(victim.block)
            self.n_nodes -= 1
            freed += 1
        return freed

    def _first_root_holding(self, node: _Node) -> dict:
        for root in self._roots.values():
            if root.get(node.chunk) is node:
                return root
        raise KeyError("radix node detached from every scope root")

    def drop_scope(self, scope) -> int:
        """Invalidate every cached prefix of one adapter identity."""
        root = self._roots.pop(scope, None)
        if root is None:
            return 0
        dropped = 0
        stack = list(root.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.unref(n.block)
            self.n_nodes -= 1
            dropped += 1
        return dropped
