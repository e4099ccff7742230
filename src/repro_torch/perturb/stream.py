"""The z-stream identity — the port of ``repro.perturb.stream``.

A stream is a pure function of ``(run_seed, step, seed_index, leaf_index)``.
JAX derives it with threefry ``fold_in`` chains on PRNG keys; the counter-hash
backend then folds the final key into one int32 seed.  The port reproduces
that host-side, with a pure-Python threefry-2x32 (20 rounds, rotations
(13, 15, 26, 6)/(17, 29, 16, 24), key-schedule parity 0x1BD11BDA) — exact
integer code, so the seeds equal JAX's bit for bit:

    PRNGKey(s)     = (0, s & 0xFFFFFFFF)                  (|s| < 2**31)
    fold_in(k, d)  = threefry2x32(k, (0, d & 0xFFFFFFFF))
    counter_seed   = int32(key[0] ^ key[1])
    leaf_seed(i)   = int32(counter_seed + 0x1000003 · i)  (wraparound)

Keys are plain ``(k0, k1)`` tuples of Python ints; nothing here touches a
tensor or a device.

The threefry layout is JAX's ``jax_threefry_partitionable`` knob, and the
port has the same knob (``threefry_partitionable(flag)``, a context manager,
and ``set_threefry_partitionable``), its initial value read from
``JAX_THREEFRY_PARTITIONABLE`` as JAX reads it, default on.  ``PRNGKey`` and
``fold_in`` are the same in both layouts; ``split`` and every draw of random
bits (``kernels.threefry``'s ``random_bits``) follow the switch.  Under the
original layout a draw of m 32-bit words hashes the counts ``iota(m)`` cut
in two halves of h = ⌈m/2⌉ (the odd count padded with a 0): word w < h is
output 0 of ``threefry2x32(key, (w, w + h))`` (count m read as 0), word
w ≥ h output 1 of ``threefry2x32(key, (w − h, w))`` (``original_word``).

A ref may carry a parameter selection (``with_selection``), which scopes
which leaves and row-blocks consume the stream without changing its bits.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import List, NamedTuple, Optional, Tuple

from repro_torch.tree_utils import tree_leaves

_MASK = 0xFFFFFFFF
# Multiplier decorrelating per-leaf counter streams (the zo_fused schedule).
_LEAF_STRIDE = 0x1000003
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Key, count: Key) -> Key:
    """One threefry-2x32 block (Salmon et al., 2011), as ``jax.random``
    computes it for a 2-word count."""
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (count[0] + ks[0]) & _MASK
    x1 = (count[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


_ENV = "JAX_THREEFRY_PARTITIONABLE"
_TRUE = ("y", "yes", "t", "true", "on", "1")
_FALSE = ("n", "no", "f", "false", "off", "0")


def _env_flag() -> bool:
    """The knob's initial value, from the environment variable JAX reads
    for it (JAX's ``bool_env`` spellings; anything else raises)."""
    val = os.getenv(_ENV, "true").lower()
    if val in _TRUE:
        return True
    if val in _FALSE:
        return False
    raise ValueError(f"invalid truth value {val!r} for environment {_ENV!r}")


_partitionable = _env_flag()
_local = threading.local()


def set_threefry_partitionable(flag: bool) -> None:
    """``jax.config.update("jax_threefry_partitionable", flag)``."""
    global _partitionable
    _partitionable = bool(flag)


def partitionable() -> bool:
    """The layout in force: the innermost ``threefry_partitionable`` of
    this thread, else the global value."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else _partitionable


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """``jax.threefry_partitionable(flag)``: the layout inside the block
    (this thread only)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(bool(flag))
    try:
        yield
    finally:
        stack.pop()


def original_word(key: Key, m: int, w: int) -> int:
    """Word w of ``threefry_2x32(key, iota(m))``, the original layout's
    bits (m < 2³², the counts of one key)."""
    h = (m + 1) // 2
    if w < h:
        return threefry2x32(key, (w, w + h if w + h < m else 0))[0]
    return threefry2x32(key, (w - h, w))[1]


def split(key: Key, n: int = 2) -> List[Key]:
    """``jax.random.split(key, n)`` in the layout in force: partitionable,
    key j is threefry2x32(key, (0, j)) = ``fold_in(key, j)``; original,
    the 2n words of ``threefry_2x32(key, iota(2n))`` taken in pairs."""
    if partitionable():
        return [fold_in(key, j) for j in range(n)]
    return [(original_word(key, 2 * n, 2 * j),
             original_word(key, 2 * n, 2 * j + 1)) for j in range(n)]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits int32."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit int32")
    return 0, seed & _MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for int32 ``data``."""
    return threefry2x32(key, (0, int(data) & _MASK))


def step_key(base_key: Key, step: int) -> Key:
    """Per-step key: the paper's 'sample random seed s' for step t."""
    return fold_in(base_key, step)


def _as_int32(x: int) -> int:
    x &= _MASK
    return x - (1 << 32) if x >= (1 << 31) else x


class StreamRef(NamedTuple):
    """Identity of one per-seed perturbation stream (``key`` is the fully
    derived threefry key).  ``selection`` / ``phase`` optionally scope it to
    a parameter subset (a ``repro_torch.select.Selection`` and its schedule
    phase, a Python int): the backend reads ``selection_mask`` and
    ``selection_blocks`` and leaves unselected leaves and row-blocks alone.
    The default ``(None, 0)`` is the full tree."""
    key: Key
    selection: object = None
    phase: int = 0

    @classmethod
    def derive(cls, base_key: Key, step: int,
               seed_index: Optional[int] = None, selection=None,
               phase: int = 0) -> "StreamRef":
        """run key → step t → (optional) seed j, optionally scoped to a
        selection at a schedule phase."""
        key = step_key(base_key, step)
        if seed_index is not None:
            key = fold_in(key, seed_index)
        return cls(key, selection, phase)

    def with_selection(self, selection, phase: int = 0) -> "StreamRef":
        """The same stream (key bits untouched) scoped to ``selection`` at
        ``phase``: the selection decides which leaves consume the stream,
        not the stream itself."""
        return self._replace(selection=selection, phase=phase)

    def selection_mask(self, params) -> Optional[tuple]:
        """Per-leaf active mask of ``params`` (flatten order), or ``None``
        when the ref carries no selection (every leaf active)."""
        if self.selection is None:
            return None
        return self.selection.leaf_mask(params, self.phase)

    def selection_blocks(self, params) -> Optional[tuple]:
        """Per-leaf sub-leaf plans (flatten order): a ``RowBlocks`` per leaf
        under a ``rows`` selection, else ``None``.

        The counter stream indexes a leaf by flat element position (z of
        element e hashes ``leaf_seed(i)`` with e), so row-block b's bits are
        a function of ``(leaf_seed, b)`` alone: the same whether the leaf is
        perturbed whole or block by block, and stable under restructuring
        of the surrounding tree (the plan depends on the leaf's own shape)."""
        if self.selection is None:
            return None
        bm = getattr(self.selection, "block_mask", None)
        if bm is None:
            return None
        blocks = tuple(bm(leaf, self.phase) for leaf in tree_leaves(params))
        if all(b is None for b in blocks):
            return None
        return blocks

    def counter_seed(self) -> int:
        """The key folded into one int32 seed (``key[0] ^ key[1]``)."""
        return _as_int32(self.key[0] ^ self.key[1])

    def leaf_seed(self, leaf_index: int) -> int:
        """Per-leaf int32 counter seed (int32 wraparound, as in JAX)."""
        return leaf_seed(self.counter_seed(), leaf_index)


def leaf_seed(seed: int, leaf_index: int) -> int:
    return _as_int32(int(seed) + _LEAF_STRIDE * int(leaf_index))
