"""The work of one call of each of the port's kernels: the bytes it must
move (each input read once, each output written once) and the operations
it must do, as functions of the call's shapes, dtype, streams and plan.

``chip_smoke.py``'s ``kernels`` line computes each kernel's roofline bound
from these functions, and every kernel wrapper charges its call here while
a counter is open (``counting()``), on every route — the plain version on
the CPU, the launch on the card, the shape rule on ``meta`` tensors — so a
dry run (``repro_torch.launch.dryrun``) and the kernel table read the same
work.  A wrapper given a DTensor charges its local shard.

Operations are of two kinds, by the unit that does them on an H100:
``"tensor"`` (bf16 / f16 matmul flops on the tensor cores: K2) and
``"f32"`` (CUDA-core operations: the z generators' arithmetic, an FMA
counted as two and the integer hashing left out, and K11's f32
recurrence).  ``bound_ms`` reads each at its rate in ``roofline``.
"""
from __future__ import annotations

import contextlib
import functools
from collections import Counter
from typing import Iterable, NamedTuple

from repro_torch.analysis.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS

#: f32 operations per element of the counter-hash gaussian stream (K1, K3–K10),
#: an FMA counted as two and the integer hashing left out: 2 uniforms (4) +
#: log (20) + −2·, max, sqrt (3) + cos (33) + r·c (1) + the affine combine (3)
GAUSSIAN_FLOPS_PER_ELEMENT = 64
#: per element of the rademacher stream: the sign and the affine combine
RADEMACHER_FLOPS_PER_ELEMENT = 3
#: X1's threefry stream, per element, at the f32 rate (its kernel-line
#: reckoning: the affine combine and the z scale)
THREEFRY_FLOPS_PER_ELEMENT = 4

RATES = {"tensor": PEAK_FLOPS, "f32": F32_FLOPS}


class Cost(NamedTuple):
    """One call's work: ``bytes`` moved, ``ops`` done at ``rate``
    (``"tensor"`` or ``"f32"``)."""
    bytes: int
    ops: int
    rate: str = "f32"


def bound_ms(cost) -> tuple:
    """(the least ms the card could take for ``cost``, what bounds it): its
    bytes at ``HBM_BW`` against its operations at their rate.  ``cost`` is
    one ``Cost`` or a list of calls at one rate (their ``total``)."""
    if not isinstance(cost, Cost):
        cost = total(cost)
    by_bytes, by_ops = cost.bytes / HBM_BW, cost.ops / RATES[cost.rate]
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def total(costs: Iterable[Cost]) -> Cost:
    """The sum of calls at one rate."""
    costs = list(costs)
    rates = {c.rate for c in costs}
    if len(rates) != 1:
        raise ValueError(f"costs at one rate only, got {sorted(rates)}")
    return Cost(sum(c.bytes for c in costs), sum(c.ops for c in costs),
                rates.pop())


def z_flops(dist: str) -> int:
    """f32 operations per element of a counter-hash z write."""
    return (RADEMACHER_FLOPS_PER_ELEMENT if dist == "rademacher"
            else GAUSSIAN_FLOPS_PER_ELEMENT)


# --------------------------------------------------------------------------- #
# The z kernels
# --------------------------------------------------------------------------- #
def zo_affine(n: int, itemsize: int, dist: str = "gaussian") -> Cost:
    """K1: y = a·x + b·z over n elements — x read, y written."""
    return Cost(2 * n * itemsize, z_flops(dist) * n)


def zo_affine_fanout(n: int, itemsize: int, streams: int,
                     dist: str = "gaussian") -> Cost:
    """K4 / K5: x read once, one output per stream."""
    return Cost((1 + streams) * n * itemsize, z_flops(dist) * streams * n)


def zo_affine_chain(n: int, itemsize: int, streams: int,
                    dist: str = "gaussian") -> Cost:
    """K3: the fold over the streams in one read and one write."""
    return Cost(2 * n * itemsize, z_flops(dist) * streams * n)


def zo_sqnorm(n: int, dist: str = "gaussian") -> Cost:
    """K6: ‖z‖² moves no leaf; z without the affine combine's 3
    operations, plus the square and the add."""
    return Cost(0, (z_flops(dist) - 3 + 2) * n)


def zo_affine_rows(n_sel: int, itemsize: int, dist: str = "gaussian") -> Cost:
    """K7: the selected elements read and written once."""
    return Cost(2 * n_sel * itemsize, z_flops(dist) * n_sel)


def zo_affine_multi_rows(n: int, n_sel: int, itemsize: int, streams: int,
                         dist: str = "gaussian") -> Cost:
    """K8: θ read once and written once per stream; z on the selected
    elements only."""
    return Cost((1 + streams) * n * itemsize,
                z_flops(dist) * streams * n_sel)


def zo_affine_chain_rows(n_sel: int, itemsize: int, streams: int,
                         dist: str = "gaussian") -> Cost:
    """K9: the fold on the selected elements, one read and one write."""
    return Cost(2 * n_sel * itemsize, z_flops(dist) * streams * n_sel)


def zo_sqnorm_rows(n_sel: int, dist: str = "gaussian") -> Cost:
    """K10: K6 on the selected elements."""
    return Cost(0, (z_flops(dist) - 3 + 2) * n_sel)


def zo_affine_threefry(n: int, itemsize: int, form: str = "axpbz") -> Cost:
    """X1: one affine write of JAX's threefry z over n elements (the
    selected ones under a rows plan); form ``z`` writes z and reads
    nothing."""
    return Cost((1 if form == "z" else 2) * n * itemsize,
                THREEFRY_FLOPS_PER_ELEMENT * n)


# --------------------------------------------------------------------------- #
# Attention, the recurrence, the gather
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def attended_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """Unmasked (q, k) pairs of one (batch, head): the work K2 must do."""
    total_ = 0
    for qi in range(S):
        lo = max(0, qi - window + 1) if window > 0 else 0
        hi = qi if causal else S - 1
        total_ += max(0, hi - lo + 1)
    return total_


def flash_attention(B: int, S: int, H: int, KV: int, hd: int, itemsize: int,
                    causal: bool = True, window: int = 0) -> Cost:
    """K2: q, k, v read and o written once; QKᵀ and PV over the attended
    pairs (2 · 2 · hd flops a pair), on the tensor cores in bf16 / f16
    and on the CUDA cores in f32."""
    nbytes = itemsize * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    ops = 4 * hd * attended_pairs(S, causal, window) * B * H
    return Cost(nbytes, ops, "tensor" if itemsize == 2 else "f32")


def wkv6_flops(B: int, S: int, H: int, hd: int, chunk: int) -> int:
    """f32 operations of the chunked recurrence (an FMA counted as two):
    per chunk and (b, h) the cumsum and the three factors (~9 per element,
    an exp counted as one), the strict-lower r̃k̃ᵀ, the bonus, A·v, bonus·v,
    r̃·S and the state update."""
    C, n = chunk, S // chunk
    pairs = C * (C - 1) // 2
    per_chunk = (9 * C * hd + 2 * pairs * hd + 3 * C * hd
                 + 2 * pairs * hd + 2 * C * hd + 2 * C * hd * hd
                 + 2 * hd * hd + 2 * C * hd * hd)
    return B * H * n * per_chunk


def wkv6_chunked(B: int, S: int, H: int, hd: int, chunk: int,
                 itemsize: int = 4) -> Cost:
    """K11: r, k, v, log-decay read and y written (5 per element), s0 read
    and the final state written, u read once."""
    n = B * S * H * hd
    return Cost(itemsize * (5 * n + 2 * B * H * hd * hd + H * hd),
                wkv6_flops(B, S, H, hd, chunk))


def paged_gather(L: int, n_blocks: int, block: int, D: int,
                 itemsize: int) -> Cost:
    """K12: each gathered block row read once and written once."""
    return Cost(2 * L * n_blocks * block * D * itemsize, 0)


# --------------------------------------------------------------------------- #
# The counters the wrappers charge
# --------------------------------------------------------------------------- #
class CostCounter:
    """Calls, bytes and operations charged per kernel (keyed by its launch
    count's name, ``kernels._build.launch_counts``) while open."""

    def __init__(self):
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.ops: Counter = Counter()
        self.by_rate: Counter = Counter()

    def add(self, kernel: str, cost: Cost) -> None:
        self.calls[kernel] += 1
        self.bytes[kernel] += int(cost.bytes)
        self.ops[kernel] += int(cost.ops)
        self.by_rate[cost.rate] += int(cost.ops)

    def ops_at(self, rate: str) -> int:
        """Operations charged at ``rate`` over every kernel."""
        return self.by_rate[rate]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def as_dict(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k],
                    "ops": self.ops[k]} for k in sorted(self.calls)}


_COUNTERS: list = []


def active() -> bool:
    return bool(_COUNTERS)


def charge(kernel: str, cost: Cost) -> None:
    """One call of ``kernel`` doing ``cost``, into every open counter."""
    for c in _COUNTERS:
        c.add(kernel, cost)


@contextlib.contextmanager
def counting():
    """Open a ``CostCounter`` for the block; counters nest."""
    c = CostCounter()
    _COUNTERS.append(c)
    try:
        yield c
    finally:
        _COUNTERS.remove(c)
