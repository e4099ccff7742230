"""Trajectory ledger — the port of ``repro.core.trajectory`` (numpy and
struct only, so nearly verbatim: bytes and ``content_hash`` are identical in
both frameworks, MZOL1-5 read, MZOL2+ written).

The paper's §2.1 storage trick, promoted to a first-class checkpoint/recovery
mechanism.

A MeZO run is fully determined by ``(base_seed, [(lr_t, g_t)])`` — the paper
notes this needs "the seed plus 20,000 steps × 2 bytes ... less than 0.1 MB"
for a 66 B model.  We store g in fp16 (2 bytes, as the paper counts it) or
fp32, and reconstruct parameters by replaying through the execution engine
(``repro.exec``) step by step — no data access, no forward passes.

Fault-tolerance use: every worker appends (step, g) scalars to the ledger; a
replacement node restores the last full tensor checkpoint and replays the
ledger tail to rejoin *bitwise-identically* (tested in
tests/test_trajectory.py and tests/test_fault_tolerance.py).

The header records the full seed-schedule coordinates of the run — the
perturbation backend, ``batch_seeds`` (B streams per group, FZOO), the
execution plan (``exec_plan``, ``n_groups`` — seed-parallel groups, async
workers, or local n-SPSA's interleaved seeds, which all share one fold
schedule), and the parameter selection (``selection`` spec + ``sel_phase``
block-schedule offset, ``repro.select``).  Replay refuses mismatched
coordinates (``BackendMismatchError`` / ``PlanMismatchError`` /
``SelectionMismatchError``) instead of silently pairing the recorded scalars
with different z streams or a different parameter support.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import struct
from typing import Optional

import numpy as np

from repro_torch.tree_utils import PyTree

_MAGIC = b"MZOL1\x00"          # legacy format: no backend record (implies xla)
_MAGIC2 = b"MZOL2\x00"         # adds the perturbation-backend name
_MAGIC3 = b"MZOL3\x00"         # adds batch_seeds (B per-seed scalars per step)
_MAGIC4 = b"MZOL4\x00"         # adds the execution plan (exec_plan, n_groups)
_MAGIC5 = b"MZOL5\x00"         # adds the parameter selection (spec + phase)


@dataclasses.dataclass
class TrajectoryLedger:
    """Append-only scalar record of a MeZO run.

    ``backend`` records which perturbation backend generated the run's z
    streams (``repro.perturb``); replay refuses a mismatched backend because
    the streams differ (``BackendMismatchError``).  Legacy ``MZOL1`` files
    deserialize with ``backend="xla"`` (the only backend that existed).

    ``batch_seeds`` records how many seed streams each *group* evaluated
    (FZOO's B); ``n_groups``/``exec_plan`` record the execution plan's group
    count and kind (seed-parallel batch groups, async workers, local n-SPSA
    seeds — one shared fold schedule).  Each step's record is the
    ``n_groups × batch_seeds`` per-stream g vector, which is exactly what the
    engine's group replay needs to refold the rank-1 updates.

    ``selection``/``sel_phase`` record the run's parameter selection
    (``repro.select`` spec string + block-schedule phase offset): the
    selection decides which leaves each recorded scalar's update touches, so
    replay under a mismatched selection refuses (``SelectionMismatchError``).

    Plain B=1 single-group full-selection runs keep serializing as ``MZOL2``
    (batched single-group runs as ``MZOL3``, multi-group runs as ``MZOL4``)
    so old readers keep working; ``MZOL5`` — the superset header — is written
    only when the selection is not ``full``.  All coordinates are fixed per
    ledger — they are properties of the recorded run."""
    base_seed: int
    grad_dtype: str = "float16"       # the paper's 2-bytes-per-step accounting
    backend: str = "xla"              # perturbation backend of the run
    batch_seeds: int = 1              # seed streams (g scalars) per group
    exec_plan: str = "local"          # execution plan kind of the run
    n_groups: int = 1                 # seed groups per step (plan-level)
    selection: str = "full"           # parameter-selection spec of the run
    sel_phase: int = 0                # selection block-schedule phase offset
    steps: list = dataclasses.field(default_factory=list)    # step indices
    grads: list = dataclasses.field(default_factory=list)    # projected grads
    lrs: list = dataclasses.field(default_factory=list)      # lr actually used

    def _streams_per_step(self) -> int:
        return int(self.batch_seeds) * int(self.n_groups)

    def append(self, step: int, projected_grad, lr: float) -> None:
        """Record one step.  ``projected_grad`` is a scalar (one stream) or a
        length-``n_groups·batch_seeds`` vector of per-stream scalars."""
        arr = np.atleast_1d(np.asarray(projected_grad)).astype(self.grad_dtype)
        if arr.ndim != 1:
            raise ValueError(f"projected_grad must be scalar or 1-D, "
                             f"got shape {arr.shape}")
        if not self.steps and self._streams_per_step() == 1:
            # default-constructed ledger: infer B from the first record
            self.batch_seeds = int(arr.size)
        elif int(arr.size) != self._streams_per_step():
            # a constructor-declared stream count is a promise, not a
            # default — a mismatched first record fails HERE (the recording
            # site), not later at replay time with a ledger-vs-optimizer error
            raise ValueError(
                f"this ledger records {self._streams_per_step()} seed "
                f"scalar(s) per step (n_groups={self.n_groups} × "
                f"batch_seeds={self.batch_seeds}); got {arr.size} — the "
                "stream count is fixed per run")
        self.steps.append(int(step))
        # stored after quantization; scalars stay plain floats (legacy shape)
        self.grads.append(float(arr[0]) if arr.size == 1
                          else [float(x) for x in arr])
        self.lrs.append(float(lr))

    def __len__(self) -> int:
        return len(self.steps)

    # -- identity / slicing (the serving layer's cache-key primitives) ------ #
    def content_hash(self, upto: Optional[int] = None) -> str:
        """Stable hex digest over the header coordinates + the first ``upto``
        records (all of them when ``None``).  This is THE cache key of the
        multi-tenant serving layer (``serve.tenants``): two ledgers
        share a hash iff they would replay the identical parameter delta, so
        a materialized delta keyed on ``(content_hash, n_records)`` can be
        reused across processes and hosts.  Records hash over their *stored*
        (post-quantization) values, so the digest survives a
        ``to_bytes``/``from_bytes`` round trip (test-enforced)."""
        n = len(self.steps) if upto is None else int(upto)
        if not 0 <= n <= len(self.steps):
            raise ValueError(f"content_hash upto={n} outside the ledger's "
                             f"{len(self.steps)} records")
        h = hashlib.sha256()
        h.update(repr((self.base_seed, self.grad_dtype, self.backend,
                       self.batch_seeds, self.exec_plan, self.n_groups,
                       self.selection, self.sel_phase)).encode("utf-8"))
        h.update(np.asarray(self.steps[:n], np.int64).tobytes())
        h.update(np.asarray(self.grads[:n], self.grad_dtype).tobytes())
        h.update(np.asarray(self.lrs[:n], np.float32).tobytes())
        return h.hexdigest()

    def slice(self, from_idx: int, to_idx: Optional[int] = None) \
            -> "TrajectoryLedger":
        """A new ledger with the same header coordinates holding records
        ``[from_idx, to_idx)``.  Records keep their original step indices, so
        replaying a slice folds the exact same per-step seeds as replaying
        the corresponding span of the full ledger — this is what makes a
        compacted adapter's *tail* (``serve.tenants.compact``) replay
        bitwise-identically to the full-ledger suffix."""
        to_idx = len(self.steps) if to_idx is None else int(to_idx)
        out = TrajectoryLedger(
            base_seed=self.base_seed, grad_dtype=self.grad_dtype,
            backend=self.backend, batch_seeds=self.batch_seeds,
            exec_plan=self.exec_plan, n_groups=self.n_groups,
            selection=self.selection, sel_phase=self.sel_phase)
        out.steps = list(self.steps[from_idx:to_idx])
        out.grads = list(self.grads[from_idx:to_idx])
        out.lrs = list(self.lrs[from_idx:to_idx])
        return out

    # -- serialization ----------------------------------------------------- #
    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        selected = self.selection != "full" or self.sel_phase != 0
        planned = self.n_groups > 1
        batched = self.batch_seeds > 1
        buf.write(_MAGIC5 if selected else
                  (_MAGIC4 if planned else (_MAGIC3 if batched else _MAGIC2)))
        buf.write(struct.pack("<qi", self.base_seed,
                              1 if self.grad_dtype == "float16" else 4))
        bname = self.backend.encode("utf-8")
        buf.write(struct.pack("<i", len(bname)))
        buf.write(bname)
        if selected or planned or batched:
            buf.write(struct.pack("<i", self.batch_seeds))
        if selected or planned:
            buf.write(struct.pack("<i", self.n_groups))
            pname = self.exec_plan.encode("utf-8")
            buf.write(struct.pack("<i", len(pname)))
            buf.write(pname)
        if selected:
            sname = self.selection.encode("utf-8")
            buf.write(struct.pack("<i", len(sname)))
            buf.write(sname)
            buf.write(struct.pack("<i", self.sel_phase))
        buf.write(struct.pack("<q", len(self.steps)))
        buf.write(np.asarray(self.steps, np.int64).tobytes())
        buf.write(np.asarray(self.grads, self.grad_dtype).tobytes())
        buf.write(np.asarray(self.lrs, np.float32).tobytes())
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TrajectoryLedger":
        buf = io.BytesIO(raw)
        magic = buf.read(len(_MAGIC))
        if magic not in (_MAGIC, _MAGIC2, _MAGIC3, _MAGIC4, _MAGIC5):
            raise ValueError("not a MeZO ledger (unknown magic "
                             f"{magic!r})")
        seed, dcode = struct.unpack("<qi", buf.read(12))
        backend = "xla"                       # MZOL1 predates backend choice
        batch_seeds = 1
        n_groups = 1
        exec_plan = "local"
        selection = "full"                    # MZOL1-4 predate selections
        sel_phase = 0
        if magic != _MAGIC:
            blen, = struct.unpack("<i", buf.read(4))
            backend = buf.read(blen).decode("utf-8")
        if magic in (_MAGIC3, _MAGIC4, _MAGIC5):
            batch_seeds, = struct.unpack("<i", buf.read(4))
        if magic in (_MAGIC4, _MAGIC5):
            n_groups, = struct.unpack("<i", buf.read(4))
            plen, = struct.unpack("<i", buf.read(4))
            exec_plan = buf.read(plen).decode("utf-8")
        if magic == _MAGIC5:
            slen, = struct.unpack("<i", buf.read(4))
            selection = buf.read(slen).decode("utf-8")
            sel_phase, = struct.unpack("<i", buf.read(4))
        n, = struct.unpack("<q", buf.read(8))
        dtype = "float16" if dcode == 1 else "float32"
        itemsize = np.dtype(dtype).itemsize
        per_step = batch_seeds * n_groups
        steps = np.frombuffer(buf.read(8 * n), np.int64)
        grads = np.frombuffer(buf.read(itemsize * n * per_step), dtype)
        lrs = np.frombuffer(buf.read(4 * n), np.float32)
        led = cls(base_seed=seed, grad_dtype=dtype, backend=backend,
                  batch_seeds=batch_seeds, exec_plan=exec_plan,
                  n_groups=n_groups, selection=selection,
                  sel_phase=sel_phase)
        led.steps = [int(s) for s in steps]
        if per_step == 1:
            led.grads = [float(g) for g in grads]
        else:
            led.grads = [[float(g) for g in row]
                         for row in grads.reshape(n, per_step)]
        led.lrs = [float(l) for l in lrs]
        return led

    def nbytes(self) -> int:
        return len(self.to_bytes())


def replay(params0: PyTree, ledger: TrajectoryLedger, optimizer,
           from_idx: int = 0, to_idx: Optional[int] = None) -> PyTree:
    """Reconstruct θ_T from θ_0 (or a mid-run checkpoint) by replaying the
    scalar ledger through the execution engine (``StepProgram.replay``),
    writing into ``params0``'s leaves in place.
    Uses the exact same write path as training, so the reconstruction is
    bitwise when grad_dtype='float32' and the training loop records the
    quantized g it actually applied.

    ``optimizer`` is a ``repro_torch.exec.StepProgram`` (whose plan must match the
    ledger's — the resume path) or anything ``as_zo_optimizer`` accepts,
    which is wrapped on the ledger-driven ``replay()`` plan (adopting the
    ledger's recorded ``n_groups``).  Mismatched seed-schedule coordinates
    raise ``BackendMismatchError`` / ``PlanMismatchError`` — the z streams
    differ, so the reconstruction would silently diverge."""
    from repro_torch.exec import StepProgram, as_step_program
    from repro_torch.exec import plan as plan_mod
    if isinstance(optimizer, StepProgram):
        prog = optimizer
    else:
        prog = as_step_program(optimizer, plan_mod.replay())
    return prog.replay(params0, ledger, from_idx=from_idx, to_idx=to_idx)


def storage_report(n_steps: int, grad_dtype: str = "float16") -> dict:
    """Paper §2.1 numbers: ledger bytes vs. LoRA / prefix checkpoint bytes."""
    itemsize = np.dtype(grad_dtype).itemsize
    return {
        "ledger_bytes": 8 + n_steps * itemsize,
        "lora_opt66b_bytes": 19_000_000 * 2,     # 19 M params, bf16 (paper: 38 MB)
        "prefix_opt66b_bytes": 6_000_000 * 2,    # 6 M params (paper: 12 MB)
    }
