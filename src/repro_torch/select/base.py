"""``Selection`` — which parameter leaves a ZO step perturbs, and when: the
port of ``repro.select.base`` (pure Python over the port's dict-of-tensor
trees).

* a **static leaf predicate** — which leaves are trainable at a schedule
  phase, a pure function of the tree's structure in jax flatten order
  (``repro_torch.tree_utils``), so an unselected leaf costs no kernel launch
  at all, not a masked multiply;
* an optional **per-step block schedule** — ``n_phases`` rotating blocks
  with phase(t) = (t + phase_offset) mod n_phases, a function of the step
  counter only, so every execution plan (local, seed_parallel, replay) sees
  the same phase.

Built-in selections::

    full()                   # every leaf, every step (the default)
    leaves(pattern)          # regex over keystr leaf paths, static
    block_cyclic(k)          # leaf i active at phase i % k; phase = t % k
    peft("lora" | "prefix")  # the merged-tree PEFT subtree (models/peft.py)
    moe_experts(G)           # MoE: router frozen, expert group t % G active
    rows(block=R, k=K)       # SUB-LEAF: every leaf cut into row-blocks of
                             # R rows; row-block b active at phase b % K

Under ``rows`` a leaf of shape ``(M, D...)`` is viewed as ``(M, prod(D))``
and cut into ``ceil(M / R)`` row-blocks; step t perturbs the blocks with
``b % K == t % K``.  The perturbation backend reads the per-leaf plan
(``Selection.block_mask``, a :class:`RowBlocks`) and launches the sub-leaf
kernels K7–K10 (``kernels/zo_fused/rows.py``) over the selected elements
only.  Element e's z is the counter stream at e either way, so a selected
block's bits are the same whether the leaf is perturbed whole or by blocks,
and ``rows(block=R, k=1)`` is bitwise ≡ ``full``.

Leaf paths render as ``jax.tree_util.keystr`` renders them
(``['layers']['attn']['wq']``), so a ``leaves(regex)`` or ``peft`` spec
picks the same leaves in both frameworks.  Selections are hashable
NamedTuples with a canonical ``spec`` string (``parse_selection``
round-trips it), the form recorded in checkpoint meta and the ``MZOL5``
ledger header; replay under another selection refuses
(``SelectionMismatchError``).  Unselected leaves are completely untouched
by a step: no perturbation, no update, no decoupled weight decay.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional, Union

from repro_torch.tree_utils import flatten_with_path, is_floating, tree_leaves

SELECTION_KINDS = ("full", "leaves", "block_cyclic", "peft", "moe_experts",
                   "rows")
PEFT_MODES = ("lora", "prefix")

# grouped-MoE expert leaves: params[...]['moe']['eg{j}'][...] when
# cfg.expert_groups > 1 (models/moe.py)
_EG_RE = re.compile(r"\['eg(\d+)'\]")
_ROUTER_KEY = "['router']"


class SelectionMismatchError(RuntimeError):
    """A seed-replay artifact (ledger / checkpoint) was recorded under one
    parameter selection and is being replayed under another.  The selection
    decides which leaves each recorded scalar's rank-1 update touches, so
    continuing would silently apply the updates to a different parameter
    support — refuse instead."""


def _numel(leaf) -> int:
    n = 1
    for d in leaf.shape:
        n *= int(d)
    return n


class RowBlocks(NamedTuple):
    """Static sub-leaf row-block plan for ONE leaf under a ``rows``
    selection — the value of :meth:`Selection.block_mask`.

    The leaf is viewed as ``n_rows`` × ``row_width`` (1-D leaves have
    ``row_width=1``, a scalar is one 1×1 row) and cut into
    ``ceil(n_rows / block_rows)`` row-blocks.  Row-block ``b`` covers the
    flat elements ``[b*block_elems, min(n_rows, (b+1)*block_rows)*row_width)``
    and is selected iff ``b % k == phase``.  All fields are Python ints."""
    block_rows: int        # R: rows per block
    row_width: int         # prod(shape[1:]) — elements per row
    n_rows: int            # shape[0] (or size, for 1-D leaves)
    k: int                 # schedule period (selection.n_phases)
    phase: int             # this step's phase, already reduced mod k

    @property
    def size(self) -> int:
        """Total element count of the leaf."""
        return self.n_rows * self.row_width

    @property
    def block_elems(self) -> int:
        """Flat elements per (full) row-block: block ``b`` owns counter
        indices ``[b*block_elems, (b+1)*block_elems)`` of its leaf stream."""
        return self.block_rows * self.row_width

    @property
    def n_blocks(self) -> int:
        return -(-self.n_rows // self.block_rows)

    @property
    def all_selected(self) -> bool:
        """True iff every row-block is selected at ``phase`` — the signal to
        take the whole-leaf kernels (bitwise ≡ ``full``).  Blocks 0 and 1
        fall on different phases unless k = 1, so this is O(1)."""
        return self.n_blocks == 0 or (
            self.phase == 0 and (self.k == 1 or self.n_blocks == 1))

    def selected_blocks(self) -> tuple:
        """Indices of the row-blocks selected at ``phase``."""
        return tuple(range(self.phase, self.n_blocks, self.k))

    def block_range(self, b: int) -> tuple:
        """Flat element range ``(lo, hi)`` of row-block ``b``."""
        lo = b * self.block_elems
        hi = min(self.n_rows, (b + 1) * self.block_rows) * self.row_width
        return lo, hi

    def ranges(self) -> tuple:
        """Coalesced flat ``(lo, hi)`` ranges of the selected blocks."""
        out = []
        for b in self.selected_blocks():
            lo, hi = self.block_range(b)
            if out and out[-1][1] == lo:
                out[-1] = (out[-1][0], hi)
            else:
                out.append((lo, hi))
        return tuple(out)

    def selected_elems(self) -> int:
        """Flat element count of the selected row-blocks, in O(1) (the
        backend asks for it on every sphere pass; the embedding has 151 936
        one-row blocks): whole blocks, less the ragged last block's missing
        rows when it is selected."""
        n_sel = len(range(self.phase, self.n_blocks, self.k))
        count = n_sel * self.block_elems
        if n_sel and (self.n_blocks - 1 - self.phase) % self.k == 0:
            count -= (self.n_blocks * self.block_rows
                      - self.n_rows) * self.row_width
        return count

    def element_mask(self, flat_index):
        """Selected-predicate over flat element indices (an int tensor, an
        array or an int): element ``e`` lives in block ``e // block_elems``."""
        return (flat_index // self.block_elems) % self.k == self.phase


def leaf_row_blocks(leaf, block_rows: int, k: int, phase: int) -> RowBlocks:
    """The :class:`RowBlocks` plan of one leaf: shape ``(M, D...)`` →
    ``n_rows=M``, ``row_width=prod(D)``; 1-D → width 1; scalar → one 1×1
    row."""
    shape = tuple(int(d) for d in leaf.shape)
    if len(shape) == 0:
        n_rows, width = 1, 1
    elif len(shape) == 1:
        n_rows, width = shape[0], 1
    else:
        n_rows = shape[0]
        width = 1
        for d in shape[1:]:
            width *= d
    return RowBlocks(block_rows=int(block_rows), row_width=int(width),
                     n_rows=int(n_rows), k=int(k), phase=int(phase) % int(k))


class Selection(NamedTuple):
    """One parameter-selection rule: ``kind`` + canonical argument, plus the
    block-schedule coordinates (``n_phases``, ``phase_offset``)."""
    kind: str
    arg: str = ""
    n_phases: int = 1
    phase_offset: int = 0

    # -- identity ----------------------------------------------------------- #
    @property
    def spec(self) -> str:
        """Canonical string form (``parse_selection`` round-trips it); the
        phase offset is recorded separately (``sel_phase``)."""
        if self.kind == "full":
            return "full"
        if self.kind in ("block_cyclic", "moe_experts"):
            return f"{self.kind}({self.n_phases})"
        if self.kind == "rows":
            return f"rows(block={self.arg},k={self.n_phases})"
        return f"{self.kind}({self.arg})"

    def is_full(self) -> bool:
        return self.kind == "full"

    # -- schedule ----------------------------------------------------------- #
    def phase_at(self, step: int) -> int:
        """Schedule phase of step t: ``(t + phase_offset) mod n_phases``."""
        return (int(step) + self.phase_offset) % self.n_phases

    # -- the static predicate ----------------------------------------------- #
    def leaf_mask(self, params, phase: int = 0) -> Optional[tuple]:
        """Per-leaf boolean tuple for ``phase`` (flatten order), or ``None``
        for the full selection.  Non-floating leaves are never selected.  An
        empty selection fails loudly: a step that perturbs nothing is a
        configuration error, not a no-op."""
        if self.kind == "full":
            return None
        flat = flatten_with_path(params)
        floating = [is_floating(leaf) for _, leaf in flat]
        if self.kind == "block_cyclic":
            k = self.n_phases
            n_float = sum(floating)
            if n_float < k:
                raise ValueError(
                    f"block_cyclic({k}) over a tree with only {n_float} "
                    f"floating leaves leaves some phases with nothing to "
                    f"perturb; use k <= {n_float}")
            ph = int(phase) % k
            # block indices run over the FLOATING leaves in flatten order
            mask, j = [], 0
            for f in floating:
                mask.append(bool(f) and (j % k) == ph)
                j += 1 if f else 0
            return tuple(mask)
        if self.kind == "moe_experts":
            return self._moe_experts_mask(flat, floating, phase)
        if self.kind == "rows":
            # a leaf takes part at this phase iff one of its row-blocks is
            # selected: blocks 0..n_blocks-1 hit phase p iff p < n_blocks, so
            # small leaves sit out the late phases
            K = self.n_phases
            ph = int(phase) % K
            R = int(self.arg)
            mask = tuple(
                bool(f) and leaf_row_blocks(leaf, R, K, ph).n_blocks > ph
                for f, (_, leaf) in zip(floating, flat))
            if not any(mask):
                n_max = max((leaf_row_blocks(leaf, R, K, 0).n_blocks
                             for f, (_, leaf) in zip(floating, flat) if f),
                            default=0)
                raise ValueError(
                    f"rows(block={R},k={K}) selects nothing at phase {ph}: "
                    f"the largest floating leaf has only {n_max} row-blocks "
                    f"of {R} rows, so phases >= {n_max} would perturb "
                    f"nothing; use k <= {n_max} or a smaller block")
            return mask
        paths = [p for p, _ in flat]
        if self.kind == "leaves":
            rx = re.compile(self.arg)
            mask = tuple(bool(f) and bool(rx.search(s))
                         for f, s in zip(floating, paths))
        elif self.kind == "peft":
            prefix = f"['{self.arg}']"
            mask = tuple(bool(f) and s.startswith(prefix)
                         for f, s in zip(floating, paths))
        else:
            raise ValueError(f"unknown selection kind {self.kind!r}")
        if not any(mask):
            raise ValueError(
                f"selection {self.spec!r} matches no floating leaves of "
                f"the parameter tree (paths: {paths[:4]}...); an empty "
                "selection would silently train nothing")
        return mask

    def _moe_experts_mask(self, flat, floating, phase) -> tuple:
        """Router always frozen, expert group ``eg{j}`` active iff
        ``j % G == phase``, every other floating leaf active every step."""
        G = self.n_phases
        ph = int(phase) % G
        paths = [p for p, _ in flat]
        if not any(f and _ROUTER_KEY in s for f, s in zip(floating, paths)):
            raise ValueError(
                f"moe_experts({G}) over a tree with no ['router'] leaf — not "
                "an MoE parameter tree (build the model with cfg.n_experts > "
                "0, e.g. the mixtral-8x7b registry arch)")
        mask, groups_seen = [], set()
        for f, s in zip(floating, paths):
            if not f or _ROUTER_KEY in s:
                mask.append(False)
                continue
            m = _EG_RE.search(s)
            if m is None:
                mask.append(True)                  # non-expert leaf: always on
            else:
                j = int(m.group(1))
                groups_seen.add(j)
                mask.append(j % G == ph)
        if G > 1:
            covered = {j % G for j in groups_seen}
            if covered != set(range(G)):
                raise ValueError(
                    f"moe_experts({G}) needs the grouped expert layout with "
                    f"every phase owning a group, but the tree has expert "
                    f"groups {sorted(groups_seen)} (phases covered: "
                    f"{sorted(covered)} of {G}); build the model with "
                    f"cfg.replace(expert_groups={G})")
        return tuple(mask)

    # -- the sub-leaf plan --------------------------------------------------- #
    def block_mask(self, leaf, phase: int = 0) -> Optional[RowBlocks]:
        """Static row-block plan of ``leaf`` at ``phase``, or ``None`` for
        every non-``rows`` selection (whole-leaf semantics).  A pure
        function of the leaf's shape."""
        if self.kind != "rows":
            return None
        return leaf_row_blocks(leaf, int(self.arg), self.n_phases, phase)

    # -- accounting ---------------------------------------------------------- #
    def selected_size(self, params, phase: int = 0) -> int:
        """Parameters active at ``phase``; under ``rows`` only the selected
        row-blocks of each active leaf count."""
        mask = self.leaf_mask(params, phase)
        leaves = tree_leaves(params)
        if mask is None:
            return sum(_numel(x) for x in leaves)
        if self.kind == "rows":
            return sum(self.block_mask(x, phase).selected_elems()
                       for x, m in zip(leaves, mask) if m)
        return sum(_numel(x) for x, m in zip(leaves, mask) if m)

    def selected_bytes(self, params, phase: int = 0) -> int:
        """Bytes of the parameters active at ``phase`` — the per-step
        perturbed (read-modify-write) traffic under this selection."""
        mask = self.leaf_mask(params, phase)
        leaves = tree_leaves(params)
        if mask is None:
            return sum(_numel(x) * x.element_size() for x in leaves)
        if self.kind == "rows":
            return sum(self.block_mask(x, phase).selected_elems()
                       * x.element_size()
                       for x, m in zip(leaves, mask) if m)
        return sum(_numel(x) * x.element_size()
                   for x, m in zip(leaves, mask) if m)


# --------------------------------------------------------------------------- #
# Factories
# --------------------------------------------------------------------------- #
def full() -> Selection:
    """Every leaf, every step — the default (estimators normalize it to
    ``None``)."""
    return Selection("full")


def leaves(pattern: str) -> Selection:
    """Static leaf selection by regex over keystr paths (e.g.
    ``leaves(r"\\['attn'\\]")`` perturbs only attention leaves)."""
    re.compile(pattern)            # fail at construction, not at the step
    return Selection("leaves", arg=pattern)


def block_cyclic(k: int, phase_offset: int = 0) -> Selection:
    """k rotating leaf blocks: leaf i is active at phase i mod k, and step t
    runs phase (t + phase_offset) mod k."""
    k = int(k)
    if k < 1:
        raise ValueError(f"block_cyclic needs k >= 1, got {k}")
    return Selection("block_cyclic", n_phases=k,
                     phase_offset=int(phase_offset) % k)


def moe_experts(groups: int, phase_offset: int = 0) -> Selection:
    """Expert-wise MoE selection: step t perturbs expert group
    ``(t + phase_offset) % groups`` plus all non-expert leaves; the router
    is frozen every step."""
    g = int(groups)
    if g < 1:
        raise ValueError(f"moe_experts needs groups >= 1, got {g}")
    return Selection("moe_experts", n_phases=g,
                     phase_offset=int(phase_offset) % g)


def rows(block: int, k: int, phase_offset: int = 0) -> Selection:
    """Sub-leaf row-block selection: step t perturbs the row-blocks of
    ``block`` rows with ``b % k == (t + phase_offset) % k`` in every leaf.
    ``rows(block=R, k=1)`` selects everything and is bitwise ≡ ``full``."""
    block = int(block)
    k = int(k)
    if block < 1:
        raise ValueError(f"rows needs block >= 1, got {block}")
    if k < 1:
        raise ValueError(f"rows needs k >= 1, got {k}")
    return Selection("rows", arg=str(block), n_phases=k,
                     phase_offset=int(phase_offset) % k)


def peft(mode: str) -> Selection:
    """The merged-tree PEFT selection: perturb only the ``mode`` subtree of
    a ``models.peft.peft_params(base, tree, mode)`` merged tree."""
    if mode not in PEFT_MODES:
        raise ValueError(f"unknown peft mode {mode!r}; available: {PEFT_MODES}")
    return Selection("peft", arg=mode)


# --------------------------------------------------------------------------- #
# Spec parsing / normalization
# --------------------------------------------------------------------------- #
_SPEC_RE = re.compile(r"^(\w+)\((.*)\)$")
_ROWS_RE = re.compile(r"^block=(\d+)\s*,\s*k=(\d+)$")


def parse_selection(spec: str, phase_offset: int = 0) -> Selection:
    """Parse a canonical spec string (``Selection.spec`` round-trips):
    ``"full"``, ``"leaves(<regex>)"``, ``"block_cyclic(<k>)"``,
    ``"peft(lora|prefix)"``, ``"moe_experts(<G>)"``,
    ``"rows(block=<R>,k=<K>)"``."""
    spec = spec.strip()
    if spec == "full":
        return full()
    m = _SPEC_RE.match(spec)
    if m is None:
        raise ValueError(
            f"unparseable selection spec {spec!r}; expected one of: full, "
            "leaves(<regex>), block_cyclic(<k>), peft(lora|prefix), "
            "moe_experts(<G>), rows(block=<R>,k=<K>)")
    kind, arg = m.group(1), m.group(2)
    if kind == "leaves":
        return leaves(arg)
    if kind == "block_cyclic":
        return block_cyclic(int(arg), phase_offset=phase_offset)
    if kind == "peft":
        return peft(arg)
    if kind == "moe_experts":
        return moe_experts(int(arg), phase_offset=phase_offset)
    if kind == "rows":
        rm = _ROWS_RE.match(arg.strip())
        if rm is None:
            raise ValueError(
                f"unparseable rows selection arguments {arg!r}; the "
                "canonical form is rows(block=<R>,k=<K>)")
        return rows(int(rm.group(1)), int(rm.group(2)),
                    phase_offset=phase_offset)
    raise ValueError(f"unknown selection kind {kind!r}; "
                     f"available: {SELECTION_KINDS}")


def resolve_selection(
        selection: Union[None, str, Selection]) -> Optional[Selection]:
    """Normalize an estimator factory's ``selection=``: ``None`` and the
    full selection (object or ``"full"``) become ``None`` — the default
    path, unchanged — and spec strings are parsed."""
    if selection is None:
        return None
    if isinstance(selection, str):
        selection = parse_selection(selection)
    if not isinstance(selection, Selection):
        raise TypeError(f"selection must be a repro_torch.select.Selection "
                        f"or spec string, got {type(selection).__name__}")
    if selection.is_full() and selection.phase_offset == 0:
        return None
    return selection


# --------------------------------------------------------------------------- #
# Replay-coordinate check
# --------------------------------------------------------------------------- #
def check_replay_selection(recorded: Optional[str], active: Optional[str],
                           what: str,
                           recorded_phase: Optional[int] = None,
                           active_phase: Optional[int] = None) -> None:
    """Raise ``SelectionMismatchError`` if a recorded artifact's selection
    spec (or schedule phase offset) does not match the active optimizer's
    (``None`` on either side skips the check)."""
    if recorded is None or active is None:
        return
    rp = int(recorded_phase or 0)
    ap = int(active_phase or 0)
    if recorded != active or rp != ap:
        raise SelectionMismatchError(
            f"{what} was recorded under parameter selection {recorded!r} "
            f"(phase offset {rp}) but the active optimizer runs {active!r} "
            f"(phase offset {ap}); the selection decides which leaves each "
            "recorded scalar's rank-1 update touches, so replay would "
            "silently apply the updates to a different parameter support.  "
            f"Re-create the optimizer with selection={recorded!r} (e.g. "
            f"zo.mezo(..., selection={recorded!r})).")
