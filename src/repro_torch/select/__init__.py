"""``repro_torch.select`` — the parameter-selection layer, the port of
``repro.select``: one ``Selection`` (a static leaf predicate plus an
optional per-step block schedule) threaded through the perturbation
backend, every estimator, the execution plans, the ledger and checkpoints.

>>> from repro_torch import select
>>> select.parse_selection("rows(block=256,k=4)").spec
'rows(block=256,k=4)'
>>> select.parse_selection("peft(lora)") == select.peft("lora")
True
"""
from repro_torch.select.base import (PEFT_MODES, SELECTION_KINDS, RowBlocks,
                                     Selection, SelectionMismatchError,
                                     block_cyclic, check_replay_selection,
                                     full, leaf_row_blocks, leaves,
                                     moe_experts, parse_selection, peft,
                                     resolve_selection, rows)

__all__ = [
    "PEFT_MODES", "SELECTION_KINDS", "RowBlocks", "Selection",
    "SelectionMismatchError", "block_cyclic", "check_replay_selection",
    "full", "leaf_row_blocks", "leaves", "moe_experts", "parse_selection",
    "peft", "resolve_selection", "rows",
]
