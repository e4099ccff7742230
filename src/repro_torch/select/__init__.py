"""Parameter selection — so far the replay identity check of
``repro.select`` and ``resolve_selection`` for the full tree; the other
selections come with the selection slice."""
from __future__ import annotations

from typing import Optional


class SelectionMismatchError(RuntimeError):
    """A seed-replay artifact was recorded under one parameter selection and
    is being replayed under another; the updates would land on a different
    parameter support — refuse instead."""


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


def resolve_selection(selection) -> None:
    """``None`` or ``"full"`` → ``None`` (the full tree, as
    ``repro.select.resolve_selection`` normalizes it); any other selection
    is refused until the selection slice ports it."""
    if selection is None or selection == "full":
        return None
    spec = getattr(selection, "spec", selection)
    raise NotImplementedError(
        f"parameter selection {spec!r} is ported with the selection slice "
        "(ROADMAP Queue 1, Slice C); the port trains the full tree only")
