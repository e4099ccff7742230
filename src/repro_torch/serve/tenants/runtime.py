"""The tenants runtime — so far ``composition_for_ledger``, which the serving
launcher uses to replay a ledger; the adapter store, delta cache and
compaction come with the tenants slice."""
from __future__ import annotations


def composition_for_ledger(led):
    """The ZO composition whose replay reproduces ``led``'s run, rebuilt from
    the header coordinates alone, as ``repro.serve.tenants`` does.

    The header's ``backend`` is the stream id (``"pallas+z2"``) while the
    factories take the registry name, so the ``+zN`` suffix is stripped for
    construction; ``check_replay_backend`` still compares full stream ids at
    replay time.  ``batch_seeds > 1`` → ``fzoo(batch_seeds=B)``, else
    ``mezo``; ``StepProgram.replay`` on the replay plan adopts the ledger's
    ``n_groups``.  A non-full selection is refused (the selection slice)."""
    from repro_torch import zo
    from repro_torch.select import resolve_selection
    if led.sel_phase:
        raise NotImplementedError(
            f"ledger selection {led.selection!r} with phase offset "
            f"{led.sel_phase} is ported with the selection slice")
    resolve_selection(led.selection)
    backend = led.backend.partition("+z")[0]
    if led.batch_seeds > 1:
        return zo.fzoo(batch_seeds=led.batch_seeds, backend=backend)
    return zo.mezo(backend=backend)
