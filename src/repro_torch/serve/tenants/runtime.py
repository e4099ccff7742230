"""The tenants runtime — so far ``composition_for_ledger``, which the serving
launcher uses to replay a ledger (any selection); the adapter store, delta
cache and compaction come with the tenants slice."""
from __future__ import annotations


def composition_for_ledger(led):
    """The ZO composition whose replay reproduces ``led``'s run, rebuilt from
    the header coordinates alone, as ``repro.serve.tenants`` does.

    The header's ``backend`` is the stream id (``"pallas+z2"``) while the
    factories take the registry name, so the ``+zN`` suffix is stripped for
    construction; ``check_replay_backend`` still compares full stream ids at
    replay time.  ``batch_seeds > 1`` → ``fzoo(batch_seeds=B)``, else
    ``mezo``; ``StepProgram.replay`` on the replay plan adopts the ledger's
    ``n_groups``.  A non-full selection is rebuilt from the MZOL5 header's
    spec and phase offset, so every record replays at its step's phase."""
    from repro_torch import zo
    sel = None
    if led.selection != "full" or led.sel_phase:
        from repro_torch.select import parse_selection
        sel = parse_selection(led.selection)._replace(
            phase_offset=int(led.sel_phase))
    backend = led.backend.partition("+z")[0]
    if led.batch_seeds > 1:
        return zo.fzoo(batch_seeds=led.batch_seeds, backend=backend,
                       selection=sel)
    return zo.mezo(backend=backend, selection=sel)
