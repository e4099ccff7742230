"""The tenants runtime — so far ``composition_for_ledger``, which the serving
launcher uses to replay a ledger; the adapter store, delta cache and
compaction come with the tenants slice."""
from __future__ import annotations


def composition_for_ledger(led):
    """The ZO composition whose replay reproduces ``led``'s run, rebuilt from
    the header coordinates alone (as ``repro.serve.tenants`` does).

    The port has one backend so far, the counter stream (``pallas+z2``), and
    single-stream full-selection replay, so it always builds
    ``mezo(backend="pallas")``; a ledger recorded under another backend,
    selection or seed count is then refused by ``StepProgram.replay`` with
    JAX's error (``BackendMismatchError`` / ``SelectionMismatchError`` /
    ``ValueError``) rather than replayed wrong."""
    from repro_torch import zo
    return zo.mezo(backend="pallas")
