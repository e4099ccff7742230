"""The one primitive every ZO consumer shares: the seeded rank-1 update —
the port of ``repro.zo.updates``.

A zeroth-order step is fully described by scalars — ``(key, coeff, decay)``
with ``coeff = η·g`` — because the direction z is a pure function of the
PRNG key (paper §2.1).  ``apply_rank1`` / ``apply_rank1_batch`` are the code
paths through which live steps and ledger replay both write parameters:

    θ ← (1 − decay) · θ − coeff · z(key)

so a replay performs the identical arithmetic (same f32 scalars, same
backend kernel) as the live step.  Writes go in place.
"""
from __future__ import annotations

import numpy as np

from repro_torch.perturb import StreamRef, get_backend
from repro_torch.perturb.stream import Key, fold_in
from repro_torch.select import resolve_selection
from repro_torch.tree_utils import PyTree

f32 = np.float32


def apply_rank1(params: PyTree, key: Key, coeff, decay_term=0.0,
                dist: str = "gaussian", d_tree=None, backend=None,
                selection=None, phase: int = 0) -> PyTree:
    """θ ← (1 − decay_term)·θ − coeff·z(key), in place.  ``coeff`` is the
    full η-scaled scalar, ``decay_term`` the decoupled η·λ;
    ``selection``/``phase`` scope the update to a parameter subset."""
    ref = StreamRef(key, resolve_selection(selection), phase)
    return get_backend(backend).apply_rank1(params, ref, coeff, decay_term,
                                            dist, d_tree=d_tree)


def apply_rank1_batch(params: PyTree, skey: Key, coeff_vec, decay_term=0.0,
                      dist: str = "gaussian", backend=None, selection=None,
                      phase: int = 0) -> PyTree:
    """The batched-seed (FZOO) step as B chained rank-1 applications:

        for j in 0..B-1:  θ ← (1 − [j==0]·decay)·θ − (coeff_j / B)·z(fold(skey, j))

    handed to the backend as ONE ``affine_many`` call (K3 on the card).
    ``coeff_j / B`` is one f32 division, as in JAX.  Shared by the live fzoo
    update and ``ZOOptimizer.replay_update``, so a ledger entry replays the
    recorded step's arithmetic exactly.  ``selection``/``phase`` scope every
    stream to the same parameter subset (a step has one phase)."""
    sel = resolve_selection(selection)
    be = get_backend(backend)
    coeff_vec = np.asarray(coeff_vec, f32)
    if coeff_vec.ndim != 1:
        raise ValueError(f"apply_rank1_batch needs a (B,) coefficient "
                         f"vector; got shape {coeff_vec.shape}")
    n = coeff_vec.shape[0]
    refs = [StreamRef(fold_in(skey, j), sel, phase) for j in range(n)]
    coeffs = [f32(coeff_vec[j] / f32(n)) for j in range(n)]
    decays = [decay_term if j == 0 else 0.0 for j in range(n)]
    return be.affine_many(params, refs, coeffs, decays, dist)
