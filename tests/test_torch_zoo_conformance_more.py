"""The port's conformance matrix (``test_torch_zoo_conformance.py``) on
its encdec and hybrid cells: spsa / fzoo × ``xla`` / ``pallas`` on the
smoke configs in f32 on the CPU — ``seed_parallel(1)`` ≡ ``local``
bitwise, the ledger's round trip, replay within 2e-6 of live, replays
bitwise equal.  The fzoo × ``xla`` cells carry JAX's ``slow`` mark.
"""
import pytest
torch = pytest.importorskip("torch")

from test_torch_zoo_conformance import (FAMILIES, _cells,
                                        check_family_conformance)


@pytest.mark.parametrize("fam,estimator,backend", _cells(FAMILIES[3:]))
def test_family_conformance(fam, estimator, backend):
    check_family_conformance(fam, estimator, backend)
