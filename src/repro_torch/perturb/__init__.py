"""``repro_torch.perturb`` — the z-stream identity and the perturbation
backends: ``xla`` (JAX's default, the threefry-normal stream, through the
X1 kernel) and ``pallas`` (the counter-hash stream of the zo_fused kernels,
stream id ``pallas+z2``; ``PallasBackend`` is JAX's name for
``CounterBackend``, the same class).  New backends register with
``register_backend`` and are reached by name through ``get_backend`` and
every ``backend=`` keyword."""
import os

from repro_torch.perturb.base import (BackendMismatchError, PerturbBackend,
                                      check_replay_backend, per_stream_scales)
from repro_torch.perturb.counter import CounterBackend
from repro_torch.perturb.stream import (StreamRef, as_stream_ref, prng_key,
                                        step_key)
from repro_torch.perturb.xla import XLABackend

PallasBackend = CounterBackend

#: why ``"pallas-interpret"`` and ``PallasBackend(interpret=True)`` refuse
INTERPRET_REFUSAL = (
    "'pallas-interpret' is JAX's CPU interpreter of the TPU kernel and has "
    "no meaning in the port: pass backend='pallas' and put the parameters "
    "on the CPU (device='cpu') to run the kernels' plain torch versions")

_FACTORIES: dict = {}
_INSTANCES: dict = {}


def register_backend(name: str, factory) -> None:
    """Register ``factory()`` (a ``PerturbBackend`` class or a function
    returning one) under ``name``; a cached instance of that name is
    dropped, as in JAX."""
    _FACTORIES[name] = factory
    _INSTANCES.pop(name, None)


register_backend("xla", XLABackend)
register_backend("pallas", CounterBackend)


def available_backends() -> list:
    return sorted(_FACTORIES)


def get_backend(spec=None) -> PerturbBackend:
    """Resolve a backend as ``repro.perturb.get_backend`` does: ``None`` →
    the ``REPRO_BACKEND`` environment variable, falling back to ``"xla"``;
    a string → the registry; an instance → itself (one cached instance per
    name).  ``"pallas-interpret"`` (JAX's CPU interpreter of the TPU kernel)
    has no meaning here: the plain torch versions run for CPU tensors."""
    if spec is None:
        spec = os.environ.get("REPRO_BACKEND") or "xla"
    if isinstance(spec, PerturbBackend):
        return spec
    if spec == "pallas-interpret" and spec not in _FACTORIES:
        raise ValueError(INTERPRET_REFUSAL)
    if spec not in _FACTORIES:
        raise KeyError(f"unknown perturbation backend {spec!r}; available: "
                       f"{available_backends()}")
    if spec not in _INSTANCES:
        _INSTANCES[spec] = _FACTORIES[spec]()
    return _INSTANCES[spec]


__all__ = ["BackendMismatchError", "CounterBackend", "PallasBackend",
           "PerturbBackend", "StreamRef", "XLABackend", "as_stream_ref",
           "available_backends", "check_replay_backend", "get_backend",
           "per_stream_scales", "prng_key", "register_backend", "step_key"]
