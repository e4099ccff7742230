"""``repro_torch.perturb`` — the z-stream identity and the perturbation
backends: ``xla`` (JAX's default, the threefry-normal stream, through the
X1 kernel) and ``pallas`` (the counter-hash stream of the zo_fused kernels,
stream id ``pallas+z2``)."""
import os

from repro_torch.perturb.base import (BackendMismatchError, PerturbBackend,
                                      check_replay_backend, per_stream_scales)
from repro_torch.perturb.counter import CounterBackend
from repro_torch.perturb.stream import StreamRef, prng_key, step_key
from repro_torch.perturb.xla import XLABackend

_FACTORIES = {"xla": XLABackend, "pallas": CounterBackend}
_INSTANCES: dict = {}


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
    if spec == "pallas-interpret":
        raise ValueError(
            "'pallas-interpret' is JAX's CPU interpreter of the TPU kernel "
            "and has no meaning in the port: pass backend='pallas' and put "
            "the parameters on the CPU (device='cpu') to run the kernels' "
            "plain torch versions")
    if spec not in _FACTORIES:
        raise KeyError(f"unknown perturbation backend {spec!r}; available: "
                       f"{available_backends()}")
    if spec not in _INSTANCES:
        _INSTANCES[spec] = _FACTORIES[spec]()
    return _INSTANCES[spec]


__all__ = ["BackendMismatchError", "CounterBackend", "PerturbBackend",
           "StreamRef", "XLABackend", "available_backends",
           "check_replay_backend", "get_backend", "per_stream_scales",
           "prng_key", "step_key"]
