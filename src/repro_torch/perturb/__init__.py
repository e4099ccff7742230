"""``repro_torch.perturb`` — the z-stream identity and the perturbation
backend (the counter-hash stream of the zo_fused kernels, stream id
``pallas+z2``)."""
import os

from repro_torch.perturb.base import (BackendMismatchError, PerturbBackend,
                                      check_replay_backend, per_stream_scales)
from repro_torch.perturb.counter import CounterBackend
from repro_torch.perturb.stream import StreamRef, prng_key, step_key

_FACTORIES = {"pallas": CounterBackend}
_INSTANCES: dict = {}


def available_backends() -> list:
    return sorted(_FACTORIES)


def get_backend(spec=None) -> PerturbBackend:
    """Resolve a backend as ``repro.perturb.get_backend`` does: ``None`` →
    the ``REPRO_BACKEND`` environment variable, falling back to ``"xla"``;
    a string → the registry; an instance → itself (one cached instance per
    name).

    The port has the counter stream (``"pallas"``) only.  JAX's default,
    the threefry ``"xla"`` stream, arrives with a later slice: resolving to
    it raises rather than silently training on another stream than JAX
    would.  ``"pallas-interpret"`` (JAX's CPU interpreter of the TPU kernel)
    has no meaning here: the plain torch versions run for CPU tensors."""
    if spec is None:
        spec = os.environ.get("REPRO_BACKEND") or "xla"
    if isinstance(spec, PerturbBackend):
        return spec
    if spec == "xla":
        raise NotImplementedError(
            "the 'xla' perturbation backend (JAX's threefry-normal stream, "
            "the default when no backend is named and REPRO_BACKEND is "
            "unset) is not ported yet — it comes with a later slice of the "
            "port (ROADMAP Queue 1).  Pass backend='pallas' (or set "
            "REPRO_BACKEND=pallas) for the counter-hash stream 'pallas+z2', "
            "which the port runs bitwise-equal to JAX")
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
           "StreamRef", "available_backends", "check_replay_backend",
           "get_backend", "per_stream_scales", "prng_key", "step_key"]
