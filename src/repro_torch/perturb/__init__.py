"""``repro_torch.perturb`` — the z-stream identity and the perturbation
backend (the counter-hash stream of K1, stream id ``pallas+z2``)."""
from repro_torch.perturb.base import (BackendMismatchError, PerturbBackend,
                                      check_replay_backend)
from repro_torch.perturb.counter import CounterBackend
from repro_torch.perturb.stream import StreamRef, prng_key, step_key

_BACKENDS = {"pallas": CounterBackend}


def get_backend(spec=None) -> PerturbBackend:
    """``"pallas"`` (the JAX name of the counter stream, and the default) or
    a backend instance.  JAX's threefry ``xla`` stream comes with the
    multi-seed slice."""
    if isinstance(spec, PerturbBackend):
        return spec
    spec = spec or "pallas"
    if spec not in _BACKENDS:
        raise KeyError(f"unknown perturbation backend {spec!r}; available: "
                       f"{sorted(_BACKENDS)} (the threefry 'xla' stream is "
                       "ported with the multi-seed slice)")
    return _BACKENDS[spec]()


__all__ = ["BackendMismatchError", "CounterBackend", "PerturbBackend",
           "StreamRef", "check_replay_backend", "get_backend", "prng_key",
           "step_key"]
