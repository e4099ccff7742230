"""``repro_torch.distributed`` — the port of ``repro.distributed``: the
sharding rule engine (``sharding``), MeZO's scalar collectives and the
seed-parallel surface (``collectives``), and bounded-staleness async workers
(``async_zo``)."""
from repro_torch.distributed.sharding import (batch_axes, infer_batch_spec,
                                              infer_param_spec,
                                              make_activation_resolver,
                                              param_shardings, param_specs,
                                              tp_axes)

__all__ = ["infer_param_spec", "infer_batch_spec", "param_specs",
           "param_shardings", "make_activation_resolver", "batch_axes",
           "tp_axes"]
