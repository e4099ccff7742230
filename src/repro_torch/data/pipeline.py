"""Deterministic, resumable data pipeline — the port of
``repro.data.pipeline``.

``pipeline.batch(step)`` is a pure function of (spec, step): no iterator
state exists, so checkpoints carry only the step counter and restarts are
exactly reproducible.  The ``lm`` kind is ported; the prompt-classification
and span tasks come with the objectives slice.  Batches land on the card
unless the pipeline is built with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.data.synthetic import lm_batch
from repro_torch.device import DeviceSpec, resolve_device


@dataclasses.dataclass(frozen=True)
class DataSpec:
    kind: str                   # "lm" | "prompt_cls" | "span"
    batch: int
    seq: int = 0
    vocab: int = 0
    seed: int = 0
    n_classes: int = 2
    prompt: bool = True


class Pipeline:
    def __init__(self, spec: DataSpec, device: DeviceSpec = None):
        if spec.kind != "lm":
            raise NotImplementedError(
                f"data kind {spec.kind!r} is ported with the objectives "
                "slice; this slice has the step-indexed 'lm' stream")
        self.spec = spec
        self.device = resolve_device(device)

    def batch(self, step: int) -> dict:
        s = self.spec
        return lm_batch(s.seed, step, s.batch, s.seq, s.vocab, self.device)

    @property
    def seq_len(self) -> int:
        return self.spec.seq
