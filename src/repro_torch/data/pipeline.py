"""Deterministic, resumable data pipeline — the port of
``repro.data.pipeline``.

``pipeline.batch(step)`` is a pure function of (spec, step): no iterator
state exists, so checkpoints carry only the step counter and restarts are
exactly reproducible.  Kinds: ``lm`` (the step-indexed LM stream),
``prompt_cls`` (``PromptClassification``) and ``span``
(``SpanExtraction``).  Batches land on the card unless the pipeline is
built with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.data.synthetic import (PromptClassification,
                                        SpanExtraction, lm_batch)
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
        self.spec = spec
        self.device = resolve_device(device)
        if spec.kind == "prompt_cls":
            self.task = PromptClassification(vocab=spec.vocab or 256,
                                             n_classes=spec.n_classes,
                                             seed=spec.seed,
                                             prompt=spec.prompt)
        elif spec.kind == "span":
            self.task = SpanExtraction(vocab=spec.vocab or 256,
                                       seed=spec.seed)
        else:
            self.task = None

    def batch(self, step: int) -> dict:
        s = self.spec
        if s.kind == "lm":
            return lm_batch(s.seed, step, s.batch, s.seq, s.vocab,
                            self.device)
        return self.task.batch_for_step(step, s.batch, self.device)

    @property
    def seq_len(self) -> int:
        return self.spec.seq if self.spec.kind == "lm" else self.task.seq_len
