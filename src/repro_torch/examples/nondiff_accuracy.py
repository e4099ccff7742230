"""Non-differentiable objectives (paper §3.3 / Table 3): MeZO directly
maximizes ACCURACY (argmax-based, zero gradient a.e.) and span-F1 — things
backpropagation cannot optimize — the port of
``examples/nondiff_accuracy.py``.

    PYTHONPATH=src python -m repro_torch.examples.nondiff_accuracy \\
        [--device cpu]
"""
import argparse

import torch

from repro_torch import zo
from repro_torch.core.nondiff import negative_accuracy
from repro_torch.data.synthetic import PromptClassification
from repro_torch.device import resolve_device
from repro_torch.models import bundle, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.perturb.stream import prng_key

STEPS = 500
BATCH = 128   # accuracy is a step function: large batches + larger eps
              # make the +/- eps evaluations differ often enough to learn

cfg = ModelConfig(name="nd-lm", family="dense", n_layers=3, d_model=96,
                  n_heads=4, n_kv_heads=2, d_ff=192, vocab_size=256,
                  max_seq=64, dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    task = PromptClassification(vocab=cfg.vocab_size, n_classes=2, seed=0)
    b = bundle(cfg)
    params = b.init(0, device=dev)
    words = task.label_word(torch.arange(task.n_classes)).to(dev)

    def logits_fn(p, batch):
        return transformer.forward(cfg, p, tokens=batch["tokens"]).logits

    def objective(p, batch):                       # -accuracy: a STEP function
        slot = logits_fn(p, batch)[:, task.body_len, :]
        return negative_accuracy(slot[:, words], batch["cls"])

    def accuracy(p):
        return task.eval_accuracy(cfg, logits_fn, p, prng_key(9), 512,
                                  device=dev)

    print(f"zero-shot accuracy: {accuracy(params):.3f}")
    print("optimizing ACCURACY directly (backprop would see zero gradient):")
    opt = zo.mezo(lr=5e-4, eps=2e-2)
    state = opt.init(params, seed=0)
    step = opt.step_fn(objective)
    for s in range(STEPS):
        params, state, m = step(params, state,
                                task.batch_for_step(s, BATCH, device=dev))
        if s % 100 == 0:
            print(f"  step {s:5d}  batch-accuracy {-float(m['loss']):.3f}")
    print(f"final accuracy: {accuracy(params):.3f}")


if __name__ == "__main__":
    main()
