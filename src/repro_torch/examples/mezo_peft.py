"""MeZO × PEFT on the unified selection path (paper §3 / App. E.5): the
frozen base and the PEFT tree ride in ONE merged parameter tree
(``peft.peft_params``) and a ``repro_torch.select.peft(mode)`` selection
scopes the optimizer to the PEFT subtree — the base leaves are never
perturbed, never updated, never decayed (asserted below) — the port of
``examples/mezo_peft.py``.

Also demonstrates the paper's App. F.3 observation: MeZO's convergence rate
is roughly independent of the number of tuned parameters (full vs LoRA vs
prefix), supporting the effective-rank theory.

    PYTHONPATH=src python -m repro_torch.examples.mezo_peft [--device cpu]
"""
import argparse

import torch

from repro_torch import select, zo
from repro_torch.data.synthetic import PromptClassification
from repro_torch.device import resolve_device
from repro_torch.models import bundle, peft
from repro_torch.models.config import ModelConfig
from repro_torch.perturb.stream import prng_key
from repro_torch.tree_utils import tree_clone, tree_max_abs_diff, tree_size

STEPS = 500
BATCH = 32


def run_variant(name, task, loss_fn, tree0, lr, eps, dev, selection=None):
    opt = zo.mezo(lr=lr, eps=eps, selection=selection)
    state = opt.init(tree0, seed=0)
    step = opt.step_fn(loss_fn)
    t = tree_clone(tree0)                  # the step writes its tree in place
    losses = []
    for s in range(STEPS):
        t, state, m = step(t, state, task.batch_for_step(s, BATCH,
                                                         device=dev))
        if s % 50 == 0:
            losses.append(float(m["loss"]))
    sel = opt.selection
    tuned = (tree_size(tree0) if sel is None
             else sel.selected_size(tree0))
    print(f"{name:12s} tuned={tuned:8d}/{tree_size(tree0):8d}  "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return t


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = ModelConfig(name="peft-lm", family="dense", n_layers=3, d_model=96,
                      n_heads=4, n_kv_heads=2, d_ff=192, vocab_size=256,
                      max_seq=64, dtype="float32")
    task = PromptClassification(vocab=cfg.vocab_size, n_classes=2, seed=0)
    b = bundle(cfg)
    base = b.init(0, device=dev)

    print("== MeZO full-parameter ==")
    run_variant("full", task, b.loss_fn(), base, 2e-4, 1e-3, dev)

    print("== MeZO block-cyclic(4): ~1/4 of the tree perturbed per step ==")
    run_variant("block_cyc4", task, b.loss_fn(), base, 2e-4, 1e-3, dev,
                selection=select.block_cyclic(4))

    print("== MeZO (LoRA r=8, merged tree + peft selection) ==")
    lora0 = peft.init_lora(cfg, prng_key(1), device=dev)
    merged = peft.peft_params(base, lora0, "lora")
    out = run_variant("lora", task, peft.peft_loss_fn(cfg, "lora"), merged,
                      1e-3, 1e-3, dev, selection=select.peft("lora"))
    assert tree_max_abs_diff(out["base"], base) == 0.0, \
        "selection must leave the frozen base bitwise-untouched"

    print("== MeZO (prefix m=5, real-activation init, merged tree) ==")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    pre0 = peft.init_prefix_from_tokens(cfg, base, gen, m=5)
    merged = peft.peft_params(base, pre0, "prefix")
    out = run_variant("prefix", task, peft.peft_loss_fn(cfg, "prefix"),
                      merged, 5e-3, 1e-1, dev, selection=select.peft("prefix"))
    assert tree_max_abs_diff(out["base"], base) == 0.0
    print("(paper App. F.3: similar convergence despite 100-1000x fewer "
          "params; base tree bitwise-frozen by the selection)")


if __name__ == "__main__":
    main()
