"""Quickstart: fine-tune a small LM with MeZO — two forward passes per step,
inference-grade memory — on a prompt-based classification task, and compare
against zero-shot and backprop-Adam FT (the paper's core comparison, scaled
to CPU) — the port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 600] \\
        [--device cpu]
"""
import argparse

from repro_torch import zo
from repro_torch.data.synthetic import PromptClassification
from repro_torch.device import resolve_device
from repro_torch.models import bundle, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.perturb.stream import prng_key
from repro_torch.train.adam import Adam, AdamConfig
from repro_torch.tree_utils import tree_clone


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ModelConfig(name="quickstart-lm", family="dense", n_layers=3,
                      d_model=96, n_heads=4, n_kv_heads=2, d_ff=192,
                      vocab_size=256, max_seq=64, dtype="float32")
    task = PromptClassification(vocab=cfg.vocab_size, n_classes=2, seed=0)
    b = bundle(cfg)
    params = b.init(0, device=dev)
    loss_fn = b.loss_fn()

    def logits_fn(p, batch):
        return transformer.forward(cfg, p, tokens=batch["tokens"]).logits

    def accuracy(p):
        return task.eval_accuracy(cfg, logits_fn, p, prng_key(99), 512,
                                  device=dev)

    print(f"zero-shot accuracy: {accuracy(params):.3f}")

    # ---- MeZO: Algorithm 1, in place ------------------------------------ #
    # zo.mezo composes spsa(eps) with the scalar transform chain; swap in
    # zo.mezo_adam / zo.mezo_rescaled (or your own estimator) freely.
    opt = zo.mezo(lr=2e-4, eps=1e-3)
    state = opt.init(params, seed=0)
    step = opt.step_fn(loss_fn)
    p = tree_clone(params)                 # the step writes its tree in place
    for s in range(args.steps):
        batch = task.batch_for_step(s, args.batch, device=dev)
        p, state, m = step(p, state, batch)
        if s % 100 == 0:
            print(f"  MeZO step {s:5d}  loss {float(m['loss']):.4f}  "
                  f"g {float(m['projected_grad']):+.3e}")
    print(f"MeZO accuracy after {args.steps} steps: {accuracy(p):.3f}")

    # ---- FT with Adam (needs grads + moments: the 12x-memory path) ------- #
    ft_steps = max(args.steps // 15, 20)
    adam = Adam(AdamConfig(lr=5e-3, total_steps=ft_steps))
    ast = adam.init(params)
    astep = adam.step_fn(loss_fn)
    pf = params
    for s in range(ft_steps):
        pf, ast, m = astep(pf, ast, task.batch_for_step(s, args.batch,
                                                        device=dev))
    print(f"FT(Adam) accuracy after {ft_steps} steps: {accuracy(pf):.3f}")
    print("(paper: MeZO approaches FT with many more but far cheaper steps)")


if __name__ == "__main__":
    main()
