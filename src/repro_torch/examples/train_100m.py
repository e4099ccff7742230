"""End-to-end training driver: a ~100 M-parameter LM trained with MeZO for a
few hundred steps through the full production stack — resumable step-indexed
data pipeline, checkpoint manager, MeZO scalar ledger, crash recovery — the
port of ``examples/train_100m.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --smoke \\
        --device cpu

Kill it mid-run and re-invoke: it resumes bitwise-exactly from the last full
checkpoint + ledger tail.
"""
import argparse

import torch

from repro_torch import exec as zexec
from repro_torch import select, zo
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import TrajectoryLedger
from repro_torch.data.pipeline import DataSpec, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import bundle
from repro_torch.models.config import ModelConfig
from repro_torch.train.loop import HeartbeatMonitor, train
from repro_torch.tree_utils import (flatten_with_path, is_floating,
                                    tree_clone, tree_leaves, tree_size)


def _assert_frozen_rows(loss_fn, params, opt, sel, batch):
    """One probe step before training: everything the phase-0 selection does
    NOT cover must be bitwise-frozen (no perturbation residue, no update, no
    decay) — the frozen-row guarantee sub-leaf ``rows(...)`` selections make.
    Cheap (one step on a copy of the initial params) and loud: a backend
    that wrote an unselected band would abort the run here, not corrupt
    it."""
    state = opt.init(params, seed=0)
    p1, _, _ = opt.step_fn(loss_fn)(tree_clone(params), state, batch)
    leaf_mask = sel.leaf_mask(params, 0)
    frozen = checked = 0
    for i, ((path, before), after) in enumerate(zip(
            flatten_with_path(params), tree_leaves(p1))):
        if not is_floating(before):
            continue
        b = before.reshape(-1)
        a = after.reshape(-1)
        if leaf_mask is not None and not leaf_mask[i]:
            m = torch.zeros(b.numel(), dtype=torch.bool, device=b.device)
        else:
            rb = sel.block_mask(before, phase=0)
            m = (torch.ones(b.numel(), dtype=torch.bool, device=b.device)
                 if rb is None else rb.element_mask(
                     torch.arange(b.numel(), device=b.device)).bool())
        checked += 1
        if (~m).any():
            assert torch.equal(a[~m], b[~m]), \
                f"unselected rows of {path} moved"
            frozen += int((~m).sum())
    print(f"frozen-row probe: {frozen} unselected elements bitwise-frozen "
          f"across {checked} leaves at phase 0")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + few steps (CI)")
    ap.add_argument("--ckpt-dir", default="/tmp/mezo_100m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--exec-plan", default="local",
                    choices=["local", "seed_parallel"],
                    help="execution plan (repro_torch.exec): seed_parallel "
                         "evaluates --n-groups seed groups on batch slices "
                         "at the step's center and averages the directions")
    ap.add_argument("--n-groups", type=int, default=1,
                    help="seed groups per step for --exec-plan seed_parallel")
    ap.add_argument("--select", default=None,
                    help="parameter selection spec (repro_torch.select), "
                         "e.g. 'block_cyclic(4)' or 'rows(block=256,k=4)' — "
                         "rows(...) perturbs ~1/k of every tensor per step "
                         "(sub-leaf tile skipping); recorded in the ledger "
                         "(MZOL5) and checkpoint meta")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.smoke:
        cfg = ModelConfig(name="lm-smoke", family="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                          vocab_size=512, max_seq=128, dtype="float32")
        args.steps = min(args.steps, 20)
    else:
        # ~100M params: 12L x d768 x ff3072, 16K vocab
        cfg = ModelConfig(name="lm-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                          vocab_size=16384, max_seq=1024, dtype="float32")

    b = bundle(cfg)
    params = b.init(0, device=dev)
    print(f"model {cfg.name}: {tree_size(params)/1e6:.1f} M params")

    pipe = Pipeline(DataSpec("lm", batch=args.batch, seq=args.seq,
                             vocab=cfg.vocab_size, seed=0), device=dev)
    sel = select.resolve_selection(args.select)
    opt = zo.mezo(lr=1e-5, eps=1e-3, selection=sel)
    if sel is not None:
        bytes_ph0 = sel.selected_bytes(params, phase=0)
        total = sum(x.numel() * x.element_size()
                    for x in tree_leaves(params))
        print(f"selection {sel.spec}: {bytes_ph0/1e6:.2f} MB perturbed at "
              f"phase 0 ({bytes_ph0/total:.1%} of {total/1e6:.1f} MB)")
        _assert_frozen_rows(b.loss_fn(), params, opt, sel, pipe.batch(0))
    if args.exec_plan == "seed_parallel":
        # the engine lowers the same optimizer onto the sliced-batch plan;
        # checkpoints/ledger record (exec_plan, n_groups) and a resume under
        # a different n_groups refuses instead of re-pairing seeds
        opt = zexec.StepProgram(opt, zexec.seed_parallel(args.n_groups))
        print(f"exec plan: seed_parallel(n_groups={args.n_groups})")
    ckpt = CheckpointManager(args.ckpt_dir, interval=50, keep=2)
    ledger = TrajectoryLedger(base_seed=0, grad_dtype="float32")

    result = train(b.loss_fn(), params, opt, pipe, total_steps=args.steps,
                   ckpt=ckpt, ledger=ledger, monitor=HeartbeatMonitor(),
                   log_every=20, verbose=True)
    print(f"ran {result.steps_run} steps (resumed from {result.resumed_from})")
    print(f"loss trajectory: {[f'{l:.3f}' for _, l in result.losses[:8]]} ...")
    print(f"ledger: {len(ledger)} scalar entries = {ledger.nbytes()} bytes "
          f"(the entire run, replayable)")
    print(f"checkpoints in {args.ckpt_dir}: steps {ckpt.steps()}")


if __name__ == "__main__":
    main()
