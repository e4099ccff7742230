"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``, with its flags for what the port
supports plus ``--device``: registry model (random weights from a seeded
``torch.Generator``), MeZO through ``zo.mezo`` (spsa / one_point) or
``zo.fzoo``, the local or seed-parallel plan (on one card), step-indexed
data, checkpoint manager + scalar ledger, heartbeat.

``--backend`` defaults to ``xla`` as in JAX, and that stream is not ported
yet: pass ``--backend pallas``.  Options of later slices (``--optimizer
mezo-adam|adam|sgd``, ``--select`` other than ``full``, ``--objective``
other than ``ce``, ``--model-family`` other than ``dense``) exit with a
message naming the slice.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import exec as zexec
from repro_torch import zo
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import TrajectoryLedger
from repro_torch.data.pipeline import DataSpec, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import all_archs, bundle
from repro_torch.train.loop import HeartbeatMonitor, train
from repro_torch.tree_utils import tree_leaves

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--model-family", default=None,
                    choices=["dense", "moe", "ssm", "hybrid", "encdec"],
                    help="architecture family (the port has dense)")
    ap.add_argument("--optimizer", default="mezo",
                    choices=["mezo", "mezo-adam", "adam", "sgd"])
    ap.add_argument("--estimator", default="spsa",
                    choices=["spsa", "one_point", "fzoo"])
    ap.add_argument("--batch-seeds", type=int, default=8,
                    help="seed streams per step for --estimator fzoo")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "pallas", "pallas-interpret"],
                    help="perturbation backend; the port has 'pallas' (the "
                         "counter stream) — 'xla', JAX's default, comes with "
                         "a later slice")
    ap.add_argument("--select", default="full")
    ap.add_argument("--objective", default="ce",
                    choices=["ce", "accuracy", "f1"])
    ap.add_argument("--exec-plan", default="local",
                    choices=["local", "seed_parallel"])
    ap.add_argument("--n-groups", type=int, default=1,
                    help="seed groups per step for --exec-plan seed_parallel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain torch versions of the kernels)")
    args = ap.parse_args(argv)

    if args.optimizer != "mezo":
        sys.exit(f"--optimizer {args.optimizer}: mezo-adam comes with the "
                 "mezo_adam slice and adam/sgd with the backprop-baseline "
                 "slice (ROADMAP Queue 1); the port trains --optimizer mezo")
    if args.select != "full":
        sys.exit(f"--select {args.select!r}: parameter selections come with "
                 "the selection slice (ROADMAP Queue 1, Slice C)")
    if args.objective != "ce":
        sys.exit(f"--objective {args.objective!r}: the non-differentiable "
                 "objectives come with the objectives slice (core/nondiff)")
    if args.model_family not in (None, "dense"):
        sys.exit(f"--model-family {args.model_family}: the other families "
                 "come with the families slice (ROADMAP Queue 1, Slice D)")
    if args.backend == "xla":
        sys.exit("--backend xla (the default, as in JAX): the threefry "
                 "'xla' stream comes with a later slice of the port; pass "
                 "--backend pallas")
    if args.backend == "pallas-interpret":
        sys.exit("--backend pallas-interpret is JAX's CPU interpreter; the "
                 "port runs --backend pallas, on the CPU with --device cpu")
    device = resolve_device(args.device)
    arch = all_archs()[args.arch]
    cfg = arch.smoke_cfg if args.smoke else arch.cfg
    b = bundle(cfg)
    params = b.init(args.seed, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f} M params, "
          f"optimizer={args.optimizer}, device={device}")

    pipe = Pipeline(DataSpec("lm", batch=args.batch, seq=args.seq,
                             vocab=cfg.vocab_size, seed=args.seed),
                    device=device)
    if args.estimator == "fzoo":
        opt = zo.fzoo(lr=args.lr or 1e-6, eps=args.eps,
                      batch_seeds=args.batch_seeds, backend=args.backend)
    else:
        opt = zo.mezo(lr=args.lr or 1e-5, eps=args.eps,
                      estimator=args.estimator, backend=args.backend)
    ledger = TrajectoryLedger(base_seed=args.seed, grad_dtype="float32",
                              backend=opt.backend_name,
                              batch_seeds=opt.batch_seeds)
    if args.exec_plan == "seed_parallel":
        if args.batch % args.n_groups:
            sys.exit(f"--batch {args.batch} must divide evenly into "
                     f"--n-groups {args.n_groups} slices")
        opt = zexec.StepProgram(opt, zexec.seed_parallel(args.n_groups))
        print(f"[train] exec plan: seed_parallel(n_groups={args.n_groups})")

    ckpt = (CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
            if args.ckpt_dir else None)
    res = train(b.loss_fn(objective=args.objective), params, opt, pipe,
                total_steps=args.steps, ckpt=ckpt, ledger=ledger,
                monitor=HeartbeatMonitor(),
                log_every=max(args.steps // 10, 1), verbose=True,
                seed=args.seed)
    print(f"[train] done: {res.steps_run} steps "
          f"(resumed from {res.resumed_from}); "
          f"final loss {res.losses[-1][1]:.4f}")
    print(f"[train] ledger: {len(ledger)} entries, {ledger.nbytes()} bytes")


if __name__ == "__main__":
    main()
