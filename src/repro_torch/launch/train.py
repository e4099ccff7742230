"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``, with its flags for what the port
supports plus ``--device``: registry model (random weights from a seeded
``torch.Generator``), MeZO through ``zo.mezo`` (spsa / one_point) or
``zo.fzoo``, or the backprop baselines (``--optimizer adam|sgd``,
``train.adam``: the local plan, checkpoints, no ledger), the local or
seed-parallel plan (on one card), step-indexed data, checkpoint manager +
scalar ledger, heartbeat.

``--backend`` defaults to ``xla`` as in JAX (the threefry stream, X1 on the
card); ``pallas`` is the counter stream.  ``--optimizer mezo-adam`` trains
``zo.mezo_adam`` (the recomputed ring-buffer mode; no ledger, as in JAX:
its steps replay only from a full checkpoint).  ``--select`` takes every
selection spec of
``repro_torch.select`` (``auto`` → the registry's per-family default) and is
recorded in the checkpoint meta and the MZOL5 ledger header.  The ported
families are dense, moe and ssm: ``--model-family moe`` (mixtral-8x7b, or
``--arch granite-moe-3b-a800m``) trains the mixture of experts,
``--expert-groups G`` splitting its experts into G leaf groups for
``--select moe_experts(G)`` (``auto`` picks it); ``--model-family ssm``
(or ``--arch rwkv6-3b``) trains rwkv6, ``--scan-mode`` picks its forward
(``chunk``, K11 on the card, or ``fused_recurrent``).  ``--arch`` takes every ported config
(the paper's OPT-13B/30B/66B and RoBERTa-large among them), and
``--objective`` every entry of ``OBJECTIVES``: the non-differentiable
``accuracy`` / ``f1`` train through the ZO optimizers only.  The data is
the ``lm`` stream, as in JAX's launcher.  The refusals are JAX's, in its
order (``--objective`` other than ``ce``, ``--select`` other than ``full``
and ``--exec-plan seed_parallel`` need a ZO optimizer); options of later
slices (``--model-family hybrid|encdec``) exit with a message naming the
slice.
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
from repro_torch.models import FAMILY_ARCHS, OBJECTIVES, all_archs, bundle
from repro_torch.train.adam import Adam, AdamConfig
from repro_torch.train.loop import HeartbeatMonitor, train
from repro_torch.tree_utils import tree_leaves

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--model-family", default=None,
                    choices=["dense", "moe", "ssm", "hybrid", "encdec"],
                    help="architecture family: its representative arch "
                         "(the port has dense, moe and ssm)")
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
                    help="perturbation backend: 'xla' (JAX's default, the "
                         "threefry stream) or 'pallas' (the counter stream)")
    ap.add_argument("--select", default="full",
                    help="parameter selection (repro_torch.select) for the ZO "
                         "optimizers: 'full', 'leaves(<regex>)', "
                         "'block_cyclic(<k>)' (rotating leaf blocks, ~1/k of "
                         "the tree perturbed per step), "
                         "'rows(block=<R>,k=<K>)' (row-blocks of R rows "
                         "inside every leaf, ~1/K of each tensor per step), "
                         "'peft(lora|prefix)' for a merged PEFT tree, "
                         "'moe_experts(<G>)' (router frozen, one expert "
                         "group per step; needs --expert-groups G), or "
                         "'auto' for the registry's "
                         "per-family default; recorded in ckpt meta + the "
                         "MZOL5 ledger header")
    ap.add_argument("--objective", default="ce", choices=list(OBJECTIVES),
                    help="training objective: 'ce' (cross-entropy) or the "
                         "non-differentiable 'accuracy'/'f1' metrics (paper "
                         "§3.3) — zero gradient a.e., so they require a ZO "
                         "optimizer (--optimizer mezo)")
    ap.add_argument("--expert-groups", type=int, default=None,
                    help="MoE only: split the expert tensors into G leaf "
                         "groups (cfg.expert_groups) so moe_experts(G) "
                         "selection can cycle one group per step")
    ap.add_argument("--scan-mode", default=None,
                    choices=["chunk", "fused_recurrent"],
                    help="ssm forward mode: 'chunk' (chunked WKV, K11 on the "
                         "card; the default) or 'fused_recurrent' (the exact "
                         "per-token recurrence)")
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

    if args.objective != "ce" and args.optimizer not in ("mezo", "mezo-adam"):
        # argmax metrics have zero gradient a.e. — backprop would "train"
        # without ever changing the loss; refuse instead of silently stalling
        sys.exit(f"--objective {args.objective!r} is "
                 "non-differentiable and needs a ZO optimizer "
                 f"(--optimizer mezo); got {args.optimizer!r}")
    if args.select != "full" and args.optimizer != "mezo":
        # every other optimizer would train the full tree (adam/sgd have no
        # selection support; mezo-adam's applier transform refuses
        # selections at composition time)
        sys.exit(f"--select {args.select!r} requires --optimizer mezo "
                 f"(got {args.optimizer!r})")
    if args.model_family is not None and args.model_family not in FAMILY_ARCHS:
        sys.exit(f"--model-family {args.model_family}: the other families "
                 "come with the families slice (ROADMAP Queue 1, Slice D); "
                 f"the port has {', '.join(sorted(FAMILY_ARCHS))}")
    if args.backend == "pallas-interpret":
        sys.exit("--backend pallas-interpret is JAX's CPU interpreter; the "
                 "port runs --backend pallas, on the CPU with --device cpu")
    device = resolve_device(args.device)
    if args.model_family is not None:
        args.arch = FAMILY_ARCHS[args.model_family]
    archs = all_archs()
    if args.arch not in archs:
        sys.exit(f"--arch {args.arch!r} is not a ported config; the port "
                 f"has {', '.join(sorted(archs))}")
    arch = archs[args.arch]
    cfg = arch.smoke_cfg if args.smoke else arch.cfg
    if args.expert_groups is not None:
        if not cfg.n_experts:
            sys.exit(f"--expert-groups needs an MoE arch (got {args.arch!r}, "
                     f"family {cfg.family!r})")
        cfg = cfg.replace(expert_groups=args.expert_groups)
    if args.scan_mode is not None:
        cfg = cfg.replace(scan_mode=args.scan_mode)
    b = bundle(cfg)
    if args.select == "auto":
        # the registry's per-family default (moe: expert-wise cycling with
        # the router frozen; dense and ssm: full)
        args.select = b.default_selection()
        print(f"[train] --select auto -> {args.select!r}")
    params = b.init(args.seed, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f} M params "
          f"(analytic {cfg.n_params() / 1e6:.1f} M, "
          f"{cfg.n_active_params() / 1e6:.1f} M active), "
          f"optimizer={args.optimizer}, objective={args.objective}, "
          f"device={device}")

    pipe = Pipeline(DataSpec("lm", batch=args.batch, seq=args.seq,
                             vocab=cfg.vocab_size, seed=args.seed),
                    device=device)
    ledger = None
    if args.optimizer == "adam":
        opt = Adam(AdamConfig(lr=args.lr or 1e-4, total_steps=args.steps))
    elif args.optimizer == "sgd":
        opt = Adam(AdamConfig(lr=args.lr or 1e-3, sgd=True,
                              total_steps=args.steps))
    elif args.optimizer == "mezo-adam":
        opt = zo.mezo_adam(lr=args.lr or 1e-4, eps=args.eps,
                           backend=args.backend)
    elif args.estimator == "fzoo":
        opt = zo.fzoo(lr=args.lr or 1e-6, eps=args.eps,
                      batch_seeds=args.batch_seeds, backend=args.backend,
                      selection=args.select)
    else:
        opt = zo.mezo(lr=args.lr or 1e-5, eps=args.eps,
                      estimator=args.estimator, backend=args.backend,
                      selection=args.select)
    if args.select != "full":
        print(f"[train] parameter selection: {opt.selection_spec}")
    if args.optimizer == "mezo":
        ledger = TrajectoryLedger(base_seed=args.seed, grad_dtype="float32",
                                  backend=opt.backend_name,
                                  batch_seeds=opt.batch_seeds,
                                  selection=opt.selection_spec,
                                  sel_phase=opt.selection_phase)
    if args.exec_plan == "seed_parallel":
        if args.optimizer != "mezo":
            sys.exit("--exec-plan seed_parallel needs a seed-replayable ZO "
                     "optimizer (--optimizer mezo, any --estimator)")
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
    if ledger is not None:
        print(f"[train] ledger: {len(ledger)} entries, "
              f"{ledger.nbytes()} bytes")


if __name__ == "__main__":
    main()
