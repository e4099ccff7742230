#!/usr/bin/env python3
"""Chip smoke of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py                  # from the root of a checkout; one card
    python3 chip_smoke.py --kernels-only   # build and check the kernels, stop
    python3 chip_smoke.py --parent DIR     # also time the parent's K1, K3-K7, K9-K11, X1
    python3 chip_smoke.py --phases u,t,w   # build, then only the named phases (j, q, u, t, w, x, y, z, dr, tp)

In order: prints the card's name and power limit; builds the eight CUDA
sources under ``src/repro_torch/kernels/*/csrc`` (one nvcc per source, in
parallel); holds every kernel against its plain torch version on the card —
K1 ``zo_affine``, K3 ``zo_affine_chain``, K4 ``zo_affine_multi``, K5
``zo_affine_batched`` (on both routes of the fan-out), K6 ``zo_sqnorm``
(one leaf, and many leaves in one ``zo_sqnorm_many`` call), the sub-leaf K7
``zo_affine_rows``, K8 ``zo_affine_multi_rows``, K9 ``zo_affine_chain_rows``,
K10 ``zo_sqnorm_rows`` (one leaf, and many in one ``zo_sqnorm_rows_many``
call) and K12 ``paged_gather`` bitwise, K1 and K3–K10 also
against fixtures that JAX computed (``tests/data``, K6 and K10 within
``SQNORM_RTOL``), K2 ``flash_attention`` and K11 ``wkv6_chunked`` (at
rwkv6-3b's head shapes on its tiled route, training and single-request
prefills, C ∈ {16, 9, 8, 1}, also against the JAX fixture)
within stated tolerances.  K2 is also held to its plain version at every
head dim of ``K2_SWEEP_HD`` (each mma instance, between two, past 256) in
f32, bf16 and f16, and on inputs it copies first (``+copy`` routes); K11 at
every head dim of ``K11_SWEEP_HD``.  ``zo_selftest`` runs every rewrite of
the z generator (``zo_stream.cuh``) against its specification over the
whole domain (any mismatch fails).  K7 and K9 are also held on both their
routes (a row-block of whole 16-byte vectors, or not), each launch counted
under its route; X1 ``zo_affine_threefry`` on all three of its routes
(``vector``, ``scalar``, ``bands``) and on launches whose counters cross
2^32, and its route for JAX's original threefry layout
(``zo_affine_threefry_original``: ``pairs`` — on its vector and scalar
launches — and ``bands``) against its plain version and the JAX fixture
``x1_original_golden.npz`` (odd and even word counts at every residue of
the half h against the vector grid, windows straddling the half, off the
grid, meeting or not, x and y misaligned, windows of virtual leaves past
2^32 − 1 words), timed beside the partitionable route in turns (with
``--parent``, beside the parent's kernel too), its ``bands`` route timed
under ``rows(block=1,k=4)``.  X1's pipe probes read each pipe's rate (ALU, IMAD, FP32; which
opcodes share one).  It then counts the SASS instructions per z by pipe of
K1, K3, the K4 / K5 fan-out, K6, K7, K9, K10 and X1, prints each one's
issue floor and pipe floor (``pipe_floor``: the busiest of the issue port
and the pipes, ALU and IMAD at 16 lanes), and times them through their C
entry points, and times K11 at the rwkv6-3b training shape and a
single-request prefill (CUDA-graph runs) — with ``--parent`` (a ``git
archive`` of the parent commit) the parent's K1, K3, K4, K5, K6, K7, K9,
K10 (K6 and K10 one call per leaf), K11 and X1 too, built with the same
flags, in turns, the parent's outputs and norms held bitwise to this
tree's — and times K2 at OPT-13b's head dim 128 beside one SDPA call.  Every K11 launch of the
counted paths must take the tiled route, every K4 / K5 launch the vector
route, every K7 / K9 launch on a qwen2 leaf whose row-block is a whole
number of 16-byte vectors the vector route, and every X1 launch the vector
route but those of phase (dr)'s ``train_100m`` example, whose sub-leaf
``rows(...)`` selection takes the bands route.  Then it
drives the port's paths at the full width of qwen2-0.5b (random bf16
weights from a seeded ``torch.Generator``, all 24 layers, ``pallas_flash``
attention), each with the launch counts set to 0 just before it and read
just after:

* serve: replay an in-process ``pallas+z2`` ledger (K1) and serve a
  shared-template workload through the paged engine (K2, K12);
* train, through ``repro_torch.train.loop.train`` with a ledger and a
  checkpoint directory, on 16 × 256-token batches: (a) ``mezo`` spsa (K1,
  K2), (b) ``fzoo(batch_seeds=8)`` (K5, K3, K2), (c) ``fzoo(batch_seeds=8,
  dist="sphere")`` (K6, K4, K3, K2), (d) ``mezo`` under ``seed_parallel(2)``
  on the one card (K3 for the group updates);
* serve the fine-tune: ``composition_for_ledger`` on phase (b)'s ledger →
  batched replay (K3) → the paged engine (K2, K12);
* train under a parameter selection (``repro_torch.select``): (e) ``mezo``
  spsa under ``rows(block=1,k=4)`` (K7, K2), (f) ``fzoo(8)`` under it (K8,
  K9, K2), (g) ``fzoo(8, sphere)`` under it (K10, K8, K9, K2), (h) ``mezo``
  under ``peft("lora")`` (r 8, α 16 on wq / wv) on the merged tree (K1, K2);
* serve the rows fine-tune: phase (f)'s MZOL5 ledger through
  ``composition_for_ledger`` (K9) → the paged engine (K2, K12);
* the default ``xla`` stream (X1): (j) spsa, its replays and its served
  fine-tune, the steps of mezo-adam, trace and rescaled SPSA; (j′) spsa
  under JAX's original threefry layout (X1's ``pairs`` route), its replay
  ≡ the plain replay under that layout, then its step in turns with the
  partitionable layout's (host clock, kernel ms, launches).

It then frees the qwen2 trees and drives the ssm family at the full width
and depth of rwkv6-3b (32 layers, random bf16 weights from a seeded
``torch.Generator``, the chunk scan mode):

* train: (i) ``mezo`` spsa on 16 × 256-token batches (K1, K11), with its
  peak memory and device-busy share;
* serve the fine-tune: its MZOL2 ledger through ``composition_for_ledger``
  → replay (K1) → the engine's per-slot recurrent path (K11 in the
  exact-length prefills; the decode steps run the recurrence);
* check, outside the counts: prefill + decode against one prefill (the
  carried state, f32), and the chunk forward against ``fused_recurrent``
  (f32, and bf16 against the bf16 noise measured on the same batch).

Then the paper's own models, each at full width and depth with random
bf16 weights from seed 0 (initialized on the card, each leaf filled one
layer at a time), on the default ``xla`` stream, each with the trees
before it freed:

* (k) roberta-large (``causal=False``): ``mezo`` spsa under the accuracy
  objective on ``PromptClassification`` batches of 16, 20 steps (X1 on
  every write; K2 zero times — JAX's routing rule sends ``causal=False``
  to the chunked path), two replays, label-word accuracy printed;
* (l) opt-13b: the spsa step's peak against one forward's and its
  profiler breakdown, then 5 spsa steps on CE in place (X1, K2 at hd 128);
  θ₀ regenerated from the seed, the ledger replayed (X1) and held to the
  trained θ, the fine-tune served through the paged engine (K2 hd 128 on
  the cold prefill, K12), a second replay bitwise the first; (m) 3 steps
  of the F1 objective on ``SpanExtraction`` batches (X1, K2); K1 and X1
  over its 4 194 304 000-element ``w1`` leaf, held bitwise to their
  plain versions on windows at its start, around counter 2^31 and at its
  end;
* (n) opt-30b (56.47 GiB of parameters): 3 spsa steps on CE in place,
  their peak gated against one forward's and printed against the card's
  memory; θ₀ regenerated twice from the seed, the ledger replayed in
  place each time (X1), per-leaf checksums equal and host samples of the
  trained θ within the ulp bound; K1 and X1 over its 9 865 003 008-element
  ``w1`` leaf on windows across counters 2^31, 2^32, 3·2^31 and 2^33.
  opt-66b's analytic size is printed only.

Then the backprop baseline (``train.adam``) beside MeZO, each run from θ₀
regenerated from seed 0 at full width and depth, JAX's default ``xla``
attention (``pallas_flash`` refuses autograd in both packages):

* (o) roberta-large FT, the paper's Table 1 baseline: CE on
  ``PromptClassification(vocab=50265)`` (seq 32), batch 16, Adam
  (lr 1e-5) 10 steps and MeZO spsa on ``xla`` 10 steps on the same
  batches; (p) qwen2-0.5b on 16 × 256 lm batches: Adam, SGD and MeZO spsa,
  5 steps each.  For each run: one forward's peak, the steps' peak over
  the resident θ and in total, ms per step (host clock, median) and one
  step's device-busy share; the Adam-to-MeZO ratio of total peaks.  The
  MeZO runs keep the 1.10 × one forward's gate; Adam / SGD launch none of
  the port's kernels and are held to finite losses, a finite gradient norm
  > 0, θ moved and f32 moments;
* (q) one Adam step of the same code on the card and on the CPU at
  qwen2-0.5b's width, and at rwkv6-3b's full width in chunk mode (K11's
  forward on the card, its gradient the VJP of the plain chunk form,
  launches and backward records counted), 2 layers, f32, 2 × 64: the loss,
  the gradient norm, every gradient leaf and θ within stated tolerances;
  then autograd through ``pallas_flash`` (K2) on the card must raise
  before any launch, and ``fused_recurrent`` must differentiate;
* (r) reckoned, not measured: Adam's θ + grads + m + v against MeZO's θ
  for every registry arch, against the card's memory.

Then the moe family, random bf16 weights from seed 0 on the ``xla``
stream, ``pallas_flash`` attention:

* (s) granite-moe-3b-a800m at full width and depth (32 layers, 40
  experts top-8, hd 64) with its experts in 4 leaf groups: one spsa step
  under ``moe_experts(4)`` with its peak against one forward's, its busy
  share and top kernels, the router and the inactive groups at θ₀'s bits
  after it; 5 spsa steps through the training loop; two replays bitwise
  equal; θ₀ regenerated from the seed ≡ θ₀, the MZOL5 ledger replayed onto
  it and served through the paged engine (K2 hd 64, K12); one more step
  under the original threefry layout (X1's original route), its replay ≡
  the plain replay bitwise and within the ulp bound of the trained θ;
* (t) mixtral-8x7b at full width, 24 of its 32 layers (20 when a step
  would leave under 4 GiB free; the cut printed): 3 spsa steps in place,
  their peak against one forward's and the card's memory; one replay from
  θ₀ regenerated from the seed, held on sampled slices within the ulp
  bound; the fine-tune served through the engine's dense slab (4
  requests × 16 tokens: per-slot ring caches of the 4096 window, K2 hd 128
  with the window in the bucketed prefills); K2 at hd 128 with the window
  4096 held to its plain version at every shape the moe paths gave it.

Then the hybrid and encdec families, random bf16 weights from seed 0 on
the ``xla`` stream, ``pallas_flash`` attention:

* (u) hymba-1.5b at full width, 16 of its 32 layers (d 1600, 25 × 64
  heads over 5 KV heads, 25 SSM heads of state 16, window 2048): one spsa
  step's peak against one forward's, its busy share and top kernels; 10
  spsa steps through the training loop (X1, K2 at hd 64 with the window);
  two replays bitwise equal and within the ulp bound of the trained θ; one
  ``pallas+z2`` step, its replay through K1 ≡ the plain replay bitwise; K2
  at (1, 4096, 25, 64) with window 2048 held to its plain version; the
  ring wrap in f32 at full width, 4 layers (prefill 2000 tokens, decode
  past 2100, held to one full forward); the SSD chunk form against
  ``fused_recurrent`` on one full-width layer in f32; θ₀ regenerated ≡ θ₀,
  the ledger replayed onto it and served through the dense slab (8
  requests of ~2000-token prompts and 96 new tokens, every ring wrapping;
  K2 in the exact-length prefills), tok/s and TTFT p50;
* (w) whisper-large-v3 at full width and depth (32 + 32 layers, d 1280,
  20 × 64 heads): ``make_batch`` at 16 × 256 (frames from the stub normal,
  X1's ``z`` form), one spsa step's peak against one forward's and its busy
  share, 5 spsa steps, two replays bitwise equal and within the ulp bound;
  greedy decode of 16 tokens for 2 rows through ``prefill_fn`` /
  ``decode_fn`` (the 32 768-row decoder cache reckoned and printed); an
  f32 check at full width, 4 layers: prefill + incremental decode against
  teacher forcing; K2 only in the decoder's causal self-attention.

Then (x) multi-tenant LoRA serving (``repro_torch.serve.tenants``) on
qwen2-0.5b at full width, 4 of its 24 layers (bf16, ``pallas_flash``),
random weights from seed 0: 8 LoRA tenants (r 2, α 16 on wq / wv) of 10
steps of batch 8 on ``xla`` (X1) and one on ``pallas`` (K1); for one
tenant of each stream the cached, compacted (tail 4) and fresh serving
deltas bitwise equal, the replayed LoRA tree bitwise the CPU's plain
replay, the merged wq / wv within one bf16 ulp of the product and one of
the sum of the CPU's merge, a cache hit replaying nothing; 32 synthetic
requests (skew 2.0, one base-model request, 16 new tokens) and a wave of
16 template requests (4 templates of 48 tokens) through one 4-slot paged
engine (K2 on cold prefills, K12 on prefix hits and decode, the stacked
decode one call a step) with a delta cache of 3.18 deltas
(``X_CACHE_BYTES``) that must evict — tok/s, TTFT cold against warm, hit rate, ms per cold
materialization against a warm swap; the decode step timed on the
single-model, stacked and grouped paths; in f32 the stacked decode's
logits within ``X_F32_LOGIT_REL`` of the grouped (per-adapter) decode's
and its ids those of single-slot engines, a full-tree delta on the grouped
path with the same ids; in bf16 the gap and the agreement reported.

Then (y) the deprecated shims, the legacy-config interop and the
functional primitives (``repro_torch.core``) on qwen2-0.5b at full width
and depth (``shims_paths``): ``MeZO(MeZOConfig)`` through ``train.loop``
with a ledger ≡ ``zo.mezo`` after every step (peak gated at 1.10 × one
forward's), ``core.replay`` through a bare config ≡ the preset's and the
plain replay; a config naming ``backend="pallas"`` (K1), ``MeZOAdam`` and
``MeZOVariant`` (grad_norm_zo) ≡ their presets; the functional writes ≡
the backend's in-place writes with θ₀ untouched; the functional spsa chain
≡ the estimator's; the shim's step timed against the preset's in turns.

Then (z) distribution (``repro_torch.distributed``, ``launch.mesh``) on
qwen2-0.5b at full width and depth (``distribution_paths``), inside a
one-rank NCCL group on a ``FileStore`` under ``build/``: the (1, 1)
``DeviceMesh`` of ``make_elastic_mesh()``, every leaf placed with
``param_shardings`` and back bitwise, saved placed and loaded bitwise; the
data-parallel step over the group ≡ the step without a mesh, its only
collectives one all-reduce of two f32 per loss evaluation; the legacy
seed-parallel surface ≡ the engine; 4 async workers (staleness 0 on
``xla`` against ``seed_parallel(4)`` within a stated bf16-ulp bound, their
ledger replayed bitwise; a round each on ``pallas``: K1, the antithetic
pair through K4, fzoo through K5 and K3; a delayed schedule within its
bound; a too-stale contribution dropped); the activation resolver leaves
the logits' bits alone; produce / consume timed beside a local step.

Then (dr) the dry run (``repro_torch.launch.dryrun``, ``dryrun_paths``):
qwen2-0.5b's spsa step at full width and depth, 16 × 256 on one rank, is
traced on ``meta`` tensors and run on the card, for ``pallas`` with
``pallas_flash`` (K1, K2) and for ``xla`` (X1): the dry run's charges per
kernel (``analysis.costs``) equal the card's launches and the card step's
own charges, its argument bytes equal θ's and the batch's, and the
measured step (median of 3 after a warm-up) is not below its roofline
``step_s``, and ``max_memory_allocated`` over the step is at most
``DR_MEMORY_FACTOR`` × the record's argument + output + temp bytes (JAX's
three ``memory_analysis`` keys) — hard checks; model_flops / (989e12 ×
measured), the card's peak above the arguments against the temp bytes and
``useful_ratio`` are logged.  The CLI then runs in subprocesses that see
no card (opt-66b ``train_4k`` on 1 × 2 and 1 × 1: its per-rank argument
bytes against the card's; qwen2-7b on the single-pod mesh; every case
``ok``), and the five examples (``repro_torch.examples``) run to their end
on the card with X1 launched, and K12 in ``serve_batch``.

Then (tp) tensor parallelism (``tensor_parallel_paths``) at qwen2-0.5b's
full width and depth: K1, K3 (two seeds) and X1 in both threefry layouts
on every rank's shard of the sharded leaves under the rule engine's specs
on (1, 2) and (1, 4) meshes, bitwise their plain versions' shard writes
and the slice of the whole-leaf launch, timed in turns against the whole
pass; K2 on each rank's heads (7 q / 1 KV) within its tolerances of the
plain version on those heads and bitwise the whole launch's same heads,
timed beside SDPA on them; and two processes on the one card over gloo on
a (1, 2) ``data × model`` mesh: the TP forward's logits at θ₀ within
``TP_LOGIT_TOL`` of the one-process forward's, then one spsa step on
``pallas`` and one on ``xla`` and one ``seed_parallel(2)`` step with θ as
DTensors, each against the one-process step: θ at every loss evaluation
gathered and the update written with the one-process g bitwise, ℓ± within
``TP_LOSS_TOL``.

Checks: finite losses; two replays of each phase's ledger from θ₀ bitwise
equal; fzoo replays bitwise equal to the trained θ; sequential-spsa replays
within a stated bound in bf16 ulps of the trained θ; the spsa steps' peak
memory (full and rows; qwen2-0.5b, opt-13b, opt-30b) within 10 % of one
forward's; an initializer's peak over its parameters within its largest
f32 draw; after one rows step
every unselected element is θ₀'s; after the LoRA phase every base leaf is
θ₀'s; the served fine-tunes equal the trained θ bitwise (the rwkv6 one, an
spsa chain, equals its replay bitwise and the trained θ within the ulp
bound); every kernel launched on its path.

Prints the registers, shared memory and spills of every K2 and K11
instance, of K1, K3–K6, K10 and K12, and the HMMA count of K2's SASS; the step
times and the profiler's kernel time of an spsa, an fzoo(8) and an fzoo(8,
sphere) step (the port's own kernels by name); the
``kernels``
JSON line (launches, error, kernel / plain / library times in ms — the
plain versions of the z kernels run on the card in 2^24-element passes,
``plain_chunk`` — medians
of CUDA-event pairs over ``reps`` launches, for K2 and K12 and their
library calls of rounds of ``RUN_N`` back-to-back launches per pair, in
turns — and the roofline bound), and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero; there
is no fallback to the CPU or to a plain version on any path.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "data" / "zo_golden.npz"
MULTI_GOLDEN = ROOT / "tests" / "data" / "zo_multi_golden.npz"
ROWS_GOLDEN = ROOT / "tests" / "data" / "zo_rows_golden.npz"
WKV6_GOLDEN = ROOT / "tests" / "data" / "wkv6_golden.npz"
RUN_DIR = ROOT / "build" / "chip_smoke_runs"
#: the counts' key for X1's launches off the vector route in phase (dr)'s
#: train_100m example (its sub-leaf rows(...) selection), the only ones
X1_ROWS_EXAMPLE = "zo_affine_threefry (dr) train_100m rows"

# each kernel's work per call (bytes, operations) and its roofline bound at
# the H100 SXM's peaks at 700 W (``costs.bound_ms``, the dry run's own):
# ``repro_torch.analysis.costs``, imported in main once ``SRC`` is on the path
costs = None

# the serving path's shapes
N_RECORDS = 4
SLOTS = 8
MAX_LEN = 1024
BLOCK = 16
TEMPLATE_LEN = 320
N_REQUESTS = 12
NEW_TOKENS = 16
# K2: one bf16 rounding of each output on both sides of an f32 computation
# whose two orders of summation differ by ~1e-6: at most one bf16 ulp apart
K2_BF16_REL, K2_BF16_ABS = 2.0 ** -7, 1e-5
K2_F32_ABS = 1e-5
# K2 and K12 are timed as runs of this many back-to-back launches per pair
# of CUDA events (the plain K2, 0.6 ms a call, as runs of RUN_N_PLAIN)
RUN_N, RUN_N_PLAIN = 100, 20

# the training paths' shapes (the paper's batch of 16)
TRAIN_BATCH, TRAIN_SEQ = 16, 256
SEED = 0
LR, EPS = 1e-6, 1e-3
B_SEEDS = 8
STEPS = {"a_spsa": 20, "b_fzoo": 4, "c_sphere": 3, "d_sp2": 8,
         "e_rows_spsa": 20, "f_rows_fzoo": 4, "g_rows_sphere": 4,
         "h_lora": 20}
ROWS = "rows(block=1,k=4)"
LORA_RANK, LORA_ALPHA = 8, 16.0
MLP_LEAF = (24, 896, 4864)           # the stacked MLP weight (w1 / w3)
# live and replay of a sequential-spsa ledger round differently in bf16.
# Every rounding happens at a magnitude of at most |θ| + ε·Z_MAX (the chain
# visits θ ± εz; |z| < 5.9 by construction, u ≥ 2^-25) and moves the value
# by at most half a bf16 ulp there, so after T steps live and replay differ
# by at most T · (live + replay roundings per step) / 2 such ulps, doubled
# because a value may cross a binade between a rounding and the end.
# (a): live θ+εz, θ−εz, restore-update = 3, replay 1 → 2·2 per step.
# (d): 2 groups × 3 live roundings + the 2-stream K3 fold (2), replay 2 →
# 5·2 per step.
# (e) and (h) are the (a) chain on the selected elements / the LoRA leaves.
# (j): the xla stream rounds every op in bf16 — live θ+εz and θ−εz 2 each
# (ε·z, the sum), the restore-update 5 (ε·z, the sum, decay·r, η·g·z, the
# sum), replay 3 (decay·θ, coeff·z, the sum) → 12 per step.
# (k), (l) and (n) are (j)'s chain at other models, and so are the moe
# phases (s) and (t) and the family phases (u) and (w); (u)'s pallas+z2
# step is (a)'s chain.
ULPS_PER_STEP = {"a_spsa": 4.0, "d_sp2": 10.0, "e_rows_spsa": 4.0,
                 "h_lora": 4.0, "i_ssm_spsa": 4.0, "j_xla_spsa": 12.0,
                 "j_xla_orig": 12.0,
                 "k_roberta_acc": 12.0, "l_opt13b_spsa": 12.0,
                 "n_opt30b_spsa": 12.0, "s_granite_spsa": 12.0,
                 "s_granite_orig": 12.0, "t_mixtral_spsa": 12.0,
                 "u_hymba_spsa": 12.0, "u_hymba_pallas": 4.0,
                 "w_whisper_spsa": 12.0, "y_shim": 12.0}
Z_MAX = 6.0
MEM_SLACK = 1.10
# the ssm phases: rwkv6-3b at full width and depth (32 layers, d 2560,
# 40 heads × 64, d_ff 8960, vocab 65 536, bf16)
SSM_ARCH = "rwkv6-3b"
SSM_SLOTS, SSM_MAX_LEN, SSM_REQUESTS, SSM_NEW = 4, 256, 6, 8
# K11 against its plain version on the card: one f32 factorization summed
# in two orders (the kernel's scalar FMAs, the plain version's cuBLAS f32
# products, TF32 off) — max |Δ| relative to the call's largest |output|
K11_REL = 1e-5
# K11 against the JAX fixture: JAX's own kernel-vs-oracle tolerance
# (tests/test_kernels.py)
K11_FIX_ATOL, K11_FIX_RTOL = 5e-4, 1e-3
# prefill + decode chain vs one chunk-mode prefill, in f32: the chunked
# factorization against the per-token recurrence, 32 layers deep — max |Δ|
# relative to the largest |state|
SSM_STATE_REL = 1e-3
# chunk (K11) vs fused_recurrent forward, ‖Δ‖ / ‖logits‖: in f32 the two
# factorizations agree to f32 rounding through 32 layers; in bf16 each
# layer rounds its output to bf16 and a flipped rounding propagates through
# the 32 random-weight residual layers (5.1e-2 on an H100 at 4 × 256), so the
# bf16 gap is held to a multiple of the bf16 noise measured on the same
# batch: each mode's bf16 logits against its f32 logits
SSM_MODES_F32_REL = 1e-4
SSM_MODES_NOISE = 2.0
# the default stream (``xla``, X1): spsa steps, and the applier / rescaled
# estimators' steps, at qwen2-0.5b's full width
XLA_STEPS = {"j_xla_spsa": 10, "j_xla_orig": 2}
# the spsa step's turns, original layout against partitionable (P O O P),
# each turn XLA_TURN_STEPS steps on the same θ and batch
XLA_TURN_STEPS = 2
XLA_OTHER_STEPS = {"mezo_adam": 3, "trace": 3, "rescaled": 5}
# the paper's own models on the default stream, each at full width and
# depth: (k) roberta-large on prompt classification under the accuracy
# objective, (l) opt-13b spsa on CE and (m) on F1 over span extraction,
# (n) opt-30b spsa on CE
PAPER_STEPS = {"k_roberta_acc": 20, "l_opt13b_spsa": 5, "m_opt13b_f1": 3,
               "n_opt30b_spsa": 3}
PAPER_BATCH = 16
# a random head puts no mass on the task's label words, so argmax over the
# whole vocabulary never lands on one and the accuracy objective is 0 at
# θ and θ ± εz alike; θ₀'s head columns of the label words are scaled by
# this gain, as a pretrained masked LM's [MASK] slot favours its verbalizer
VERBALIZER_GAIN = 16.0
# opt-13b's serving pool: 40 layers × 40 heads × 128 × 2 (K, V) bf16 is
# 0.78 MiB of KV per token; 512 rows per slot hold the template (320), a
# suffix (8-40) and the 16 new tokens
OPT_MAX_LEN = 512
# K1 / X1 held to their plain versions on windows of a real leaf past 2^31
# (opt-13b's w1) and past 2^32 (opt-30b's w1): WINDOW elements at 0, around
# every counter multiple of 2^31 the leaf reaches, and at its end
WINDOW = 1 << 16
# checksums and ulp comparisons walk a leaf in chunks of this many elements
CHUNK = 1 << 26
# the backprop baseline (train.adam) beside MeZO, steps per run: (o)
# roberta-large FT (Adam lr 1e-5, the paper's Table 1 baseline) and MeZO on
# prompt classification; (p) qwen2-0.5b, Adam, SGD and MeZO on lm batches
BACKPROP_STEPS = {"o_roberta": 10, "p_qwen2": 5}
# (q) one Adam step of the same port code on the card and on the CPU, at
# qwen2-0.5b's width and at rwkv6-3b's (chunk mode) with BP_LAYERS layers
# in f32 (TF32 off): the loss and
# the gradients are f32 sums in cuBLAS's and the CPU BLAS's orders (loss
# within BP_LOSS_REL of itself, each gradient leaf within BP_GRAD_REL of its
# largest |g|); Adam's first step is η·sign(g) wherever |g| ≫ ε, so θ is
# held within 2η everywhere and within BP_THETA_ATOL·η on all but
# BP_THETA_OUTLIERS of its elements (a gradient near 0 can change sign)
BP_LAYERS, BP_BATCH, BP_SEQ, BP_LR = 2, 2, 64, 1e-3
BP_LOSS_REL, BP_GRAD_REL = 1e-5, 1e-4
BP_THETA_ATOL, BP_THETA_OUTLIERS = 1e-2, 1e-3
X1_GOLDEN = ROOT / "tests" / "data" / "x1_golden.npz"
# X1's route for JAX's original threefry layout (jax_threefry_partitionable
# off), against JAX's writes under that layout
X1_ORIG_GOLDEN = ROOT / "tests" / "data" / "x1_original_golden.npz"
# the moe family, after the backprop phases: (s) granite-moe-3b-a800m at
# full width and depth under moe_experts(GRANITE_GROUPS), spsa on xla, then
# one step under the original layout; (t) mixtral-8x7b at full width, its
# depth cut to MIXTRAL_LAYERS of 32 (46.70e9 parameters, 86.99 GiB of bf16,
# do not fit the card's 79.18 GiB), to MIXTRAL_FALLBACK_LAYERS when a step
# would leave under MIXTRAL_MIN_FREE bytes free
MOE_STEPS = {"s_granite_spsa": 5, "s_granite_orig": 1, "t_mixtral_spsa": 3}
GRANITE_GROUPS = 4
MIXTRAL_LAYERS, MIXTRAL_FALLBACK_LAYERS = 24, 20
MIXTRAL_MIN_FREE = 4 << 30
# the hybrid and encdec families, after the moe phases: (u) hymba-1.5b at
# full width, its depth cut to HYMBA_LAYERS of 32 to keep the whole run
# well inside its time limit, and (w) whisper-large-v3 at full width and
# depth
HYMBA_LAYERS = 16
FAMILY_STEPS = {"u_hymba_spsa": 10, "u_hymba_pallas": 1,
                "w_whisper_spsa": 5}
# K2 at hymba's head shape over a sequence the 2048 window binds
HYMBA_K2_SHAPE = (1, 4096, 25, 64)
# the ring wrap in f32 at full width, RING_LAYERS layers: prefill
# RING_PREFILL tokens, decode one at a time through position RING_END, and
# hold the last logits to one full forward of the whole sequence (the same
# math in other orders: the SSD chunk form against the per-token
# recurrence, the ring against the window's mask) — max |Δ| within
# RING_REL × max |logits|
RING_LAYERS, RING_PREFILL, RING_END = 4, 2000, 2100
RING_REL = 1e-4
# the SSD chunk form against fused_recurrent on one full-width layer in f32
# (JAX's SCAN_PARITY_ATOL, tests/test_zoo_conformance.py), rtol 1e-3
SSD_ATOL, SSD_RTOL, SSD_SEQ = 1e-4, 1e-3, 256
# hymba served through the dense slab: every prompt fits the 2048-row ring
# and every decode wraps it
HYMBA_SLOTS, HYMBA_PROMPT, HYMBA_NEW, HYMBA_MAX_LEN = 8, 2000, 96, 2200
# mixtral's fine-tune served through the dense slab
MIXTRAL_REQUESTS, MIXTRAL_NEW, MIXTRAL_MAX_LEN = 4, 16, 512
# whisper: greedy decode of WHISPER_NEW tokens for WHISPER_ROWS rows
# against WHISPER_FRAMES frames (1500 frames = 30 s of audio, padded);
# the f32 check of prefill + incremental decode against teacher forcing at
# WHISPER_CHECK_LAYERS layers, within WHISPER_REL × max |logits|
WHISPER_ROWS, WHISPER_FRAMES, WHISPER_NEW = 2, 1504, 16
WHISPER_CHECK_LAYERS, WHISPER_REL = 4, 1e-4
# (x) multi-tenant LoRA serving on qwen2-0.5b at full width, X_LAYERS of its
# 24 layers (cut from 24 to pay for (tp)'s fan-out and sphere cases: every
# per-layer shape and every kernel of the phase stay):
# X_TENANTS LoRA tenants (r 2, α 16 on wq / wv, the tenants package's
# convention) of X_TENANT_STEPS steps of X_TENANT_BATCH on xla, one more on
# pallas; X_REQUESTS synthetic requests (skew X_SKEW, X_NEW new tokens) and
# one template wave (X_WAVE requests on X_TEMPLATES templates of
# X_TEMPLATE_LEN tokens) over X_SLOTS slots; a delta cache of X_CACHE_BYTES
# holds three X_DELTA_BYTES deltas (merged wq (X_LAYERS, 896, 896) + wv
# (X_LAYERS, 896, 128) in bf16), so the tenants force evictions
X_LAYERS = 4
X_TENANTS, X_TENANT_STEPS, X_TENANT_BATCH, X_SEED0 = 8, 10, 8, 100
X_REQUESTS, X_NEW, X_SKEW = 32, 16, 2.0
X_WAVE, X_TEMPLATES, X_TEMPLATE_LEN = 16, 4, 48
X_SLOTS, X_MAX_LEN, X_KEEP_TAIL = 4, 128, 4
X_DELTA_BYTES = X_LAYERS * (896 * 896 + 896 * 128) * 2
X_CACHE_BYTES = X_DELTA_BYTES * 35 // 11       # 3.18 deltas
# decode steps timed per path (X_STEP_TOKENS tokens a request), and the
# stacked-vs-per-adapter checks (X_CHECK_NEW tokens a request): in f32 the
# stacked call's logits (batched matmuls through the vmap) within
# X_F32_LOGIT_REL × max |logits| of the grouped calls' (f32 sums in other
# orders through 24 layers, TF32 off)
X_STEP_TOKENS, X_CHECK_NEW, X_F32_LOGIT_REL = 24, 8, 1e-4
# (y) the deprecated shims and the functional primitives on qwen2-0.5b at
# full width and depth: Y_STEPS shim steps through the loop (and the
# preset's, compared after every step), Y_PALLAS_STEPS of a config naming
# the counter backend, Y_ADAM_STEPS of MeZOAdam, Y_VARIANT_STEPS of
# MeZOVariant (grad_norm_zo); the host-clock turns of the shim's step
# against the preset's, Y_TURN_STEPS steps a turn; the functional chain's
# ℓ± held to the in-place estimator's within Y_LOSS_REL (the same bits
# through the same forward: expected equal)
Y_STEPS, Y_PALLAS_STEPS, Y_ADAM_STEPS, Y_VARIANT_STEPS = 5, 3, 3, 2
Y_TURN_STEPS, Y_LOSS_REL = 2, 1e-6
# (z) distribution on qwen2-0.5b at full width and depth: Z_WORKERS async
# workers (each its own θ) over Z_ROUNDS staleness-0 rounds on xla, one
# round each on pallas (spsa's in-place chain, its antithetic pair, fzoo
# with Z_FZOO_SEEDS seeds), a delayed schedule of Z_ROUNDS rounds under
# max_staleness Z_DELAY_WINDOW, Z_TURNS timed turns.  Bounds in bf16 ulps at
# |θ| + ε·Z_MAX, each rounding at most half an ulp there, doubled because a
# value may cross a binade between a rounding and the end:
# * seed_parallel(n) against the staleness-0 workers: the seed-parallel
#   step restores θ between its groups (θ+εz 2 roundings on xla, θ−εz 2,
#   the restore 5) and both apply each group's update (3 roundings each):
#   15 per group and step;
# * the delayed schedule: every worker applies the same n·T contributions
#   in its own order (its own at once, its peers' a round late); the exact
#   sums agree, and each apply rounds 3 times: 2 workers × 3 per apply.
Z_WORKERS, Z_ROUNDS, Z_FZOO_SEEDS, Z_DELAY_WINDOW, Z_TURNS = 4, 3, 4, 2, 3
Z_SP_ULPS_PER_GROUP_STEP, Z_DELAY_ULPS_PER_APPLY = 15.0, 6.0
QWEN2_PARAMS = 630_167_424
SEEDS8 = [11, -5, 2**31 - 1, 977, 3, 123456789, -2**31, 42]
A8 = [0.999, 1.0, 0.5, 1.0, 0.9990234375, 1.0, 1.0, 0.75]
B8 = [-0.0123, 0.01, 0.25, -1e-3, 0.0625, -0.5, 3e-4, 0.1]


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, stamped with the seconds since the start."""
    print(f"[chip_smoke {time.perf_counter() - T_START:6.1f} s] {msg}",
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, each between its own pair of
    CUDA events, after one warm-up run."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def run_ms(fns: dict, n: int, rounds: int = 4, graph: bool = True) -> dict:
    """ms per launch of each ``fns[name]()``: ``rounds`` rounds in which
    every function in turn (the order reversed every other round: A B, B A,
    …) runs ``n`` times back to back between one pair of CUDA events; the
    median over the rounds of the elapsed time over ``n``.  With ``graph``
    the ``n`` launches are captured once in a CUDA graph and replayed, so
    the run measures the card and not the host's work to enqueue them
    (a Python wrapper's checks and ctypes call take longer than a kernel of
    a few tens of µs); without it they are issued from Python as a caller
    issues them.  Every function is called once (and the graphs replayed
    once) before the timed rounds."""
    import statistics

    import torch
    runs = {}
    for name, fn in fns.items():
        fn()
        if graph:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(n):
                    fn()
            runs[name] = g.replay
        else:
            def eager(fn=fn):
                for _ in range(n):
                    fn()
            runs[name] = eager
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    names = list(runs)
    per = {k: [] for k in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            runs[name]()
            e1.record()
            torch.cuda.synchronize()
            per[name].append(e0.elapsed_time(e1) / n)
    return {k: statistics.median(v) for k, v in per.items()}


def host_ms(fn) -> float:
    """ms of one ``fn()`` on the host clock, synchronized on both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bits_of(t):
    import torch
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(bits_of(a), bits_of(b))


# --------------------------------------------------------------------------- #
# Kernel checks
# --------------------------------------------------------------------------- #
def check_k1(torch, np, kz) -> float:
    """K1 vs its plain version on the card, bitwise, and vs the JAX golden
    fixture; returns the max abs error seen (0 when bitwise)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for dist in ("gaussian", "rademacher"):
            for n in (1, 40_000, 262_147, 1_048_583):
                x = torch.randn(n, generator=g, device="cuda").to(dt)
                yk = kz.zo_affine(x, 987654321, 0.9990234375, -0.0123, dist)
                yp = kz.zo_affine_plain(x, 987654321, 0.9990234375, -0.0123,
                                        dist)
                if not same_bits(yk, yp):
                    fail(f"K1 {dt} {dist} n={n}: kernel != plain")
    gold = np.load(GOLDEN)
    for i, seed in enumerate(gold["seeds"]):
        n = int(gold[f"z_gauss_{i}"].shape[0])
        ones = torch.ones(n, dtype=torch.float32, device="cuda")
        zk = kz.zo_affine(ones, int(seed), 0.0, 1.0, "gaussian").cpu().numpy()
        if not np.array_equal(zk.view(np.uint32),
                              gold[f"z_gauss_{i}"].view(np.uint32)):
            fail(f"K1 gaussian z (seed {seed}) != the JAX golden fixture")
        rk = kz.zo_affine(ones, int(seed), 0.0, 1.0, "rademacher").cpu()
        if not np.array_equal(np.packbits(rk.numpy() > 0),
                              gold[f"rad_bits_{i}"]):
            fail(f"K1 rademacher z (seed {seed}) != the JAX golden fixture")
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = torch.from_numpy(gold[f"aff_{name}_x"])
        if dt == torch.bfloat16:
            x = x.view(torch.bfloat16)
        y = kz.zo_affine(x.cuda(), int(gold[f"aff_{name}_seed"]),
                         float(gold[f"aff_{name}_a"]),
                         float(gold[f"aff_{name}_b"]), "gaussian")
        if not np.array_equal(bits_of(y).cpu().numpy(),
                              gold[f"aff_{name}_y"]):
            fail(f"K1 {name} affine != the JAX golden fixture")
    log("K1 zo_affine: bitwise vs plain (f32/bf16/f16 × gaussian/"
        "rademacher, odd sizes) and vs the JAX golden fixture")
    return 0.0


def check_k2(torch, kf) -> float:
    """K2 vs plain on the card at qwen2-0.5b head shapes: the bf16 route
    (mma.sync) at S ∈ {1, 100, 256, 512, 2048} × window ∈ {0, 64} and at
    the training shape, repeatable bit for bit there; the scalar f32 route
    at the same S."""
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    cases = [(2, S) for S in (1, 100, 256, 512, 2048)]
    cases.append((TRAIN_BATCH, TRAIN_SEQ))
    for B, S in cases:
        for window in (0, 64):
            mk = lambda kv: torch.randn(B, S, kv, 64, generator=g,  # noqa
                                        device="cuda").to(torch.bfloat16)
            q, k, v = mk(14), mk(2), mk(2)
            out = kf.flash_attention(q, k, v, window=window)
            ok = out.float()
            op = kf.flash_attention_plain(q, k, v, window=window).float()
            err = (ok - op).abs()
            if not torch.isfinite(ok).all() or bool(
                    (err > K2_BF16_REL * op.abs() + K2_BF16_ABS).any()):
                fail(f"K2 bf16 B={B} S={S} window={window}: max err "
                     f"{err.max().item()} beyond one bf16 ulp")
            worst = max(worst, err.max().item())
            if B == TRAIN_BATCH:
                if not same_bits(out, kf.flash_attention(q, k, v,
                                                         window=window)):
                    fail(f"K2 bf16 at the training shape, window={window}: "
                         "two launches differ")
                continue
            of = kf.flash_attention(q.float(), k.float(), v.float(),
                                    window=window)
            opf = kf.flash_attention_plain(q.float(), k.float(), v.float(),
                                           window=window)
            e32 = (of - opf).abs().max().item()
            if e32 > K2_F32_ABS:
                fail(f"K2 f32 S={S} window={window}: max err {e32}")
    log(f"K2 flash_attention: bf16 (mma.sync) within one ulp of plain (max "
        f"abs err {worst}) at S up to 2048 and the training shape "
        f"({TRAIN_BATCH}, {TRAIN_SEQ}, 14, 64), repeatable bit for bit; f32 "
        f"(scalar) within {K2_F32_ABS}; H=14 KV=2 hd=64, window 0 and 64")
    return worst


def check_k3_k4_k5(torch, np, kz, km) -> None:
    """K3 chain, K4 fan-out and K5 batched fan-out vs their plain versions,
    bitwise: f32/bf16/f16 × gaussian/rademacher, odd sizes, B ∈ {1, 2, 8};
    one leaf at qwen2-0.5b's real shape (the stacked MLP weight) at B = 8;
    a chain longer than one launch takes; and the JAX-computed fixture."""
    g = torch.Generator(device="cuda").manual_seed(7)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for dist in ("gaussian", "rademacher"):
            for n in (1, 40_000, 262_147):
                x = torch.randn(n, generator=g, device="cuda").to(dt)
                for nb in (1, 2, 8):
                    s, a, b = SEEDS8[:nb], A8[:nb], B8[:nb]
                    _hold_k345(kz, km, x, s, a, b, dist,
                               f"{dt} {dist} n={n} B={nb}")
    x = torch.randn(MLP_LEAF, generator=g, device="cuda").to(torch.bfloat16)
    _hold_k345(kz, km, x, SEEDS8, A8, B8, "gaussian",
               f"the {MLP_LEAF} bf16 leaf at B=8")
    del x
    # the fan-out's scalar route: slices off x's 16-byte grid (33×65), x off
    # y's offset; and 65 streams, two launches
    n_fan = kz.MAX_STREAMS + 1
    seeds = [977 + 31 * j for j in range(n_fan)]
    a, b = (A8 * 9)[:n_fan], (B8 * 9)[:n_fan]
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        base = torch.randn(33 * 65 + 8, generator=g, device="cuda").to(dt)
        for what, x in (("33×65", base[:33 * 65].view(33, 65)),
                        ("offset 3", base[3:3 + 33 * 64])):
            for nb in (1, 8, n_fan):
                _hold_k345(kz, km, x, seeds[:nb], a[:nb], b[:nb], "gaussian",
                           f"{dt} {what} B={nb}")
    n_long = kz.MAX_STREAMS + 6
    x = torch.randn(70_001, generator=g, device="cuda").to(torch.bfloat16)
    seeds = list(range(n_long))
    if not same_bits(km.zo_affine_chain(x, seeds, [1.0] * n_long,
                                        [1e-3] * n_long),
                     km.zo_affine_chain_plain(x, seeds, [1.0] * n_long,
                                              [1e-3] * n_long)):
        fail(f"K3 with {n_long} streams (two launches) != plain")
    gold = np.load(MULTI_GOLDEN)
    seeds = [int(v) for v in gold["seeds"]]
    for name, dt, view in (("f32", torch.float32, np.int32),
                           ("bf16", torch.bfloat16, np.int16)):
        x = torch.from_numpy(gold[f"{name}_x"].view(view).copy()).view(dt)
        x = x.cuda()
        for what, got in (
                ("chain", km.zo_affine_chain(x, seeds, gold["a"], gold["b"])),
                ("multi", km.zo_affine_multi(x, seeds, gold["a"], gold["b"])),
                ("batched", kz.zo_affine_batched(x, seeds,
                                                 float(gold["a"][0]),
                                                 float(gold["b"][0])))):
            if not np.array_equal(bits_of(got).cpu().numpy().view(
                    gold[f"{name}_{what}"].dtype), gold[f"{name}_{what}"]):
                fail(f"K3-K5 {what} {name} != the JAX golden fixture")
    log("K3 zo_affine_chain, K4 zo_affine_multi, K5 zo_affine_batched: "
        "bitwise vs plain (f32/bf16/f16 × gaussian/rademacher, odd sizes, "
        f"B ∈ {{1, 2, 8}}, the {MLP_LEAF} leaf at B=8, the fan-out's scalar "
        f"route on a 33×65 leaf and an offset one at B ∈ {{1, 8, {n_fan}}}, "
        f"{n_long} streams) and vs the JAX golden fixture")


def _hold_k345(kz, km, x, seeds, a, b, dist, what) -> None:
    pairs = (
        ("K3", km.zo_affine_chain(x, seeds, a, b, dist),
         lambda: km.zo_affine_chain_plain(x, seeds, a, b, dist)),
        ("K4", km.zo_affine_multi(x, seeds, a, b, dist),
         lambda: km.zo_affine_multi_plain(x, seeds, a, b, dist)),
        ("K5", kz.zo_affine_batched(x, seeds, a[0], b[0], dist),
         lambda: kz.zo_affine_batched_plain(x, seeds, a[0], b[0], dist)))
    for name, got, plain in pairs:
        if not same_bits(got, plain()):
            fail(f"{name} {what}: kernel != plain")
        del got


def check_k6(torch, np, km) -> None:
    """K6 vs its plain version bitwise (odd sizes, several tiles, the
    embedding leaf), and within SQNORM_RTOL of JAX's zo_sqnorm_ref."""
    gold = np.load(MULTI_GOLDEN)
    cases = [(int(n), int(s)) for n, s in zip(gold["sq_n"], gold["sq_seed"])]
    cases += [(151_936 * 896, 5), (24 * 896 * 4864, -77)]
    worst, plain = 0.0, {}
    for n, s in cases:
        for dist in ("gaussian", "rademacher"):
            k = km.zo_sqnorm(n, s, dist, "cuda")
            p = km.zo_sqnorm_plain(n, s, dist, "cuda")
            if not same_bits(k, p):
                fail(f"K6 n={n} seed={s} {dist}: kernel {k.item()} != plain "
                     f"{p.item()}")
            plain[n, s, dist] = p
    # every case in one zo_sqnorm_many call: each leaf's bits as alone
    for dist in ("gaussian", "rademacher"):
        many = km.zo_sqnorm_many([n for n, _ in cases], [s for _, s in cases],
                                 dist, "cuda")
        for (n, s), k in zip(cases, many):
            if not same_bits(k, plain[n, s, dist]):
                fail(f"K6 zo_sqnorm_many n={n} seed={s} {dist}: != plain")
    many = km.zo_sqnorm_many(gold["sq_n"].tolist(), gold["sq_seed"].tolist(),
                             "gaussian", "cuda")
    for n, s, want, k in zip(gold["sq_n"], gold["sq_seed"], gold["sq_jax"],
                             many):
        for got in (km.zo_sqnorm(int(n), int(s), "gaussian", "cuda").item(),
                    k.item()):
            rel = abs(got - float(want)) / float(want)
            worst = max(worst, rel)
            if rel > km.SQNORM_RTOL:
                fail(f"K6 n={n}: {got} vs JAX {want}: rel err {rel} > "
                     f"{km.SQNORM_RTOL}")
    log(f"K6 zo_sqnorm: bitwise vs plain (n up to {cases[-2][0]}, gaussian/"
        f"rademacher; one leaf per call and all {len(cases)} in one "
        f"zo_sqnorm_many call), within {worst:.2e} relative of JAX's "
        f"zo_sqnorm_ref (tolerance {km.SQNORM_RTOL})")


def _rows_be(shape, R: int) -> int:
    width = 1
    for d in shape[1:]:
        width *= d
    return R * width


def check_k7_k10(torch, np, kr) -> None:
    """K7 rows affine, K8 rows fan-out, K9 rows chain and K10 rows sqnorm
    vs their plain versions, bitwise: 2-D, 3-D stacked and 1-D odd leaves,
    f32/bf16/f16 × gaussian/rademacher, R ∈ {1, 3, 96}, k ∈ {1, 2, 3},
    every phase; the embedding and MLP leaves at qwen2-0.5b's real shapes
    under rows(block=1, k=4); a 70-stream K9 chain; and the JAX-computed
    fixture (K10 within SQNORM_RTOL)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    n_cases = 0
    for shape in ((301, 67), (3, 170, 29), (100_003,)):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            for dist in ("gaussian", "rademacher"):
                for R in (1, 3, 96):
                    be = _rows_be(shape, R)
                    for k in (1, 2, 3):
                        for ph in range(k):
                            if kr.selected_count(x.numel(), be, k, ph):
                                _hold_rows(torch, kr, x, be, k, ph, dist,
                                           f"{dt} {dist} {shape} R={R} k={k} "
                                           f"phase={ph}")
                                n_cases += 1
    # K10 many-calls: (n, seed, (be, k, phase)) of every leaf below
    many = []
    for shape in ((151_936, 896), MLP_LEAF):
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        be = _rows_be(shape, 1)
        for ph in range(4):
            if not same_bits(kr.zo_affine_rows(x, 5, 1.0, 1e-3, be, 4, ph),
                             kr.zo_affine_rows_plain(x, 5, 1.0, 1e-3, be, 4,
                                                     ph)):
                fail(f"K7 {shape} rows(1,4) phase {ph}: kernel != plain")
            k10 = kr.zo_sqnorm_rows(x.numel(), 5, be, 4, ph, "gaussian",
                                    "cuda")
            if not same_bits(k10, kr.zo_sqnorm_rows_plain(
                    x.numel(), 5, be, 4, ph, "gaussian", "cuda")):
                fail(f"K10 {shape} rows(1,4) phase {ph}: kernel != plain")
            many.append((x.numel(), 5 + ph, (be, 4, ph)))
        if shape == MLP_LEAF:
            _hold_rows(torch, kr, x, be, 4, 1, "gaussian",
                       f"the {MLP_LEAF} bf16 leaf at B=8")
        del x
    # be < 1024, = 1024, > 1024 and 1; ragged blocks; more leaves than one
    # launch takes (two launches)
    many += [(2747, 11, (201, 2, 1)), (100_003, 12, (1, 2, 0)),
             (163_840, 13, (1024, 4, 3)), (300_001, 14, (280, 3, 2)),
             (15_077, 15, (5000, 2, 1))]
    many += [(500 + 13 * i, 977 + i, (1 + i % 37, 2 + i % 3, i % (2 + i % 3)))
             for i in range(kr.ROWS_MAX_LEAVES)]
    for dist in ("gaussian", "rademacher"):
        got = kr.zo_sqnorm_rows_many([n for n, _, _ in many],
                                     [s for _, s, _ in many],
                                     [p for _, _, p in many], dist, "cuda")
        for (n, sd, p), norm in zip(many, got):
            if not same_bits(norm, kr.zo_sqnorm_rows_plain(n, sd, *p, dist,
                                                           "cuda")):
                fail(f"K10 zo_sqnorm_rows_many n={n} plan={p} {dist}: != "
                     "plain")
    n_long = 70
    x = torch.randn(70_001, generator=g, device="cuda").to(torch.bfloat16)
    seeds = list(range(n_long))
    if not same_bits(
            kr.zo_affine_chain_rows(x, seeds, [1.0] * n_long, [1e-3] * n_long,
                                    3, 2, 1),
            kr.zo_affine_chain_rows_plain(x, seeds, [1.0] * n_long,
                                          [1e-3] * n_long, 3, 2, 1)):
        fail(f"K9 with {n_long} streams (two launches) != plain")
    n_routes = check_rows_routes(torch, kr)
    gold = np.load(ROWS_GOLDEN)
    seeds = [int(v) for v in gold["seeds"]]
    worst, i, fixture = 0.0, 0, []
    while f"plan_{i}" in gold.files:
        _, k, ph, be = (int(v) for v in gold[f"plan_{i}"])
        for name, dt, iv in (("f32", torch.float32, np.int32),
                             ("bf16", torch.bfloat16, np.int16)):
            x = torch.from_numpy(gold[f"{name}_x_{i}"].view(iv).copy())
            x = x.view(dt).cuda()
            for what, got in (
                    ("affine", kr.zo_affine_rows(x, seeds[0],
                                                 float(gold["a"][0]),
                                                 float(gold["b"][0]), be, k,
                                                 ph)),
                    ("multi", kr.zo_affine_multi_rows(x, seeds, gold["a"],
                                                      gold["b"], be, k, ph)),
                    ("chain", kr.zo_affine_chain_rows(x, seeds, gold["a"],
                                                      gold["b"], be, k, ph))):
                if not np.array_equal(bits_of(got).cpu().numpy(),
                                      gold[f"{name}_{what}_{i}"].view(iv)):
                    fail(f"K7-K9 {what} {name} plan {i} != the JAX golden "
                         "fixture")
        fixture.append((gold[f"f32_x_{i}"].size, (be, k, ph),
                        float(gold[f"sq_{i}"])))
        i += 1
    # every fixture plan alone and all in one many-call
    together = kr.zo_sqnorm_rows_many([n for n, _, _ in fixture],
                                      [seeds[1]] * len(fixture),
                                      [p for _, p, _ in fixture], "gaussian",
                                      "cuda")
    for (n, p, want), norm in zip(fixture, together):
        for got in (kr.zo_sqnorm_rows(n, seeds[1], *p, "gaussian",
                                      "cuda").item(), norm.item()):
            rel = abs(got - want) / want
            worst = max(worst, rel)
            if rel > kr.SQNORM_RTOL:
                fail(f"K10 plan {p}: {got} vs JAX {want}: rel err {rel}")
    log(f"K7 zo_affine_rows, K8 zo_affine_multi_rows, K9 zo_affine_chain_rows,"
        f" K10 zo_sqnorm_rows: bitwise vs plain ({n_cases} plans: f32/bf16/"
        "f16 × gaussian/rademacher, 2-D/3-D/1-D odd leaves, R ∈ {1, 3, 96}, "
        "k ∈ {1, 2, 3}, every phase; the embedding and MLP leaves under "
        f"rows(1,4); {n_long} streams; K10 also {len(many)} leaves in one "
        "zo_sqnorm_rows_many call, two launches; K7 and K9 in place on both "
        f"routes, {n_routes} cases, each launch counted under rows_route's "
        "route, nothing outside the selection or the leaf changed), vs the "
        "JAX golden fixture "
        f"(K10 alone and in one many-call within {worst:.2e} relative, "
        f"tolerance {kr.SQNORM_RTOL})")


#: K7's and K9's routes held on the card: (shape, R, k, offset of the leaf
#: in its buffer, route) — whole 16-byte vectors per row-block (with a
#: ragged last block at R = 3), odd widths, the 1-D be = 1, a leaf off 16
#: bytes
ROWS_ROUTE_CASES = (((301, 64), 1, 4, 0, "vector"),
                    ((301, 64), 3, 2, 0, "vector"),
                    ((301, 67), 1, 4, 0, "scalar"),
                    ((896,), 1, 4, 0, "scalar"),
                    ((301, 64), 1, 4, 1, "scalar"))


def check_rows_routes(torch, kr) -> int:
    """K7 and K9 in place on both routes, f32/bf16/f16 ×
    gaussian/rademacher, every phase: bitwise their plain versions, one
    launch counted under the route ``rows_route`` names, and the buffer
    around the leaf untouched; then 70 K9 streams on the vector route (two
    launches).  Returns the number of cases."""
    from repro_torch.kernels import _build
    g = torch.Generator(device="cuda").manual_seed(19)
    cases = 0
    for shape, R, k, off, route in ROWS_ROUTE_CASES:
        n = 1
        for d in shape:
            n *= d
        be = R * (n // shape[0] if len(shape) > 1 else 1)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            base = torch.randn(n + 16, generator=g, device="cuda").to(dt)
            x = base[off:off + n].view(shape)
            for dist in ("gaussian", "rademacher"):
                for ph in range(k):
                    for name, run, plain in (
                            ("zo_affine_rows",
                             lambda y: kr.zo_affine_rows(
                                 y, SEEDS8[0], A8[0], B8[0], be, k, ph, dist,
                                 out=y),
                             lambda: kr.zo_affine_rows_plain(
                                 x, SEEDS8[0], A8[0], B8[0], be, k, ph,
                                 dist)),
                            ("zo_affine_chain_rows",
                             lambda y: kr.zo_affine_chain_rows(
                                 y, SEEDS8, A8, B8, be, k, ph, dist, out=y),
                             lambda: kr.zo_affine_chain_rows_plain(
                                 x, SEEDS8, A8, B8, be, k, ph, dist))):
                        buf = base.clone()
                        y = buf[off:off + n].view(shape)
                        what = (f"{name} {shape} R={R} k={k} phase={ph} "
                                f"offset={off} {dt} {dist}")
                        if kr.rows_route(y, be) != route:
                            fail(f"{what}: rows_route says "
                                 f"{kr.rows_route(y, be)}, not {route}")
                        _build.reset_launch_counts()
                        run(y)
                        if _build.route_counts != {f"{name}/{route}": 1}:
                            fail(f"{what}: launched {_build.route_counts}")
                        if not same_bits(y, plain()):
                            fail(f"{what}: kernel != plain")
                        if not (same_bits(buf[:off], base[:off]) and same_bits(
                                buf[off + n:], base[off + n:])):
                            fail(f"{what}: wrote outside the leaf")
                        cases += 1
    x = torch.randn(301, 64, generator=g, device="cuda").to(torch.bfloat16)
    _build.reset_launch_counts()
    got = kr.zo_affine_chain_rows(x, list(range(70)), [0.999] * 70,
                                  [1e-3] * 70, 64, 4, 1)
    if _build.route_counts != {"zo_affine_chain_rows/vector": 2}:
        fail(f"K9 with 70 streams: launched {_build.route_counts}")
    if not same_bits(got, kr.zo_affine_chain_rows_plain(
            x, list(range(70)), [0.999] * 70, [1e-3] * 70, 64, 4, 1)):
        fail("K9 with 70 streams on the vector route != plain")
    _build.reset_launch_counts()
    return cases + 1


def _hold_rows(torch, kr, x, be, k, ph, dist, what) -> None:
    s, a, b = SEEDS8, A8, B8
    y = x.clone()
    kr.zo_affine_rows(y, s[0], a[0], b[0], be, k, ph, dist, out=y)
    pairs = (
        ("K7", y, lambda: kr.zo_affine_rows_plain(x, s[0], a[0], b[0], be, k,
                                                  ph, dist)),
        ("K8", kr.zo_affine_multi_rows(x, s, a, b, be, k, ph, dist),
         lambda: kr.zo_affine_multi_rows_plain(x, s, a, b, be, k, ph, dist)),
        ("K9", kr.zo_affine_chain_rows(x, s, a, b, be, k, ph, dist),
         lambda: kr.zo_affine_chain_rows_plain(x, s, a, b, be, k, ph, dist)),
        ("K10", kr.zo_sqnorm_rows(x.numel(), s[1], be, k, ph, dist, "cuda"),
         lambda: kr.zo_sqnorm_rows_plain(x.numel(), s[1], be, k, ph, dist,
                                         "cuda")))
    for name, got, plain in pairs:
        if not same_bits(got, plain()):
            fail(f"{name} {what}: kernel != plain")
        del got


def check_k12(torch, kp, L: int, n_blocks: int, D: int,
              max_len: int = MAX_LEN) -> None:
    """K12 vs plain, bitwise, with the table on the host and on the card,
    on a pool of ``n_blocks`` blocks of ``L`` layers × ``D`` values: a
    decode step's random table, repeated ids, one id, the pool's ends."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(L, n_blocks * BLOCK, D, generator=g,
                    device="cuda").to(torch.bfloat16)
    tab = torch.randint(0, n_blocks, (SLOTS * (max_len // BLOCK),),
                        generator=torch.Generator().manual_seed(4))
    tables = [tab, torch.tensor([5, 5, 5, 0, 5]), torch.tensor([7]),
              torch.tensor([n_blocks - 1, 0, n_blocks - 1])]
    for t in tables:
        want = kp.paged_gather_plain(x, t.cuda(), BLOCK)
        for where, table in (("host", t.numpy()),
                             ("device", t.to(torch.int32).cuda())):
            if not same_bits(kp.paged_gather(x, table, BLOCK), want):
                fail(f"K12 paged_gather != plain ({where} table of "
                     f"{t.numel()} ids)")
    log(f"K12 paged_gather: bitwise vs plain with host and device tables "
        f"({len(tables)} tables, up to {tab.numel()} ids, {L} layers, "
        f"{n_blocks} blocks of {BLOCK} rows × {D} bf16)")


_KERNELS = ("flash_fwd_mma", "flash_fwd_sliced", "gather_kernel", "wkv6_fwd",
            "wkv6_tile", "zo_affine_kernel", "chain_kernel", "fanout_kernel",
            "selftest_kernel", "rows_tile_sums", "rows_fold_leaves",
            "sqnorm_rows_tiles", "tile_sums", "fold_leaves",
            "affine_rows_kernel", "chain_rows_kernel", "multi_rows_kernel",
            "threefry_kernel", "whole_kernel", "orig_bands_kernel",
            "orig_kernel", "bands_kernel",
            "probe_kernel", "table_kernel", "normal_f32_kernel")
_TARG = re.compile(r"13__nv_bfloat16|6__half|f|Li(-?\d+)E|Lb([01])E")


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name as ``name<template args>``."""
    m = re.search("|".join(_KERNELS), mangled)
    if not m:
        return mangled
    rest, args, i = mangled[m.end():], [], 1
    if not rest.startswith("I"):
        return m.group(0)
    while i < len(rest) and rest[i] != "E":
        t = _TARG.match(rest, i)
        if not t:
            break
        args.append({"13__nv_bfloat16": "bf16", "6__half": "f16",
                     "f": "f32"}.get(t.group(0)) or t.group(1)
                    or ("true" if t.group(2) == "1" else "false"))
        i = t.end()
    return f"{m.group(0)}<{', '.join(args)}>"


def ptxas_facts(_build, lib: str, log_text=None) -> dict:
    """{kernel: "N registers, …; spills"} from ``-Xptxas -v``'s output."""
    fn, facts = None, {}
    for line in (log_text or _build.build_log(lib)).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = kernel_name(m.group(1))
        elif fn and ("registers" in line or "spill" in line):
            facts.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in facts.items()}


def build_facts(_build) -> None:
    """What the compiler made of K1–K6, K10, K11 and K12: ``-Xptxas -v``'s
    registers, shared memory and spills per device function (every K2 and
    K11 instance), and the HMMA (tensor-core) instructions in K2's SASS,
    read with ``cuobjdump`` — every mma instance must have some."""
    for lib in ("flash_attention", "wkv6", "paged_gather", "zo_affine",
                "zo_multi", "zo_sqnorm", "zo_rows"):
        for fn, facts in sorted(ptxas_facts(_build, lib).items()):
            if lib in ("zo_affine", "zo_multi") and "bf16, 0" not in fn:
                continue
            if lib == "zo_rows" and not fn.startswith("rows_"):
                continue
            log(f"ptxas {lib} {fn}: {facts}")
    hmma = {}
    for name, instrs in sass_of(_build.lib_path("flash_attention")).items():
        hmma[kernel_name(name)] = sum(1 for _, op, _ in instrs if op == "HMMA")
    mma = {k: v for k, v in hmma.items() if k.startswith("flash_fwd_mma")}
    if len(mma) != 28 or min(mma.values()) == 0:
        fail(f"K2's mma kernels lack tensor-core instructions: {hmma}")
    log("HMMA instructions in K2's SASS (cuobjdump): "
        + ", ".join(f"{k} {v}" for k, v in sorted(hmma.items())))


# SASS opcodes by the pipe that executes them; U-prefixed opcodes run on
# the uniform datapath ("uniform"), and every other opcode (LOP3, IADD3,
# SHF, ISETP, FSETP, FSEL, SEL, FMNMX, PRMT, LEA, MOV, F2FP, …) is "alu".
# F2FP shares the ALU pipe with LOP3 and VIADD runs beside it on the IMAD
# pipe (X1's pipe probes, ``check_pipes``).
SASS_GROUPS = (
    ("mufu", ("MUFU",)),
    ("conversion", ("I2F", "F2I", "FRND", "F2F", "I2FP", "F2IP", "I2I")),
    ("imad", ("IMAD", "VIADD")),
    ("fp32", ("FFMA", "FMUL", "FADD", "FSWZADD", "HFMA2", "HMUL2",
              "HADD2")),
    ("memory", ("LDG", "STG", "LDS", "STS", "LDC", "LDL", "STL", "LD", "ST",
                "LDGSTS", "LDSM")),
    ("control", ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "NOP",
                 "WARPSYNC", "BAR", "JMP", "BPT")),
)
#: lanes per SM partition of each pipe (a warp-instruction occupies its pipe
#: 32 / lanes cycles): ALU and IMAD at 16 (half the issue rate), as X1's
#: pipe probes measure; FP32 at 32; conversions and MUFU at 4 (16 results
#: per SM per clock, the CUDA C++ Programming Guide's arithmetic-throughput
#: table for compute capability 9.0).  Memory, control and uniform
#: instructions count to issue only.
PIPE_LANES = {"alu": 16, "imad": 16, "fp32": 32, "conversion": 4, "mufu": 4}


def sass_group(op: str) -> str:
    if op.startswith("U"):
        return "uniform"
    return next((g for g, ops in SASS_GROUPS if op in ops), "alu")


def pipe_floor(c: dict) -> tuple:
    """(issue slots per z of a warp that the busiest of the issue port and
    the pipes needs, its name): the instructions per z, or each pipe's
    instructions per z × 32 / its lanes, whichever is largest."""
    slots = {"issue": c["total"]}
    slots.update({g: c[g] * 32 / lanes for g, lanes in PIPE_LANES.items()})
    name = max(slots, key=slots.get)
    return slots[name], name


def floors_text(n_z: float, c: dict, mhz: float, measured=None) -> str:
    """The issue floor and the pipe floor of ``n_z`` z at ``c``'s counts,
    which of them binds, and the share of the pipe floor ``measured`` ms
    reaches."""
    issue = issue_floor_ms(n_z, c["total"], mhz)
    slots, name = pipe_floor(c)
    pipe = issue_floor_ms(n_z, slots, mhz)
    return (f"issue floor {issue:.3f} ms, pipe floor {pipe:.3f} ms ({name} "
            f"binds: {slots:.2f} issue slots per z — alu {c['alu']:.2f} and "
            f"imad {c['imad']:.2f} instructions per z at 16 lanes)"
            + ("" if measured is None else
               f", {100 * pipe / measured:.0f}% of the pipe floor reached"))
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)([^;]*);")


def sass_of(lib_path) -> dict:
    """{mangled kernel name: [(address, opcode, operands)]} from
    ``cuobjdump -sass`` of a built library."""
    cuobj = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobj, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib_path} failed: {out.stderr[-500:]}")
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS_LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def sass_loop(instrs, innermost: bool = False) -> dict:
    """Instructions of a z kernel's hot loop, counted per z by unit.

    The hot loop is the backward branch's span that holds the most
    ``MUFU.RSQ`` (one per gaussian z: the sqrt of Box–Muller), the shortest
    such span on a tie; per-z counts are the span's counts over that number
    of RSQs (per element for K1, per stream and element for K3).  With
    ``innermost`` only spans that hold no other backward branch's span
    count (K6, whose z loops sit inside a loop over tiles)."""
    spans = []
    for addr, op, rest in instrs:
        if op != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if m and int(m.group(1), 16) <= addr:
            spans.append((int(m.group(1), 16), addr))
    if innermost:
        spans = [(lo, hi) for lo, hi in spans
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in spans)]
    best = None
    for lo, addr in spans:
        body = [(o, r) for a, o, r in instrs if lo <= a <= addr]
        rsq = sum(1 for o, r in body if o == "MUFU" and r.startswith(".RSQ"))
        key = (rsq, -len(body))
        if rsq and (best is None or key > best[0]):
            best = (key, body)
    if best is None:
        return {}
    (rsq, _), body = best
    counts = {g: 0 for g, _ in SASS_GROUPS}
    counts.update(alu=0, uniform=0)
    for op, _ in body:
        counts[sass_group(op)] += 1
    per_z = {g: n / rsq for g, n in counts.items()}
    per_z["total"] = len(body) / rsq
    per_z["rsq_in_loop"] = rsq
    return per_z


def sass_report(lib_path, kernels: dict) -> dict:
    """{label: per-z counts} for each ``kernels[label]`` = a regex matched
    against the mangled names in the library's SASS (K6's innermost z
    loop, ``SASS_INNERMOST``)."""
    funcs = sass_of(lib_path)
    rep = {}
    for label, pat in kernels.items():
        names = [n for n in funcs if re.search(pat, n)]
        if len(names) != 1:
            fail(f"SASS: {pat!r} matches {names} in {lib_path}")
        rep[label] = sass_loop(funcs[names[0]],
                               innermost=pat in SASS_INNERMOST)
        if not rep[label]:
            fail(f"SASS: no loop with MUFU.RSQ in {names[0]}")
    return rep


def sass_line(label: str, c: dict) -> str:
    return (f"{label}: {c['total']:.2f} SASS instructions per z in the hot "
            "loop — " + ", ".join(f"{g} {c[g]:.2f}" for g in
                                  ("fp32", "alu", "imad", "conversion",
                                   "mufu", "memory", "control", "uniform"))
            + f" ({c['rsq_in_loop']} z per loop iteration)")


#: every z kernel's gaussian (bf16 where it has a dtype) device function:
#: launch-count name -> (library, regex of its mangled name)
Z_KERNEL_SASS = {
    "zo_affine": ("zo_affine", r"zo_affine_kernel.*13__nv_bfloat16Li0E"),
    "zo_affine_chain": ("zo_multi", r"chain_kernel.*13__nv_bfloat16Li0E"),
    "zo_affine_multi": ("zo_multi", r"fanout_kernel.*13__nv_bfloat16Li0E"),
    "zo_affine_batched": ("zo_multi", r"fanout_kernel.*13__nv_bfloat16Li0E"),
    "zo_sqnorm": ("zo_sqnorm", r"tile_sumsILi0E"),   # this tree's and the parent's
    "zo_affine_rows": ("zo_rows", r"affine_rows_kernel.*13__nv_bfloat16Li0E"),
    "zo_affine_multi_rows": ("zo_rows",
                             r"multi_rows_kernel.*13__nv_bfloat16Li0E"),
    "zo_affine_chain_rows": ("zo_rows",
                             r"chain_rows_kernel.*13__nv_bfloat16Li0E"),
    "zo_sqnorm_rows": ("zo_rows", r"rows_tile_sumsILi0E"),
}
#: K10 of a parent tree that measures one leaf per call
PARENT_K10_SASS = r"sqnorm_rows_tilesILi0E"


#: kernels whose z loops sit inside a loop over tiles: counted innermost
SASS_INNERMOST = (Z_KERNEL_SASS["zo_sqnorm"][1],
                  Z_KERNEL_SASS["zo_sqnorm_rows"][1])


def issue_floor_ms(n_z: float, per_z: float, mhz: float) -> float:
    """The least ms the card takes to issue ``per_z`` SASS instructions for
    each of ``n_z`` z: 4 warp-instructions of 32 threads per SM per clock
    on 132 SMs."""
    return n_z * per_z / (4 * 32 * 132 * mhz * 1e6) * 1e3


def sm_clocks() -> tuple:
    """(current, max) SM clock in MHz as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    cur, mx = (float(v) for v in out.stdout.strip().splitlines()[0].split(","))
    return cur, mx


def build_parent_libs(_build, parent: Path) -> dict:
    """K1's, K3–K5's, K6's, K7–K10's, K11's and X1's libraries built from
    another checkout's
    sources (the parent commit, unpacked with ``git archive``)
    with this tree's flags, into ``build/parent_kernels``; {library name:
    path}."""
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    kern = parent / "src" / "repro_torch" / "kernels"
    procs, paths = [], {}
    srcs = {name: kern / _build.SOURCES[name][0]
            for name in ("zo_affine", "zo_multi", "zo_sqnorm", "zo_rows",
                         "wkv6", "zo_threefry")}
    for name, path in srcs.items():
        lib = out_dir / f"{name}.so"
        flags = _build.SOURCES[name][1]
        cmd = [_build._nvcc(), *_build._FLAGS, *flags, "-o", str(lib),
               str(path)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)))
        paths[name] = lib
    for name, p in procs:
        log_text, _ = p.communicate()
        if p.returncode != 0:
            fail(f"building the parent's {name}: {log_text[-2000:]}")
        (out_dir / f"{name}.log").write_text(log_text)
    return paths


# --------------------------------------------------------------------------- #
# The serving path (ledger replay + paged engine)
# --------------------------------------------------------------------------- #
def plain_replay(params, led, np):
    """The ledger replay with K1's plain version on the card — the same
    coefficients as ``CounterBackend.apply_rank1`` (f32 scalars)."""
    from repro_torch.kernels.zo_fused.kernel import zo_affine_plain
    from repro_torch.perturb.stream import (StreamRef, leaf_seed, prng_key,
                                            step_key)
    from repro_torch.tree_utils import is_floating, tree_leaves
    f32 = np.float32
    base = prng_key(led.base_seed)
    for step, g, lr in zip(led.steps, led.grads, led.lrs):
        seed = StreamRef(step_key(base, step)).counter_seed()
        a = float(f32(1.0) - f32(lr) * f32(0.0))
        b = float(-(f32(lr) * f32(g)))
        for i, p in enumerate(tree_leaves(params)):
            if is_floating(p):
                zo_affine_plain(p, leaf_seed(seed, i), a, b, out=p)


def workload(np, vocab: int):
    rng = np.random.default_rng(11)
    tpl = [int(t) for t in rng.integers(1, vocab - 1, TEMPLATE_LEN)]
    return [tpl + [int(t) for t in rng.integers(1, vocab - 1,
                                                int(rng.integers(8, 41)))]
            for _ in range(N_REQUESTS)]


def serve(cfg, params, prompts, prefix_cache: bool, new_tokens=NEW_TOKENS,
          max_len=MAX_LEN):
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=max_len, block=BLOCK,
                      prefix_cache=prefix_cache, device="cuda")
    reqs = [Request(i, p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    wall = time.perf_counter() - t0
    return eng, reqs, wall


# substrings of cuBLAS's GEMM kernel names (sm90 xmma / cutlass / nvjet)
GEMM_TAGS = ("gemm", "xmma", "cutlass", "nvjet")


def device_busy(torch, fn, n: int = 1) -> tuple:
    """(wall ms, kernel ms, launches, top kernels) per call of ``fn`` under
    torch.profiler; kernel ms is 0 when the profiler saw no kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n
    launches = sum(e.count for e in kern) / n
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    tops = ", ".join(f"{e.key[:40]} {e.self_device_time_total / n / 1e3:.3f}"
                     " ms" for e in top)
    gemm = [e for e in kern if any(t in e.key.lower() for t in GEMM_TAGS)]
    tops += (f"; cuBLAS GEMMs "
             f"{sum(e.self_device_time_total for e in gemm) / n / 1e3:.3f} "
             f"ms ({sum(e.count for e in gemm) / n:.0f} launches)")
    # the port's own kernels: csrc/*.cu define them in anonymous namespaces
    # (a template's name starts with its return type; PyTorch's name at::)
    ours = sorted((e for e in kern
                   if e.key.removeprefix("void ").startswith(
                       "(anonymous namespace)::") and "at::" not in e.key),
                  key=lambda e: -e.self_device_time_total)
    if ours:
        tops += "; the port's kernels: " + ", ".join(
            f"{_short_kernel(e.key)} {e.self_device_time_total / n / 1e3:.3f}"
            f" ms ({e.count / n:.0f} launches)" for e in ours)
    return wall_ms, dev_ms, launches, tops


def kernel_sum_ms(torch, fn, n: int = 10) -> tuple:
    """(ms of kernels, kernel launches the profiler saw) per call of
    ``fn``: torch.profiler over ``n`` calls, each synchronized.  (No
    profiler schedule: under one, each step's range is reported as a
    device event of its own, as long as the step.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern) / 1e3 / n,
            sum(e.count for e in kern) / n)


def _short_kernel(key: str) -> str:
    """A profiler kernel name without its namespaces and arguments."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("::")[-1].removeprefix("void ").strip()


def busy_line(what: str, wall_ms, dev_ms, launches, tops) -> str:
    if dev_ms == 0:
        return (f"{what}: {wall_ms:.2f} ms wall; device time not measured "
                "(the profiler saw no kernels)")
    return (f"{what}: {wall_ms:.2f} ms wall, {dev_ms:.2f} ms of kernels "
            f"({100 * dev_ms / wall_ms:.1f}% device busy), {launches:.0f} "
            f"kernel launches; top: {tops}")


def profile_decode(torch, cfg, params, prompts) -> str:
    """Device-busy share of steady decode steps (outside the counted run)."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN, block=BLOCK,
                      device="cuda")
    for i, p in enumerate(prompts[:SLOTS]):
        eng.submit(Request(i, p, max_new_tokens=NEW_TOKENS))
    eng.step()                        # admission (cold prefill) + decode
    eng.step()
    return busy_line(f"decode step ({SLOTS} slots, T={MAX_LEN})",
                     *device_busy(torch, eng.step, 3))


def serving_path(torch, np, cfg, params, twin, card, _build, counts):
    """PR 11's path: replay a 4-record ledger through K1, serve through the
    paged engine (K2 on cold prefill, K12 on prefix hits and decode)."""
    from repro_torch.core import TrajectoryLedger, replay
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import tree_leaves
    led = TrajectoryLedger(base_seed=7, grad_dtype="float32",
                           backend="pallas+z2")
    rng = np.random.default_rng(5)
    for step in range(N_RECORDS):
        led.append(step, float(rng.standard_normal()), 1e-5)
    led = TrajectoryLedger.from_bytes(led.to_bytes())
    prompts = workload(np, cfg.vocab_size)
    warm_eng, _, _ = serve(cfg, params, prompts[:1], True)   # cuBLAS warm-up
    del warm_eng

    _build.reset_launch_counts()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    replay(params, led, composition_for_ledger(led))
    e1.record()
    torch.cuda.synchronize()
    replay_ms = e0.elapsed_time(e1) / N_RECORDS
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, wall = serve(cfg, params, prompts, True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    add_counts(counts, _build, ("zo_affine", "flash_attention",
                                "paged_gather"), "serve")

    k1_plain_ms = host_ms(lambda: plain_replay(twin, led, np)) / N_RECORDS
    for a, b in zip(tree_leaves(params), tree_leaves(twin)):
        if not same_bits(a, b):
            fail("K1 ledger replay != the plain replay on the card")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)):
        fail("replayed params are not finite")
    log(f"ledger replay: {N_RECORDS} pallas+z2 records, {replay_ms:.3f} ms "
        f"per record through K1 on the serving path ({k1_plain_ms:.1f} ms "
        f"plain), bitwise equal")
    ids_on = [r.out_ids for r in reqs]
    if any(len(ids) != NEW_TOKENS for ids in ids_on):
        fail("a request did not produce its tokens")
    # bf16: the warm path (prefix KV from the pool, chunked attention) and
    # the cold path (K2 over the whole prompt) round differently, and random
    # weights give near-flat logits, so greedy ids may flip on near-ties —
    # reported, not asserted.  The identity contract is held in f32, as the
    # JAX package's own paged-engine tests hold it.
    _, reqs_off, _ = serve(cfg, params, prompts, False)
    same_bf16 = sum(a == b for r, o in zip(reqs, reqs_off)
                    for a, b in zip(r.out_ids, o.out_ids))
    cfg32 = cfg.replace(dtype="float32")
    params32 = _cast_tree(params, torch.float32)
    ids32 = {}
    for pc in (True, False):
        eng32, reqs32, _ = serve(cfg32, params32, prompts, pc)
        ids32[pc] = [r.out_ids for r in reqs32]
        if pc and eng32.prefix_stats()["prefix_hits"] == 0:
            fail("the f32 run never hit the prefix cache")
    if ids32[True] != ids32[False]:
        fail("f32 token ids differ with the prefix cache on and off")
    del params32, eng32
    log(f"prefix cache on vs off: f32 ids identical ({tokens_of(ids32[True])}"
        f" tokens); bf16 ids agree on {same_bf16}/{tokens_of(ids_on)}")
    ps = eng.prefix_stats()
    tokens = tokens_of(ids_on)
    ttft = sorted(r.times["prefill"] - r.times["queued"] for r in reqs)
    log(f"served {len(reqs)} requests / {tokens} tokens in {wall:.3f} s: "
        f"{tokens / wall:.1f} tok/s, TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f}"
        f" ms, peak memory {peak / 2**30:.2f} GiB, prefill "
        f"{ps['prefill_tokens_computed']}/{ps['prefill_tokens_submitted']} "
        f"tokens computed, prefix hit rate {ps['prefix_hit_rate']:.2f} — "
        f"on {card}")
    log(profile_decode(torch, cfg, params, prompts))
    return eng, prompts


# --------------------------------------------------------------------------- #
# The training paths
# --------------------------------------------------------------------------- #
def add_counts(counts: dict, _build, required, path: str) -> None:
    """Read the counts of the path just driven, require its kernels."""
    got = dict(_build.launch_counts)
    for name in required:
        if got[name] == 0:
            fail(f"the {path} path never launched {name}")
    for name, n in got.items():
        counts[name] = counts.get(name, 0) + n
    routes = dict(_build.route_counts)
    for key, n in routes.items():
        counts[key] = counts.get(key, 0) + n
    log(f"{path} path launches: "
        + ", ".join(f"{k} {v}" for k, v in got.items() if v)
        + "".join(f"; {k} {v}" for k, v in sorted(routes.items())))


def rows_route_split(params) -> tuple:
    """(partial leaves, those whose row-block is no whole number of 16-byte
    vectors) of ``params`` under ROWS: the K7 / K9 launches of one pass, and
    those that take the scalar route by their shape (qwen2-0.5b: 15 and the
    1-D ln_f).  The same at every phase, or the run fails."""
    from repro_torch.select import parse_selection
    from repro_torch.tree_utils import is_floating, tree_leaves
    rsel = parse_selection(ROWS)
    leaves = [p for p in tree_leaves(params) if is_floating(p)]
    splits = set()
    for ph in range(rsel.block_mask(leaves[0], 0).k):
        partial = [(p, rb) for p in leaves
                   for rb in [rsel.block_mask(p, ph)]
                   if rb is not None and not rb.all_selected]
        odd = sum(1 for p, rb in partial
                  if min(rb.block_elems, p.numel()) * p.element_size() % 16)
        splits.add((len(partial), odd))
    if len(splits) != 1:
        fail(f"{ROWS}: the partial leaves differ between phases: {splits}")
    return splits.pop()


def check_rows_routes_on_paths(counts: dict, split: tuple) -> None:
    """Every K7 / K9 launch of the qwen2 rows paths on a leaf whose
    row-block is a whole number of 16-byte vectors took the vector route:
    of each pass's ``split[0]`` launches exactly ``split[1]`` are scalar."""
    partial, odd = split
    for name in ("zo_affine_rows", "zo_affine_chain_rows"):
        total = counts.get(name, 0)
        vec = counts.get(f"{name}/vector", 0)
        sca = counts.get(f"{name}/scalar", 0)
        if (total == 0 or total % partial or vec + sca != total
                or sca != total // partial * odd):
            fail(f"{name} on the counted qwen2 paths: {vec} vector and {sca} "
                 f"scalar launches of {total}; {odd} of every {partial} "
                 "should be scalar")
        log(f"{name} over the counted qwen2 paths: {vec} launches on the "
            f"vector route, {sca} on the scalar route ({odd} of the "
            f"{partial} partial leaves of each pass: be·itemsize not a "
            "multiple of 16)")


def make_opts():
    from repro_torch import exec as zexec
    from repro_torch import zo
    return {
        "a_spsa": (lambda: zo.mezo(lr=LR, eps=EPS, backend="pallas"), None),
        "b_fzoo": (lambda: zo.fzoo(lr=LR, eps=EPS, batch_seeds=B_SEEDS,
                                   backend="pallas"), None),
        "c_sphere": (lambda: zo.fzoo(lr=LR, eps=EPS, batch_seeds=B_SEEDS,
                                     dist="sphere", backend="pallas"), None),
        "d_sp2": (lambda: zo.mezo(lr=LR, eps=EPS, backend="pallas"),
                  lambda: zexec.seed_parallel(2)),
        "e_rows_spsa": (lambda: zo.mezo(lr=LR, eps=EPS, backend="pallas",
                                        selection=ROWS), None),
        "f_rows_fzoo": (lambda: zo.fzoo(lr=LR, eps=EPS, batch_seeds=B_SEEDS,
                                        backend="pallas", selection=ROWS),
                        None),
        "g_rows_sphere": (lambda: zo.fzoo(lr=LR, eps=EPS,
                                          batch_seeds=B_SEEDS, dist="sphere",
                                          backend="pallas", selection=ROWS),
                          None),
        "h_lora": (lambda: zo.mezo(lr=LR, eps=EPS, backend="pallas",
                                   selection="peft(lora)"), None),
    }


SSM_STEPS = {"i_ssm_spsa": 10}
ALL_STEPS = {**STEPS, **SSM_STEPS, **XLA_STEPS, **PAPER_STEPS, **MOE_STEPS,
             **FAMILY_STEPS, "y_shim": Y_STEPS}

REQUIRED = {"i_ssm_spsa": ("zo_affine", "wkv6_chunked"),
            "j_xla_spsa": ("zo_affine_threefry", "flash_attention"),
            "j_xla_orig": ("zo_affine_threefry_original", "flash_attention"),
            "k_roberta_acc": ("zo_affine_threefry",),
            "l_opt13b_spsa": ("zo_affine_threefry", "flash_attention"),
            "m_opt13b_f1": ("zo_affine_threefry", "flash_attention"),
            "n_opt30b_spsa": ("zo_affine_threefry", "flash_attention"),
            "s_granite_spsa": ("zo_affine_threefry", "flash_attention"),
            "s_granite_orig": ("zo_affine_threefry_original",
                               "flash_attention"),
            "t_mixtral_spsa": ("zo_affine_threefry", "flash_attention"),
            "u_hymba_spsa": ("zo_affine_threefry", "flash_attention"),
            "u_hymba_pallas": ("zo_affine", "flash_attention"),
            "w_whisper_spsa": ("zo_affine_threefry", "flash_attention"),
            "a_spsa": ("zo_affine", "flash_attention"),
            "b_fzoo": ("zo_affine_batched", "zo_affine_chain",
                       "flash_attention"),
            "c_sphere": ("zo_sqnorm", "zo_affine_multi", "zo_affine_chain",
                         "flash_attention"),
            "d_sp2": ("zo_affine_chain", "zo_affine", "flash_attention"),
            "e_rows_spsa": ("zo_affine_rows", "flash_attention"),
            "f_rows_fzoo": ("zo_affine_multi_rows", "zo_affine_chain_rows",
                            "flash_attention"),
            "g_rows_sphere": ("zo_sqnorm_rows", "zo_affine_multi_rows",
                              "zo_affine_chain_rows", "flash_attention"),
            "h_lora": ("zo_affine", "flash_attention")}


class StepClock:
    """HeartbeatMonitor that keeps the host-clock gap between beats (one
    step each: the step's losses sync the card)."""

    def __init__(self):
        from repro_torch.train.loop import HeartbeatMonitor
        self.mon = HeartbeatMonitor()
        self.dts = []
        self.mon.on_beat = lambda step, dt: self.dts.append(dt)


def train_phase(torch, cfg, params0, name, make_opt, make_plan, _build,
                counts, loss_fn=None, pipe=None, in_place=False,
                with_ckpt=True):
    """``ALL_STEPS[name]`` steps through ``train.loop.train`` with a ledger
    (and, ``with_ckpt``, a checkpoint directory), on a copy of θ₀ or, with
    ``in_place``, on θ₀ itself; the lm stream and CE unless ``pipe`` /
    ``loss_fn`` are given.  Returns (θ, ledger, optimizer, ms per step)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import TrajectoryLedger
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.exec import StepProgram
    from repro_torch.models import bundle
    from repro_torch.models.peft import peft_loss_fn
    from repro_torch.train.loop import train
    steps = ALL_STEPS[name]
    params = params0 if in_place else _clone_tree(params0)
    if loss_fn is None:
        loss_fn = (peft_loss_fn(cfg, "lora") if name == "h_lora"
                   else bundle(cfg).loss_fn())
    opt = make_opt()
    prog = StepProgram(opt, make_plan()) if make_plan else opt
    ledger = TrajectoryLedger(base_seed=SEED, grad_dtype="float32",
                              backend=opt.backend_name,
                              batch_seeds=opt.batch_seeds)
    run = RUN_DIR / name
    ckpt = None
    if with_ckpt:
        shutil.rmtree(run, ignore_errors=True)
        ckpt = CheckpointManager(str(run), interval=10**9)
    if pipe is None:
        pipe = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                 vocab=cfg.vocab_size, seed=SEED),
                        device="cuda")
    clock = StepClock()
    _build.reset_launch_counts()
    res = train(loss_fn, params, prog, pipe,
                total_steps=steps, ckpt=ckpt, ledger=ledger,
                monitor=clock.mon, log_every=1, seed=SEED)
    torch.cuda.synchronize()
    add_counts(counts, _build, REQUIRED[name], f"train {name}")
    if ckpt is not None:
        saved = ckpt.load_ledger()
        if saved is None or saved.to_bytes() != ledger.to_bytes():
            fail(f"{name}: the ledger on disk != the run's ledger")
        if not ckpt.steps() == [steps]:
            fail(f"{name}: no final checkpoint at step {steps}")
        shutil.rmtree(run)
    losses = [loss for _, loss in res.losses]
    if len(losses) != steps or not all(
            map(lambda v: v == v and abs(v) < 1e30, losses)):
        fail(f"{name}: losses not finite: {losses}")
    timed = clock.dts[1:] or clock.dts           # a one-step run: its step
    step_ms = 1e3 * sum(timed) / max(1, len(timed))
    tok_s = pipe.spec.batch * pipe.seq_len / (step_ms / 1e3)
    log(f"train {name}: {steps} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, {step_ms:.1f} ms per step "
        f"({'steps 2..' if steps > 1 else 'the one step'}), "
        f"{tok_s:.0f} batch tokens/s, ledger {ledger.to_bytes()[:5].decode()} "
        f"{ledger.nbytes()} bytes")
    return res.params, ledger, opt, step_ms


def ulp_diff(torch, a, b) -> tuple:
    """(max difference in bf16 ulps at the magnitude the chain rounds at,
    max(|a|, |b|) + ε·Z_MAX; share of differing elements; max abs
    difference) of two bf16 leaves."""
    worst, n_diff, worst_abs = 0.0, 0, 0.0
    fa, fb = a.reshape(-1), b.reshape(-1)
    for lo in range(0, fa.numel(), CHUNK):          # f32 temporaries of a
        af = fa[lo:lo + CHUNK].float()              # chunk, not the leaf
        bf = fb[lo:lo + CHUNK].float()
        m = torch.maximum(af.abs(), bf.abs()) + EPS * Z_MAX
        _, e = torch.frexp(m)
        ulp = torch.ldexp(torch.ones_like(m), e - 8)
        d = (af - bf).abs()
        ulps = torch.where(d > 0, d / ulp, torch.zeros_like(d))
        worst = max(worst, ulps.max().item())
        n_diff += int((d > 0).sum())
        worst_abs = max(worst_abs, d.max().item())
    return worst, n_diff / max(1, fa.numel()), worst_abs


def hold_ulps(torch, name, pairs) -> str:
    """Hold (replay, trained) leaf pairs to the sequential-spsa bound of
    ``name`` in bf16 ulps at |θ| + ε·Z_MAX; returns the log text (max
    ulps, max abs difference, share of differing elements)."""
    bound = ULPS_PER_STEP[name] * ALL_STEPS[name]
    worst, worst_abs, n_diff, n_all = 0.0, 0.0, 0.0, 0
    for a, b in pairs:
        u, share, mx = ulp_diff(torch, a, b)
        worst, worst_abs = max(worst, u), max(worst_abs, mx)
        n_diff += share * a.numel()
        n_all += a.numel()
    if worst > bound:
        fail(f"{name}: replay vs trained θ differ by {worst} bf16 ulps (at "
             f"|θ| + ε·{Z_MAX}) > the bound {bound}")
    return (f"max {worst:.2f} bf16 ulps at |θ| + ε·{Z_MAX} (bound "
            f"{bound:.0f}), max abs {worst_abs:.3e}, "
            f"{100 * n_diff / n_all:.3f}% of {n_all} elements differ")


def check_replays(torch, name, params0, trained, ledger, opt_factory):
    from repro_torch.core import replay
    from repro_torch.tree_utils import tree_leaves
    r1 = replay(_clone_tree(params0), ledger, opt_factory())
    r2 = replay(_clone_tree(params0), ledger, opt_factory())
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(r1), tree_leaves(r2)):
        if not same_bits(a, b):
            fail(f"{name}: two replays of the ledger differ")
    pairs = list(zip(tree_leaves(r1), tree_leaves(trained)))
    if name in ULPS_PER_STEP:
        log(f"{name}: replay ≡ replay bitwise; replay vs trained θ: "
            + hold_ulps(torch, name, pairs)
            + " (the live chain rounds θ±εz in bf16)")
    else:
        for a, b in pairs:
            if not same_bits(a, b):
                fail(f"{name}: replay != the trained θ (fzoo's update and "
                     "its replay make the same affine_many call)")
        log(f"{name}: replay ≡ replay ≡ trained θ, bitwise")
    del r2
    return r1


def memory_and_busy(torch, cfg, params0, selection=None, backend="pallas",
                    loss_fn=None, batch=None, opt=None, what=None):
    """Peak device memory of one spsa step vs one forward on the same batch
    (no_grad), on a scratch copy of θ₀; and the device-busy share of a
    step under torch.profiler.  Under a ``selection``, the first step must
    leave every unselected element at θ₀'s bits.  CE on a 16 × 256 lm
    batch unless ``loss_fn`` / ``batch`` are given; ``zo.mezo`` on
    ``backend`` unless ``opt`` (named ``what``) is given."""
    from repro_torch import zo
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import bundle
    base = torch.cuda.memory_allocated()
    params = _clone_tree(params0)
    if batch is None:
        batch = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                  vocab=cfg.vocab_size, seed=SEED),
                         device="cuda").batch(0)
    loss_fn = loss_fn or bundle(cfg).loss_fn()
    if opt is None:
        opt = zo.mezo(lr=LR, eps=EPS, backend=backend, selection=selection)
        what = "spsa" if selection is None else f"spsa {selection}"
        if backend != "pallas":
            what += f" on {backend}"
    state = opt.init(params, seed=SEED)
    step = opt.step_fn(loss_fn)
    with torch.no_grad():
        loss_fn(params, batch).item()                    # warm-up
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    if selection is not None:
        _check_unselected(torch, opt.selection, params, params0)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        loss_fn(params, batch).item()
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    stp = torch.cuda.max_memory_allocated() - base
    if stp > MEM_SLACK * fwd:
        fail(f"{what} step peak {stp / 2**30:.3f} GiB > {MEM_SLACK} × one "
             f"forward's {fwd / 2**30:.3f} GiB")
    log(f"memory ({cfg.name}): one {what} step peaks at {stp / 2**30:.3f} "
        f"GiB, one "
        f"forward (no_grad) at {fwd / 2**30:.3f} GiB — ratio {stp / fwd:.4f} "
        "(the parameters under training and the activations, over what was "
        "allocated before)")
    holder = {"p": params, "s": state}

    def one():
        holder["p"], holder["s"], _ = step(holder["p"], holder["s"], batch)

    B, S = batch["tokens"].shape
    line = busy_line(f"one {what} step ({B} × {S} tokens, "
                     f"{cfg.name}, {cfg.n_layers} layers)",
                     *device_busy(torch, one, 2))
    log(line)
    del holder, params
    return stp, fwd


def fzoo_busy(torch, cfg, params0, dist: str = "gaussian") -> None:
    """Kernel time and device-busy share of one fzoo(8) step under
    torch.profiler, on a scratch copy of θ₀ (K5's fan-out and K3's update
    each step; with ``dist="sphere"`` K6's 16 passes, K4 and K3)."""
    from repro_torch import zo
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import bundle
    holder = {"p": _clone_tree(params0)}
    batch = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                              vocab=cfg.vocab_size, seed=SEED),
                     device="cuda").batch(0)
    opt = zo.fzoo(lr=LR, eps=EPS, batch_seeds=B_SEEDS, dist=dist,
                  backend="pallas")
    holder["s"] = opt.init(holder["p"], seed=SEED)
    step = opt.step_fn(bundle(cfg).loss_fn())

    def one():
        holder["p"], holder["s"], _ = step(holder["p"], holder["s"], batch)

    one()
    what = f"fzoo({B_SEEDS})" if dist == "gaussian" else \
        f"fzoo({B_SEEDS}, {dist})"
    log(busy_line(f"one {what} step ({TRAIN_BATCH} × {TRAIN_SEQ} "
                  f"tokens, {cfg.name})", *device_busy(torch, one, 2)))
    del holder


def _check_unselected(torch, sel, params, params0) -> None:
    """After step 0 (phase ``sel.phase_at(0)``) every element the selection
    did not pick holds θ₀'s bits, and the picked ones moved."""
    from repro_torch.tree_utils import tree_leaves
    phase = sel.phase_at(0)
    mask = sel.leaf_mask(params0, phase)
    moved = 0
    for i, (p, p0) in enumerate(zip(tree_leaves(params), tree_leaves(params0))):
        rb = sel.block_mask(p0, phase)
        if not mask[i]:
            picked = torch.zeros(p0.numel(), dtype=torch.bool, device="cuda")
        elif rb is None:                      # a whole selected leaf
            picked = torch.ones(p0.numel(), dtype=torch.bool, device="cuda")
        else:
            e = torch.arange(p0.numel(), device="cuda")
            picked = rb.element_mask(e)
        a, b = bits_of(p).reshape(-1), bits_of(p0).reshape(-1)
        if not torch.equal(a[~picked], b[~picked]):
            fail(f"{sel.spec}: an unselected element of leaf {i} moved in "
                 "step 1")
        moved += int((a[picked] != b[picked]).sum())
    if moved == 0:
        fail(f"{sel.spec}: step 1 moved no selected element")
    log(f"{sel.spec}: after step 1 every unselected element is θ₀'s, "
        f"{moved} selected elements moved")


def serve_finetune(torch, np, cfg, params0, trained_b, ledger_b, prompts,
                   _build, counts, kernels=("zo_affine_chain",),
                   what="fzoo"):
    """Serve the fzoo fine-tune: rebuild the composition from the ledger
    header, replay it (K3) onto θ₀, serve through the paged engine."""
    from repro_torch.core import replay
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import tree_leaves
    params = _clone_tree(params0)
    _build.reset_launch_counts()
    replay(params, ledger_b, composition_for_ledger(ledger_b))
    _, reqs, wall = serve(cfg, params, prompts[:4], True, new_tokens=8)
    torch.cuda.synchronize()
    add_counts(counts, _build, tuple(kernels) + ("flash_attention",
                                                 "paged_gather"),
               f"serve the {what} fine-tune")
    for a, b in zip(tree_leaves(params), tree_leaves(trained_b)):
        if not same_bits(a, b):
            fail(f"the served fine-tune != the trained {what} θ")
    if any(len(r.out_ids) != 8 for r in reqs):
        fail("a fine-tune request did not produce its tokens")
    magic = ledger_b.to_bytes()[:5].decode()
    log(f"served the {what} fine-tune ({len(ledger_b)} {magic} records "
        f"replayed through composition_for_ledger): {len(reqs)} requests, "
        f"{sum(len(r.out_ids) for r in reqs)} tokens in {wall:.3f} s")


# --------------------------------------------------------------------------- #
# X1 and the default stream (``xla``)
# --------------------------------------------------------------------------- #
def check_x1(torch, np) -> float:
    """X1 ``zo_affine_threefry`` on the card: the f32 gaussian over all 2^23
    uniform mantissas and the bf16 / f16 tables against the plain version;
    every dtype × dist × form (with and without a z scale, whole and on a
    band list) on odd widths and a leaf off 16 bytes, bitwise; and z
    against the JAX fixture (``tests/data/x1_golden.npz``).  Returns the max
    abs error (0 when bitwise)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.threefry import kernel as x1
    bad = x1.normal_f32_selftest("cuda")
    tables = {dt: x1.table_selftest(dt, "cuda")
              for dt in (torch.bfloat16, torch.float16)}
    if bad or any(tables.values()):
        fail(f"X1: f32 gaussian differs from the plain version on {bad} of "
             f"2^23 mantissas; table entries differing {tables}")
    g = torch.Generator().manual_seed(3)
    cases = 0
    _build.reset_launch_counts()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for n in (1, 4099, 1_000_003):
            base = torch.randn(n + 1, generator=g).to(dt).cuda()
            for x in (base[:n], base[1:]):           # on and off 16 bytes
                for dist in ("gaussian", "rademacher"):
                    for form in ("z", "axpbz", "xpbz", "restore"):
                        for zs, bands, off in (
                                (None, None, 0), (0.75, None, 0),
                                (None, [(0, n // 3), (n // 2, n)], 0),
                                (None, None, (1 << 32) - n // 2)):
                            xin = None if form == "z" else x
                            kw = dict(a=0.5, b=-0.25, e=0.125, zs=zs,
                                      dist=dist, bands=bands, offset=off)
                            yk = x1.zo_affine_threefry(
                                xin, (7, 2**31 + 5), form, out=x.clone(),
                                **kw)
                            yp = x1.zo_affine_threefry_plain(
                                xin, (7, 2**31 + 5), form, out=x.clone(),
                                **kw)
                            if not same_bits(yk, yp):
                                fail(f"X1 {dt} n={n} {dist} {form} zs={zs} "
                                     f"bands={bands} offset={off}: kernel "
                                     "!= plain")
                            cases += 1
    routes = dict(_build.route_counts)
    if min(routes.get(f"zo_affine_threefry/{r}", 0)
           for r in ("vector", "scalar", "bands")) == 0:
        fail(f"X1's checks missed a route: {routes}")
    gold = np.load(X1_GOLDEN)
    key = tuple(int(k) for k in gold["key"])
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                     ("f16", torch.float16)):
        for dist in ("gaussian", "rademacher"):
            want = gold[f"{dist}_{name}"]
            out = torch.empty(want.shape[0], dtype=dt, device="cuda")
            z = x1.zo_affine_threefry(None, key, "z", dist=dist, out=out)
            if not np.array_equal(z.float().cpu().numpy(), want):
                fail(f"X1 {dist} {name} z != the JAX golden fixture")
    log(f"X1 zo_affine_threefry: the f32 gaussian bitwise the plain version "
        f"over all 2^23 uniform mantissas, the bf16 (256) and f16 (1024) "
        f"tables bitwise; {cases} leaves (f32/bf16/f16 × gaussian/rademacher "
        "× z/axpbz/xpbz/restore × plain, z-scaled, banded, counters across "
        "2^32; odd sizes, off 16 bytes) bitwise, launches by route "
        + ", ".join(f"{k.split('/')[1]} {v}" for k, v in sorted(
            routes.items())) + "; z == the JAX golden fixture (f32/bf16/f16 "
        "× gaussian/rademacher)")
    return 0.0


def x1_sass(lib_path, parent: bool = False) -> dict:
    """X1's hot loop in SASS, by unit, per z, for its bf16 gaussian axpbz
    whole-leaf instance: this tree's 16-byte vector loop — the backward
    branch's span that holds the most table reads (LDS, one per z) — or,
    with ``parent``, the first design's grid-stride loop (the last backward
    branch; one z per iteration)."""
    funcs = sass_of(lib_path)
    pat = (r"threefry_kernelI13__nv_bfloat16Li0ELi1ELb0E" if parent
           else r"whole_kernelI13__nv_bfloat16Li0ELi1EE")
    names = [n for n in funcs if re.search(pat, n)]
    if len(names) != 1:
        fail(f"SASS: X1's bf16 gaussian axpbz kernel not found: {names}")
    instrs = funcs[names[0]]
    spans = []
    for addr, op, rest in instrs:
        m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    best = None
    for lo, hi in spans:
        body = [op for a, op, _ in instrs if lo <= a <= hi]
        nz = 1 if parent else body.count("LDS")
        key = (hi, 0) if parent else (nz, -len(body))
        if nz and (best is None or key > best[0]):
            best = (key, body, nz)
    if best is None:
        fail(f"SASS: no z loop in {names[0]}")
    _, body, nz = best
    counts = {g: 0 for g, _ in SASS_GROUPS}
    counts.update(alu=0, uniform=0)
    for op in body:
        counts[sass_group(op)] += 1
    per_z = {g: v / nz for g, v in counts.items()}
    per_z["total"] = len(body) / nz
    per_z["rsq_in_loop"] = nz
    return per_z


#: X1's pipe probes (``enum Probe`` in zo_threefry.cu): name, and the
#: opcodes whose rate each reads
PIPE_PROBES = (("LOP3", ("LOP3",)), ("SHF", ("SHF",)), ("IADD3", ("IADD3",)),
               ("F2FP", ("F2FP",)), ("IMAD", ("IMAD",)),
               ("VIADD", ("VIADD",)), ("IMAD.HI", ("IMAD",)),
               ("FFMA", ("FFMA",)), ("LOP3+F2FP", ("LOP3", "F2FP")),
               ("LOP3+VIADD", ("LOP3", "VIADD")),
               ("IMAD+VIADD", ("IMAD", "VIADD")),
               ("round", ("IMAD", "IADD3", "SHF", "LOP3")))


def check_pipes(_build, card) -> dict:
    """Each pipe's rate on the card, read from X1's pipe probes: chains of
    one instruction kind (or two interleaved) on every SM, timed with CUDA
    events while nvidia-smi samples the SM clock; the probe loop's opcodes
    counted in its SASS.  Returns {probe: results per SM per clock of its
    opcodes together}: 64 is a pipe of 16 lanes per partition (half the
    issue rate), 128 one of 32; two kinds that share a pipe add up to one
    pipe's rate, two on separate pipes to more."""
    import torch
    from repro_torch.kernels.threefry import kernel as x1
    lib = x1._lib()
    if lib.zo_threefry_probes() != len(PIPE_PROBES):
        fail("X1's pipe probes and PIPE_PROBES differ in number")
    blocks, iters = 132 * 8, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = _build.stream_of(out)
    ms = {}
    with ClockSampler() as clock:
        for i, _ in enumerate(PIPE_PROBES):
            def run(i=i):
                _build.check(lib, lib.zo_threefry_pipe_probe(
                    i, _build.ptr(out), blocks, iters, stream),
                    "zo_threefry_pipe_probe")
            run()
            ms[i] = cuda_ms(run, 10)
    funcs = sass_of(_build.lib_path("zo_threefry"))
    rates, warps = {}, blocks * 256 / 32
    for i, (name, ops) in enumerate(PIPE_PROBES):
        fn = [n for n in funcs if re.search(rf"probe_kernelILi{i}E", n)]
        if len(fn) != 1:
            fail(f"SASS: pipe probe {i} not found: {fn}")
        instrs = funcs[fn[0]]
        spans = [(int(m.group(1), 16), a) for a, op, r in instrs
                 for m in [re.search(r"0x([0-9a-f]+)", r)]
                 if op == "BRA" and m and int(m.group(1), 16) < a]
        lo, hi = max(spans, key=lambda sp: sp[1] - sp[0])
        body = [op for a, op, _ in instrs if lo <= a <= hi]
        n_ops = sum(1 for op in body if op in ops)
        per_clock = (n_ops * iters * warps
                     / (ms[i] * 1e-3 * clock.mhz * 1e6 * 132))
        rates[name] = 32 * per_clock
        log(f"pipe probe {name}: {ms[i]:.4f} ms, {n_ops} of {len(body)} "
            f"loop instructions {'/'.join(ops)}: {32 * per_clock:.1f} results"
            f" per SM per clock = {8 * per_clock:.1f} lanes per partition "
            f"({per_clock / 4 * 100:.0f}% of the issue rate) at "
            f"{clock.mhz:.0f} MHz — on {card}")
    return rates


def plain_replay_xla(params, led, np, selection=None, partitionable=True):
    """The ledger replay with X1's plain version on the card — the scalars
    of ``XLABackend.apply_rank1`` (1 − η·λ with λ = 0, −η·g, each cast to
    the leaf dtype) — on the leaves ``selection`` picks at each step's
    phase (every floating leaf without one), in the given threefry
    layout."""
    from repro_torch.kernels.threefry.kernel import zo_affine_threefry_plain
    from repro_torch.perturb.stream import fold_in, prng_key, step_key
    from repro_torch.perturb.xla import in_dtype
    from repro_torch.tree_utils import is_floating, tree_leaves
    f32 = np.float32
    base = prng_key(led.base_seed)
    for step, g, lr in zip(led.steps, led.grads, led.lrs):
        key = step_key(base, step)
        a = f32(1.0) - f32(lr) * f32(0.0)
        b = -(f32(lr) * f32(g))
        mask = (None if selection is None else
                selection.leaf_mask(params, selection.phase_at(step)))
        for i, p in enumerate(tree_leaves(params)):
            if is_floating(p) and (mask is None or mask[i]):
                zo_affine_threefry_plain(p, fold_in(key, i), "axpbz",
                                         a=in_dtype(a, p.dtype),
                                         b=in_dtype(b, p.dtype), out=p,
                                         partitionable=partitionable)


def other_step_phase(torch, cfg, params0, what, make_opt, steps, batch,
                     fwd_peak, _build, counts, required) -> float:
    """``steps`` steps of an optimizer whose steps a ledger cannot replay
    (the appliers, rescaled SPSA along D·z), on a scratch copy of θ₀:
    finite losses, θ moved; the peak over the steps (the copy of θ and
    every temporary, over what was allocated before, as
    ``memory_and_busy`` counts it) against one forward's is reported.
    Returns the host-clock ms per step (steps 2..)."""
    from repro_torch.models import bundle
    from repro_torch.tree_utils import tree_leaves
    base = torch.cuda.memory_allocated()       # as memory_and_busy's base
    torch.cuda.reset_peak_memory_stats()
    params = _clone_tree(params0)
    opt = make_opt()
    loss_fn = bundle(cfg).loss_fn()
    _build.reset_launch_counts()
    state = opt.init(params, seed=SEED)
    step = opt.step_fn(loss_fn)
    dts, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() - base
    add_counts(counts, _build, required, f"train {what}")
    if not all(v == v and abs(v) < 1e30 for v in losses):
        fail(f"{what}: losses not finite: {losses}")
    moved = sum(int((bits_of(a) != bits_of(b)).sum()) for a, b in zip(
        tree_leaves(params), tree_leaves(params0)))
    if moved == 0:
        fail(f"{what}: {steps} steps moved no parameter")
    ms = 1e3 * sum(dts[1:]) / max(1, len(dts) - 1)
    log(f"train {what}: {steps} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, {ms:.1f} ms per step (steps 2..), {moved} "
        f"elements moved; peak {peak / 2**30:.3f} GiB = "
        f"{peak / fwd_peak:.4f} × one forward's {fwd_peak / 2**30:.3f} GiB "
        "(reported, not gated)")
    del params, state
    return ms


def xla_paths(torch, np, cfg, params0, prompts, _build, counts, step_ms,
              card, x1_err) -> dict:
    """The default stream at qwen2-0.5b's full width: (j) spsa on ``xla``
    through the training loop with a ledger (peak memory gated), its
    ledger replayed through X1 twice and against the plain replay, served
    with the prefix cache on; mezo-adam (recomputed, window 32), trace and
    rescaled SPSA (param_norm, on ``xla`` and on ``pallas``).  Returns X1's
    row of the ``kernels`` line."""
    from repro_torch import zo
    from repro_torch.core import replay
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.kernels.threefry import kernel as x1
    from repro_torch.models import bundle
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import is_floating, tree_leaves
    stp, fwd = memory_and_busy(torch, cfg, params0, backend="xla")
    name = "j_xla_spsa"
    p, led, _, ms = train_phase(
        torch, cfg, params0, name,
        lambda: zo.mezo(lr=LR, eps=EPS, backend="xla"), None, _build, counts)
    step_ms[name] = ms
    if led.backend != "xla" or led.to_bytes()[:5] != b"MZOL2":
        fail(f"{name}: the ledger records {led.backend!r} "
             f"{led.to_bytes()[:5]!r}, not xla MZOL2")
    r1 = check_replays(torch, name, params0, p, led,
                       lambda: zo.mezo(lr=LR, eps=EPS, backend="xla"))
    del p
    plain = _clone_tree(params0)
    plain_replay_xla(plain, led, np)
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(r1), tree_leaves(plain)):
        if not same_bits(a, b):
            fail(f"{name}: the X1 replay != the plain X1 replay")
    del plain
    log(f"{name}: the ledger's replay through X1 ≡ its replay through X1's "
        "plain version on the card, bitwise")
    # serve the fine-tune: the MZOL2 ledger through composition_for_ledger
    served = _clone_tree(params0)
    _build.reset_launch_counts()
    replay(served, led, composition_for_ledger(led))
    _, reqs, wall = serve(cfg, served, prompts[:4], True, new_tokens=8)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention",
                                "paged_gather"), "serve the xla fine-tune")
    for a, b in zip(tree_leaves(served), tree_leaves(r1)):
        if not same_bits(a, b):
            fail("the served xla fine-tune != the ledger's replay")
    if any(len(r.out_ids) != 8 for r in reqs):
        fail("an xla fine-tune request did not produce its tokens")
    log(f"served the xla fine-tune ({len(led)} MZOL2 records replayed "
        f"through composition_for_ledger, prefix cache on): {len(reqs)} "
        f"requests, {sum(len(r.out_ids) for r in reqs)} tokens in "
        f"{wall:.3f} s")
    del served, r1
    # the estimators a ledger cannot replay
    batch = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                              vocab=cfg.vocab_size, seed=SEED),
                     device="cuda").batch(0)
    trace_opt = lambda: zo.ZOOptimizer(  # noqa: E731
        zo.estimators.spsa(eps=EPS, backend="xla"),
        zo.chain(zo.transforms.scale_by_schedule(LR),
                 zo.transforms.trace(window=32)), name="trace")
    for what, make, n, req in (
            ("mezo_adam (recomputed, window 32)",
             lambda: zo.mezo_adam(lr=LR, eps=EPS, window=32, backend="xla"),
             XLA_OTHER_STEPS["mezo_adam"], ("zo_affine_threefry",)),
            ("trace (window 32)", trace_opt, XLA_OTHER_STEPS["trace"],
             ("zo_affine_threefry",)),
            ("rescaled_spsa (param_norm) on xla",
             lambda: zo.mezo_rescaled(lr=LR, eps=EPS, backend="xla"),
             XLA_OTHER_STEPS["rescaled"], ("zo_affine_threefry",)),
            ("rescaled_spsa (param_norm) on pallas",
             lambda: zo.mezo_rescaled(lr=LR, eps=EPS, backend="pallas"),
             XLA_OTHER_STEPS["rescaled"], ("zo_affine",))):
        step_ms[what.split(" ")[0] + ("_pallas" if "pallas" in what
                                      else "")] = other_step_phase(
            torch, cfg, params0, what, make, n, batch, fwd, _build, counts,
            req + ("flash_attention",))
    # X1's time per pass over the 15 leaves: the replay / update write
    leaves = [q for q in tree_leaves(params0) if is_floating(q)]
    scratch = [q.clone() for q in leaves]
    n_all = sum(q.numel() for q in leaves)
    bval = -0.0001220703125                       # a bf16 value: −η·g

    def record(fn=x1.zo_affine_threefry):
        for i, q in enumerate(scratch):
            fn(q, (12345, i), "axpbz", a=1.0, b=bval, out=q)

    with ClockSampler() as clock:
        ms_x1 = cuda_ms(record, 10)
        cuda_ms(record, 60)        # keeps the card busy while it samples
    _build.reset_launch_counts()
    record()
    routes = dict(_build.route_counts)
    plain_ms = host_ms(lambda: record(x1.zo_affine_threefry_plain))
    del scratch
    c = x1_sass(_build.lib_path("zo_threefry"))
    mhz = clock.mhz if clock.mhz == clock.mhz else sm_clocks()[0]
    floor = issue_floor_ms(n_all, c["total"], mhz)
    bms, by = costs.bound_ms([costs.zo_affine_threefry(q.numel(),
                                                       q.element_size())
                              for q in leaves])
    log(sass_line("X1 zo_affine_threefry (bf16 gaussian axpbz)", c))
    log(f"X1 zo_affine_threefry, one pass over the {len(leaves)} qwen2-0.5b "
        f"leaves ({n_all} bf16 elements, gaussian, the replay / update "
        f"write; launches {routes}): {ms_x1:.4f} ms (median of 10 "
        f"CUDA-event pairs), plain version {plain_ms:.1f} ms, bound "
        f"{bms:.4f} ms ({by}); issue floor {floor:.4f} ms at "
        f"{c['total']:.2f} SASS instructions per z and {mhz:.0f} MHz "
        f"({100 * floor / ms_x1:.1f}% of it reached); "
        + floors_text(n_all, c, mhz, ms_x1) + f" — on {card}")
    log("X1 registers / shared memory / spills (gaussian axpbz, whole "
        "leaf): " + "; ".join(f"{k}: {v}" for k, v in sorted(ptxas_facts(
            _build, "zo_threefry").items())
            if k.startswith("whole_kernel") and k.endswith(", 0, 1>")))
    return {"name": "zo_affine_threefry", "route": "cuda",
            "source": "src/repro_torch/kernels/threefry/csrc/zo_threefry.cu",
            "replaces": "src/repro/perturb/xla.py:38", "launches": 0,
            "max_abs_err": x1_err, "ms": ms_x1, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def x1_original_step(torch, np, cfg, params0, _build, counts, step_ms,
                     card) -> None:
    """(j′) qwen2-0.5b spsa on ``xla`` under JAX's original threefry layout
    (X1's ``pairs`` route) at full width: ``XLA_STEPS`` steps through the
    training loop with a ledger; its replay through X1 ≡ the plain replay
    under that layout, bitwise, and within the ulp bound of the trained θ;
    then ms per step in turns with the partitionable layout's step (P O O
    P, ``XLA_TURN_STEPS`` steps a turn on one θ and batch): the host clock
    and the profiler's kernel ms and launches."""
    import statistics
    from repro_torch import zo
    from repro_torch.core import replay
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import bundle
    from repro_torch.perturb.stream import threefry_partitionable
    from repro_torch.tree_utils import tree_leaves

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="xla")

    name = "j_xla_orig"
    with threefry_partitionable(False):
        p, led, _, ms = train_phase(torch, cfg, params0, name, make_opt,
                                    None, _build, counts, with_ckpt=False)
        step_ms[name] = ms
        ro = replay(_clone_tree(params0), led, make_opt())
        plain = _clone_tree(params0)
        plain_replay_xla(plain, led, np, partitionable=False)
        torch.cuda.synchronize()
    for x, y in zip(tree_leaves(ro), tree_leaves(plain)):
        if not same_bits(x, y):
            fail(f"{name}: the X1 original replay != the plain replay")
    text = hold_ulps(torch, name, zip(tree_leaves(ro), tree_leaves(p)))
    del p, ro, plain
    log(f"{name}: {len(led)} spsa steps under the original threefry "
        "layout; the ledger's replay through X1's pairs route ≡ the plain "
        f"replay under that layout, bitwise; vs the trained θ: {text}")
    batch = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                              vocab=cfg.vocab_size, seed=SEED),
                     device="cuda").batch(0)
    loss_fn = bundle(cfg).loss_fn()
    theta = _clone_tree(params0)
    turns = {True: [], False: []}
    for part in (True, False, False, True):
        with threefry_partitionable(part):
            opt = make_opt()
            state = opt.init(theta, seed=SEED)
            step = opt.step_fn(loss_fn)

            def one():
                nonlocal theta, state
                theta, state, _ = step(theta, state, batch)

            one()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(XLA_TURN_STEPS):
                one()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / XLA_TURN_STEPS
            kms, launches = kernel_sum_ms(torch, one, XLA_TURN_STEPS)
        turns[part].append((wall, kms, launches))
    del theta, state
    for part, what in ((False, "original"), (True, "partitionable")):
        ws, ks, ls = zip(*turns[part])
        log(f"qwen2-0.5b spsa step on xla, {what} layout: "
            + ", ".join(f"{w:.1f}" for w in ws) + " ms host clock, "
            + ", ".join(f"{k:.2f}" for k in ks) + " ms of kernels, "
            f"{statistics.mean(ls):.0f} launches a step (turns P O O P, "
            f"{XLA_TURN_STEPS} steps a turn) — on {card}")
    ko = statistics.mean(k for _, k, _ in turns[False])
    kp = statistics.mean(k for _, k, _ in turns[True])
    log(f"qwen2-0.5b spsa step on xla: kernels {ko:.2f} ms under the "
        f"original layout against {kp:.2f} ms under the partitionable "
        f"({ko - kp:+.2f} ms) — on {card}")


# --------------------------------------------------------------------------- #
# K11 and the ssm family (rwkv6-3b)
# --------------------------------------------------------------------------- #
def k11_inputs(torch, g, B, S, H, hd, lw=None):
    """Random r/k/v/u/s0 and log decays −exp(clip(N(0,1), −8, 1)) over the
    model's clamp (or a constant ``lw``): at init u = 0 and the decay is
    constant, which would let a wrong kernel pass."""
    sh = (B, S, H, hd)
    r, k, v = (torch.randn(sh, generator=g, device="cuda") for _ in range(3))
    if lw is None:
        logw = -torch.exp(torch.randn(sh, generator=g, device="cuda")
                          .clamp(-8.0, 1.0))
    else:
        logw = torch.full(sh, lw, device="cuda")
    u = torch.randn(H, hd, generator=g, device="cuda")
    s0 = torch.randn(B, H, hd, hd, generator=g, device="cuda")
    return r, k, v, logw, u, s0


def check_k11(torch, np, kw, ko) -> float:
    """K11 vs its plain version on the card at rwkv6-3b's head shapes (H 40,
    hd 64): the training call (16, 256) at C 16, a single-request prefill
    (1, 252) at C 9, C 1, and the clamp's extremes; repeatable bit for bit;
    and vs the JAX fixture within JAX's tolerance.  Returns the max abs
    error against the plain version at the training shape."""
    g = torch.Generator(device="cuda").manual_seed(12)
    worst = 0.0
    for B, S, C, lw in ((16, 256, 16, None), (1, 252, 9, None),
                        (1, 32, 16, None), (1, 8, 8, None), (1, 40, 8, None),
                        (2, 5, 1, None), (2, 64, 16, -2.718281828459045),
                        (2, 64, 16, -0.00033546262790251185)):
        args = k11_inputs(torch, g, B, S, 40, 64, lw)
        if kw.plan(*args[:4]) != "tile":
            fail(f"K11 ({B}, {S}, 40, 64): planned {kw.plan(*args[:4])}, "
                 "not the tiled route")
        y, s = ko.wkv6(*args, chunk=C)
        yp, sp = ko.wkv6_plain(*args, chunk=C)
        for got, want, what in ((y, yp, "y"), (s, sp, "s_final")):
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if not bool(torch.isfinite(got).all()) or err > K11_REL * scale:
                fail(f"K11 ({B}, {S}, 40, 64) C={C} lw={lw}: {what} max err "
                     f"{err} > {K11_REL} × {scale}")
            if (B, S) == (16, 256):
                worst = max(worst, err)
        again = ko.wkv6(*args, chunk=C)
        if not (same_bits(again[0], y) and same_bits(again[1], s)):
            fail(f"K11 ({B}, {S}) C={C}: two launches differ")
    gold = np.load(WKV6_GOLDEN)
    for i in range(2):
        ins = [torch.from_numpy(gold[f"{n}_{i}"]).cuda()
               for n in ("r", "k", "v", "lw", "u", "s0")]
        y, s = kw.wkv6_chunked(*ins, chunk=int(gold[f"chunk_{i}"]))
        for got, key in ((y, "y"), (s, "s")):
            for ref in (key, f"{key}_ref"):
                want = torch.from_numpy(gold[f"{ref}_{i}"]).cuda()
                if bool(((got - want).abs() > K11_FIX_ATOL
                         + K11_FIX_RTOL * want.abs()).any()):
                    fail(f"K11 fixture case {i}: {ref} beyond JAX's "
                         "tolerance")
    log(f"K11 wkv6_chunked: within {K11_REL} × max|out| of plain at H=40 "
        f"hd=64 on the tiled route (16×256 C=16, max abs err {worst:.3e}; "
        "1×252 C=9; 1×32 C=16; 1×8 and 1×40 C=8; C=1; log decay −e and "
        "−e^-8), repeatable bitwise, and within JAX's "
        f"tolerance ({K11_FIX_ATOL} / {K11_FIX_RTOL}) of the JAX fixture "
        "(interpret kernel and wkv6_ref, C=16 and C=9)")
    return worst


# the head-dim sweeps: K2 at every mma instance, between two, and past 256
# (the sliced scalar kernel); K11 below, at and between its instances, past
# 256 (channel slices) and past what shared memory holds (the state in
# global memory)
K2_SWEEP_HD = (8, 40, 80, 96, 128, 192, 256, 320)
K11_SWEEP_HD = (8, 32, 96, 128, 320, 2048)
SWEEP_S = (1, 100, 256)
# K2 f16: one f16 rounding on each side, as K2_BF16_REL is one bf16 ulp
K2_F16_REL = 2.0 ** -10


def _k2_tolerance(torch, dt) -> tuple:
    """(relative, absolute) tolerance of K2 against its plain version."""
    if dt == torch.float32:
        return 0.0, K2_F32_ABS
    return (K2_BF16_REL if dt == torch.bfloat16 else K2_F16_REL), K2_BF16_ABS


def _hold_k2(torch, kf, q, k, v, window, what) -> float:
    out = kf.flash_attention(q, k, v, window=window)
    want = kf.flash_attention_plain(q, k, v, window=window).float()
    got = out.float()
    err = (got - want).abs()
    rel, ab = _k2_tolerance(torch, q.dtype)
    if out.shape != q.shape or not bool(torch.isfinite(got).all()) or bool(
            (err > rel * want.abs() + ab).any()):
        fail(f"K2 {what}: max err {err.max().item()} beyond "
             f"{rel} relative + {ab}")
    return err.max().item()


def check_k2_sweep(torch, kf, _build) -> None:
    """K2 against its plain version at every head dim of K2_SWEEP_HD × f32 /
    bf16 / f16 × S ∈ SWEEP_S × window ∈ {0, 64} (B 2, H 4, KV 2), each on
    the route ``plan`` names and never a copy; then inputs the mma kernel
    cannot read as they are — a head dim that is not a multiple of 8, a
    non-unit head-dim stride, a misaligned base — on the ``+copy`` route."""
    g = torch.Generator(device="cuda").manual_seed(16)
    worst = {}
    for hd in K2_SWEEP_HD:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            for S in SWEEP_S:
                for window in (0, 64):
                    q, k, v = (torch.randn(2, S, n, hd, generator=g,
                                           device="cuda").to(dt)
                               for n in (4, 2, 2))
                    route = kf.plan(q, k, v).route
                    _build.reset_launch_counts()
                    err = _hold_k2(torch, kf, q, k, v, window,
                                   f"hd={hd} {dt} S={S} window={window}")
                    if "+copy" in route or _build.route_counts != {
                            f"flash_attention/{route}": 1,
                            f"flash_attention/hd{hd}": 1}:
                        fail(f"K2 hd={hd} {dt}: launched "
                             f"{_build.route_counts}, planned {route}")
                    key = f"{route} hd {hd}"
                    worst[key] = max(worst.get(key, 0.0), err)
    log("K2 sweep: within tolerance of plain (f32 "
        f"{K2_F32_ABS}, bf16 {K2_BF16_REL} rel, f16 {K2_F16_REL} rel) at "
        f"S ∈ {SWEEP_S} × window ∈ {{0, 64}}, H=4 KV=2; max abs err "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    copies = []
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        wide = torch.randn(2, 100, 4, 40, generator=g,
                           device="cuda").to(dt)
        flat = torch.randn(2 * 100 * 4 * 64 + 1, generator=g,
                           device="cuda").to(dt)
        kv = torch.randn(2, 100, 2, 64, generator=g, device="cuda").to(dt)
        kv20 = torch.randn(2, 100, 2, 20, generator=g, device="cuda").to(dt)
        for q, k, what in ((wide[..., :20], kv20, "hd 20"),
                           (wide[..., ::2], kv20, "hd stride 2"),
                           (flat[1:].view(2, 100, 4, 64), kv, "base + 1")):
            route = kf.plan(q, k, k).route
            _build.reset_launch_counts()
            _hold_k2(torch, kf, q, k, k, 64, f"{what} {dt}")
            if _build.route_counts != {f"flash_attention/{route}": 1,
                                       f"flash_attention/hd{q.shape[3]}": 1}:
                fail(f"K2 {what} {dt}: launched {_build.route_counts}")
            copies.append(f"{what} {dt} -> {route}")
    log("K2 inputs the kernels cannot read as they are, within tolerance: "
        + "; ".join(copies))


def check_k11_sweep(torch, ko) -> None:
    """K11 against its plain version at every head dim of K11_SWEEP_HD and
    S ∈ SWEEP_S (C 1, 10, 16), B 2, H 3, within K11_REL × max |out|."""
    g = torch.Generator(device="cuda").manual_seed(17)
    worst = {}
    for hd in K11_SWEEP_HD:
        for S, C in zip(SWEEP_S, (1, 10, 16)):
            args = k11_inputs(torch, g, 2, S, 3, hd)
            y, s = ko.wkv6(*args, chunk=C)
            yp, sp = ko.wkv6_plain(*args, chunk=C)
            for got, want, what in ((y, yp, "y"), (s, sp, "s_final")):
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                if got.shape != want.shape or not bool(
                        torch.isfinite(got).all()) or err > K11_REL * scale:
                    fail(f"K11 hd={hd} S={S} C={C}: {what} max err {err} > "
                         f"{K11_REL} × {scale}")
                worst[hd] = max(worst.get(hd, 0.0), err / scale)
    log(f"K11 sweep: within {K11_REL} × max|out| of plain at S ∈ {SWEEP_S} "
        "(C 1, 10, 16), H=3; max |Δ| / max|out| "
        + ", ".join(f"hd {k} {v:.2e}" for k, v in worst.items()))


def check_z_selftest(kz) -> None:
    """zo_selftest: every rewrite of zo_stream.cuh against zo::ref over its
    whole domain on the card; any mismatch fails."""
    bad = kz.z_selftest("cuda")
    if any(bad.values()):
        fail(f"zo_selftest: the z generator's rewrites differ from zo::ref: "
             f"{bad}")
    log("zo_selftest: 0 mismatches in " + ", ".join(bad)
        + " over all 2^24 uniforms (the division over all 2^23 mantissas; "
        "z_of vs ref::z_at on 2^24 (index, seed) pairs)")


class ClockSampler:
    """nvidia-smi's SM clock sampled every 100 ms while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "100"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = sorted(float(v) for v in out.split() if v.strip())
        self.mhz = vals[len(vals) // 2] if vals else float("nan")
        return False


def _typed_z_libs(paths: dict) -> dict:
    """ctypes handles of K1's and K3's C entry points in the libraries at
    ``paths`` (one signature for the parent's and this tree's)."""
    import ctypes
    vp, i64, i, f = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                     ctypes.c_float)
    k1 = ctypes.CDLL(str(paths["zo_affine"])).zo_affine
    k1.argtypes = [vp, vp, i64, i, ctypes.c_uint32, f, f, i, vp]
    k1.restype = i
    k3 = ctypes.CDLL(str(paths["zo_multi"])).zo_affine_chain
    k3.argtypes = [vp, vp, i64, i, vp, vp, vp, i, i, vp]
    k3.restype = i
    return {"k1": k1, "k3": k3}


def z_turns(torch, _build, leaves, parent, card) -> dict:
    """K1 (one record over ``leaves``) and K3 (one 8-stream update over
    them) through their C entry points, this tree's kernels and — with
    ``parent``, a checkout of the parent commit — the parent's, built with
    the same flags, in turns: parent, change, change, parent.  Prints the
    times, each kernel's SASS instructions per z in its hot loop by unit,
    registers and spills, and the issue floor at the SM clock nvidia-smi
    reports during the runs.  Returns this tree's counts."""
    import ctypes
    from repro_torch.kernels.zo_fused.kernel import _f32
    libs = {"change": {name: _build.lib_path(name) for name in
                       ("zo_affine", "zo_multi", "zo_sqnorm", "zo_rows",
                        "wkv6", "zo_threefry")}}
    if parent is not None:
        libs["parent"] = build_parent_libs(_build, parent)
    n_all = sum(p.numel() for p in leaves)
    seeds = [(ctypes.c_uint32 * B_SEEDS)(*[(1000003 * i + 17 + j) & 0xFFFFFFFF
                                           for j in range(B_SEEDS)])
             for i in range(len(leaves))]
    ones = (ctypes.c_float * B_SEEDS)(*[1.0] * B_SEEDS)
    tiny = (ctypes.c_float * B_SEEDS)(*[_f32(1e-12)] * B_SEEDS)
    stream = _build.stream_of(leaves[0])

    def runs(fns):
        def k1():
            for i, p in enumerate(leaves):
                err = fns["k1"](p.data_ptr(), p.data_ptr(), p.numel(), 1,
                                seeds[i][0], 1.0, _f32(1e-12), 0, stream)
                if err:
                    fail(f"K1 timing launch: CUDA error {err}")

        def k3():
            for i, p in enumerate(leaves):
                err = fns["k3"](p.data_ptr(), p.data_ptr(), p.numel(), 1,
                                seeds[i], ones, tiny, B_SEEDS, 0, stream)
                if err:
                    fail(f"K3 timing launch: CUDA error {err}")
        return k1, k3

    fns = {name: runs(_typed_z_libs(paths)) for name, paths in libs.items()}
    order = (["parent", "change", "change", "parent"] if parent is not None
             else ["change", "change"])
    times = {"k1": {}, "k3": {}}
    with ClockSampler() as clock:
        for name in order:
            k1, k3 = fns[name]
            times["k1"].setdefault(name, []).append(cuda_ms(k1, 10))
            times["k3"].setdefault(name, []).append(cuda_ms(k3, 5))
    counts = {}
    for name, paths in libs.items():
        rep = sass_report(paths["zo_affine"],
                          {"K1": Z_KERNEL_SASS["zo_affine"][1]})
        rep.update(sass_report(paths["zo_multi"],
                               {"K3": Z_KERNEL_SASS["zo_affine_chain"][1]}))
        counts[name] = rep
        for lib, label in (("zo_affine", "K1"), ("zo_multi", "K3")):
            log_text = Path(paths[lib]).with_suffix(".log").read_text()
            regs = ptxas_facts(_build, lib, log_text)
            kname = next(k for k in regs if k.startswith(
                "zo_affine_kernel<bf16, 0>" if label == "K1"
                else "chain_kernel<bf16, 0>"))
            log(f"{name} {label} {kname}: {regs[kname]}")
            log(f"{name} " + sass_line(label + " " + kname, rep[label]))
    cur, mx = sm_clocks()
    mhz = clock.mhz
    for label, key, nz in (("K1", "k1", n_all), ("K3", "k3", B_SEEDS * n_all)):
        for name in libs:
            per_z = counts[name][label]["total"]
            floor = issue_floor_ms(nz, per_z, mhz)
            ts = times[key][name]
            log(f"{label} {name}: " + ", ".join(f"{t:.3f}" for t in ts)
                + f" ms ({order.count(name)} runs in turns "
                f"{'/'.join(order)}); issue floor {floor:.3f} ms = {nz} z × "
                f"{per_z:.2f} instructions / (4 warp-instructions × 32 × 132 "
                f"SMs × {mhz:.0f} MHz); " + floors_text(
                    nz, counts[name][label], mhz, sum(ts) / len(ts))
                + f" — on {card}")
    log(f"SM clock during the runs {mhz:.0f} MHz (median of nvidia-smi "
        f"samples every 100 ms), {cur:.0f} MHz after, {mx:.0f} MHz max")
    k6_turns(torch, _build, leaves, libs, order, card, mhz)
    fanout_turns(torch, _build, leaves, libs, order, card, mhz)
    k10_turns(torch, _build, leaves, libs, order, card, mhz)
    rows_turns(torch, _build, leaves, libs, order, card, mhz)
    k11_turns(torch, _build, libs, card)
    x1_turns(torch, _build, leaves, libs, order, card, mhz)
    return counts["change"]


def x1_turns(torch, _build, leaves, libs, order, card, mhz) -> None:
    """X1's bf16 gaussian axpbz pass over ``leaves`` (the replay / update
    write of the default stream) through the C entry points, in turns
    ``order``: the parent's ``zo_threefry_whole`` (or, where the parent
    is the first design, its ``zo_threefry``, one launch per leaf) and this
    tree's ``zo_threefry_whole`` (the launches ``kernel.whole_launches``
    plans); one pass of each from the same leaves held bitwise equal.  Prints the times, each side's SASS instructions
    per z by pipe and its issue and pipe floors."""
    import ctypes
    from repro_torch.kernels.threefry import kernel as x1
    vp, i64, i, f, u32, u64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_float, ctypes.c_uint32,
                               ctypes.c_uint64)
    bval = -0.0001220703125                       # a bf16 value: −η·g
    stream = _build.stream_of(leaves[0])
    new = ctypes.CDLL(str(libs["change"]["zo_threefry"])).zo_threefry_whole
    new.argtypes = [vp, vp, u32, u32, u32, i, u32, u32, u32, u32, i, i, f, f,
                    f, f, i, f, vp]
    new.restype = i
    plans = [x1.whole_launches(q.numel(), 0, q.data_ptr(), q.data_ptr(),
                               q.element_size()) for q in leaves]

    def whole(fn):
        def run(ys):
            for j, (q, plan) in enumerate(zip(ys, plans)):
                for ln in plan:
                    at = q.data_ptr() + ln.start * q.element_size()
                    if fn(at, at, ln.n, ln.head, ln.nvec, 1, 12345, j, ln.hi,
                          ln.lo, 0, 1, 1.0, bval, 0.0, 1.0, 0, 0.0, stream):
                        fail("X1 timing launch failed")
        return run
    fns = {"change": whole(new)}
    first_design = {}
    if "parent" in libs:
        plib = ctypes.CDLL(str(libs["parent"]["zo_threefry"]))
        if hasattr(plib, "zo_threefry_whole"):   # the parent's signature
            pw = plib.zo_threefry_whole
            pw.argtypes, pw.restype = new.argtypes, i
            fns["parent"] = whole(pw)
        else:                                    # X1's first design
            old = plib.zo_threefry
            old.argtypes = [vp, vp, i64, i, u32, u32, u64, i, i, f, f, f, f,
                            i, f, vp, vp, i, i64, vp]
            old.restype = i
            first_design["parent"] = True

            def parent(ys):
                for j, q in enumerate(ys):
                    if old(q.data_ptr(), q.data_ptr(), q.numel(), 1, 12345,
                           j, 0, 0, 1, 1.0, bval, 0.0, 1.0, 0, 0.0, None,
                           None, 0, q.numel(), stream):
                        fail("the parent's X1 timing launch failed")
            fns["parent"] = parent
        outs = {}
        for name, fn in fns.items():
            outs[name] = [q.clone() for q in leaves]
            fn(outs[name])
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(outs["parent"],
                                                   outs["change"])):
            fail("X1: this tree's pass != the parent's pass")
        del outs
    times = {}
    for name in order:
        times.setdefault(name, []).append(
            cuda_ms(lambda fn=fns[name]: fn(leaves), 10))
    n_all = sum(q.numel() for q in leaves)
    for name in fns:
        c = x1_sass(libs[name]["zo_threefry"], parent=name in first_design)
        log(f"{name} " + sass_line("X1 (bf16 gaussian axpbz)", c))
        ts = times[name]
        log(f"X1 {name}: " + ", ".join(f"{t:.3f}" for t in ts)
            + f" ms per pass over {len(leaves)} leaves ({order.count(name)} "
            f"runs in turns {'/'.join(order)}); " + floors_text(
                n_all, c, mhz, sum(ts) / len(ts)) + f" — on {card}")
    if "parent" in fns:
        log("X1: one pass of the parent's kernel and of this tree's from the "
            "same leaves are bitwise equal")


def k6_turns(torch, _build, leaves, libs, order, card, mhz) -> None:
    """K6: one stream's ‖z‖² of every leaf in ``leaves`` (one sphere pass)
    through the C entry points, in turns ``order`` — the parent's
    ``zo_sqnorm`` once per leaf (two launches each), this tree's
    ``zo_sqnorm_many`` once for all leaves (two launches).  The two must
    give the same bits.  Prints the times, the SASS instructions per z of
    ``tile_sums<gaussian>``'s z loop with the issue floor they set at
    ``mhz`` (the SM clock of the K1 / K3 runs), and its registers and
    spills."""
    import ctypes
    from repro_torch.kernels.zo_fused.multi import TILE_ELEMS
    ns = [p.numel() for p in leaves]
    seeds = [(1000003 * i + 17) & 0xFFFFFFFF for i in range(len(ns))]
    partials = torch.empty(sum(-(-n // TILE_ELEMS) for n in ns),
                           dtype=torch.float32, device="cuda")
    outs = {name: torch.empty(len(ns), dtype=torch.float32, device="cuda")
            for name in libs}
    stream = _build.stream_of(partials)
    vp = ctypes.c_void_p
    fns, how = {}, {}
    for name, paths in libs.items():
        lib, out = ctypes.CDLL(str(paths["zo_sqnorm"])), outs[name]
        many = hasattr(lib, "zo_sqnorm_many")
        how[name] = "one call" if many else "one call per leaf"
        if many:
            fn = lib.zo_sqnorm_many
            fn.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, vp]
            args = ((ctypes.c_int64 * len(ns))(*ns),
                    (ctypes.c_uint32 * len(ns))(*seeds), len(ns))
            calls = [(out.data_ptr(), args)]
        else:                        # one leaf per call
            fn = lib.zo_sqnorm
            fn.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_uint32,
                           ctypes.c_int, vp]
            calls = [(out.data_ptr() + 4 * i, (n, sd))
                     for i, (n, sd) in enumerate(zip(ns, seeds))]
        fn.restype = ctypes.c_int

        def run(fn=fn, calls=calls):
            for dst, args in calls:
                err = fn(partials.data_ptr(), dst, *args, 0, stream)
                if err:
                    fail(f"K6 timing launch: CUDA error {err}")
        fns[name] = run
    times = {}
    for name in order:
        times.setdefault(name, []).append(cuda_ms(fns[name], 10))
    if "parent" in outs and not same_bits(outs["parent"], outs["change"]):
        fail("K6: the parent's and this tree's norms differ in bits")
    n_all = sum(ns)
    for name, paths in libs.items():
        c = sass_report(paths["zo_sqnorm"],
                        {"K6": Z_KERNEL_SASS["zo_sqnorm"][1]})["K6"]
        regs = ptxas_facts(_build, "zo_sqnorm", Path(
            paths["zo_sqnorm"]).with_suffix(".log").read_text())
        log(f"{name} K6 tile_sums<0>: {regs.get('tile_sums<0>')}")
        log(f"{name} " + sass_line("K6 tile_sums<0>", c))
        floor = issue_floor_ms(n_all, c["total"], mhz)
        log(f"K6 {name}: " + ", ".join(f"{t:.3f}" for t in times[name])
            + f" ms per pass over {len(ns)} leaves ({order.count(name)} "
            f"runs in turns {'/'.join(order)}; {how[name]}); "
            f"issue floor {floor:.3f} ms = {n_all} z × {c['total']:.2f} "
            f"instructions at {mhz:.0f} MHz; " + floors_text(
                n_all, c, mhz, sum(times[name]) / len(times[name]))
            + f" — on {card}")


def _regs(_build, paths, lib: str, prefix: str) -> str:
    """``-Xptxas -v``'s registers and spills of the device function whose
    name starts with ``prefix`` in the library built at ``paths[lib]``."""
    facts = ptxas_facts(_build, lib, Path(paths[lib]).with_suffix(
        ".log").read_text())
    return next((v for k, v in facts.items() if k.startswith(prefix)), "?")


def fanout_turns(torch, _build, leaves, libs, order, card, mhz) -> None:
    """K4 and K5: one 8-stream fan-out of every leaf in ``leaves`` (one
    pass) through their C entry points (whose signatures this tree keeps),
    the parent's and this tree's, in turns ``order``.  Every leaf's output
    must have the parent's bits.  Prints the times, the SASS instructions
    per z of ``fanout_kernel<bf16, gaussian>``'s hot loop with the issue
    floor they set at ``mhz``, its registers and spills, and the route each
    leaf's launch takes."""
    import ctypes
    from repro_torch.kernels.zo_fused.kernel import (DTYPE_CODES, _f32,
                                                     fanout_route)
    vp, i64, i, f = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                     ctypes.c_float)
    seeds = [(ctypes.c_uint32 * B_SEEDS)(*[(1000003 * li + 17 + j)
                                           & 0xFFFFFFFF
                                           for j in range(B_SEEDS)])
             for li in range(len(leaves))]
    a = (ctypes.c_float * B_SEEDS)(*[_f32(v) for v in A8])
    b = (ctypes.c_float * B_SEEDS)(*[_f32(v) for v in B8])
    big = max(p.numel() for p in leaves)
    outs = {name: torch.empty(B_SEEDS * big, dtype=leaves[0].dtype,
                              device="cuda") for name in libs}
    stream = _build.stream_of(leaves[0])
    launch = {}
    for name, paths in libs.items():
        lib = ctypes.CDLL(str(paths["zo_multi"]))
        k4, k5 = lib.zo_affine_multi, lib.zo_affine_batched
        k4.argtypes = [vp, vp, i64, i, vp, vp, vp, i, i, vp]
        k5.argtypes = [vp, vp, i64, i, vp, i, f, f, i, vp]
        k4.restype = k5.restype = i
        y = outs[name].data_ptr()

        def one(which, li, k4=k4, k5=k5, y=y):
            p = leaves[li]
            args = (p.data_ptr(), y, p.numel(), DTYPE_CODES[p.dtype])
            err = (k4(*args, seeds[li], a, b, B_SEEDS, 0, stream)
                   if which == "K4" else
                   k5(*args, seeds[li], B_SEEDS, a[0], b[0], 0, stream))
            if err:
                fail(f"{which} timing launch: CUDA error {err}")
        launch[name] = one
    if "parent" in libs:
        for li, p in enumerate(leaves):
            m = B_SEEDS * p.numel()
            for which in ("K4", "K5"):
                for name in libs:
                    launch[name](which, li)
                if not same_bits(outs["parent"][:m], outs["change"][:m]):
                    fail(f"{which}: the parent's and this tree's fan-out of "
                         f"leaf {li} {tuple(p.shape)} differ in bits")
    times = {}
    for name in order:
        for which in ("K4", "K5"):
            times.setdefault((which, name), []).append(cuda_ms(
                lambda: [launch[name](which, li)
                         for li in range(len(leaves))], 5))
    routes = {}
    for p in leaves:
        r = fanout_route(p, outs["change"])
        routes[r] = routes.get(r, 0) + 1
    n_z = B_SEEDS * sum(p.numel() for p in leaves)
    for name, paths in libs.items():
        c = sass_report(paths["zo_multi"], {
            "fan-out": Z_KERNEL_SASS["zo_affine_multi"][1]})["fan-out"]
        log(f"{name} K4/K5 fanout_kernel<bf16, 0>: "
            + _regs(_build, paths, "zo_multi", "fanout_kernel<bf16, 0>"))
        log(f"{name} " + sass_line("K4/K5 fanout_kernel<bf16, 0>", c))
        floor = issue_floor_ms(n_z, c["total"], mhz)
        for which in ("K4", "K5"):
            log(f"{which} {name}: " + ", ".join(
                f"{t:.3f}" for t in times[which, name])
                + f" ms per {B_SEEDS}-stream fan-out of {len(leaves)} leaves "
                f"({order.count(name)} runs in turns {'/'.join(order)}); "
                f"issue floor {floor:.3f} ms = {n_z} z × {c['total']:.2f} "
                f"instructions at {mhz:.0f} MHz; " + floors_text(
                    n_z, c, mhz, sum(times[which, name])
                    / len(times[which, name])) + f" — on {card}")
    log("fan-out routes of the timed pass (this tree): " + ", ".join(
        f"{r} {n} leaves" for r, n in sorted(routes.items()))
        + ("; the parent's outputs bitwise equal, every leaf, K4 and K5"
           if "parent" in libs else ""))


def k10_turns(torch, _build, leaves, libs, order, card, mhz) -> None:
    """K10: one stream's ‖z‖² of every leaf in ``leaves`` under
    rows(block=1, k=4) at phase 0 (one sphere pass of path (g)) through
    the C entry points, in turns ``order`` — the parent's
    ``zo_sqnorm_rows`` once per leaf (two launches each), this tree's
    ``zo_sqnorm_rows_many`` once for all leaves (two launches).  The norms
    must have the same bits.  Prints the times, the SASS instructions per
    z of the tile kernel's z loop with the issue floor at ``mhz``, and its
    registers and spills."""
    import ctypes
    from repro_torch.kernels.zo_fused import rows as kr
    from repro_torch.select import parse_selection
    rsel = parse_selection(ROWS)
    plans = [rsel.block_mask(p, 0) for p in leaves]
    ns = [p.numel() for p in leaves]
    seeds = [(1000003 * i + 17) & 0xFFFFFFFF for i in range(len(ns))]
    table = [kr._rows_leaf(n, sd, rb.block_elems, rb.k, rb.phase)
             for n, sd, rb in zip(ns, seeds, plans)]
    partials = torch.empty(sum(-(-row[0] // kr.TILE_ELEMS) for row in table),
                           dtype=torch.float32, device="cuda")
    outs = {name: torch.empty(len(ns), dtype=torch.float32, device="cuda")
            for name in libs}
    stream = _build.stream_of(partials)
    vp, u32, i = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    fns, sass, how = {}, {}, {}
    for name, paths in libs.items():
        lib, out = ctypes.CDLL(str(paths["zo_rows"])), outs[name]
        many = hasattr(lib, "zo_sqnorm_rows_many")
        how[name] = "one call" if many else "one call per leaf"
        if many:
            fn = lib.zo_sqnorm_rows_many
            fn.argtypes = [vp, vp, vp, i, i, vp]
            flat = [v for row in table for v in row]
            calls = [(out.data_ptr(), ((u32 * len(flat))(*flat), len(ns)))]
            sass[name] = (Z_KERNEL_SASS["zo_sqnorm_rows"][1], "rows_tile_sums")
        else:                        # one leaf per call
            fn = lib.zo_sqnorm_rows
            fn.argtypes = [vp, vp, ctypes.c_int64, u32, u32, u32, u32, i, vp]
            calls = [(out.data_ptr() + 4 * li, (row[0], row[2], rb.k,
                                                rb.phase, sd))
                     for li, (row, rb, sd) in enumerate(zip(table, plans,
                                                            seeds))]
            sass[name] = (PARENT_K10_SASS, "sqnorm_rows_tiles")
        fn.restype = i

        def run(fn=fn, calls=calls):
            for dst, args in calls:
                err = fn(partials.data_ptr(), dst, *args, 0, stream)
                if err:
                    fail(f"K10 timing launch: CUDA error {err}")
        fns[name] = run
    times = {}
    for name in order:
        times.setdefault(name, []).append(cuda_ms(fns[name], 10))
    if "parent" in outs and not same_bits(outs["parent"], outs["change"]):
        fail("K10: the parent's and this tree's norms differ in bits")
    n_sel = sum(row[0] for row in table)
    for name, paths in libs.items():
        pat, kname = sass[name]
        c = sass_report(paths["zo_rows"], {"K10": pat})["K10"]
        log(f"{name} K10 {kname}<0>: "
            + _regs(_build, paths, "zo_rows", f"{kname}<0>"))
        log(f"{name} " + sass_line(f"K10 {kname}<0>", c))
        floor = issue_floor_ms(n_sel, c["total"], mhz)
        log(f"K10 {name}: " + ", ".join(f"{t:.3f}" for t in times[name])
            + f" ms per pass over {len(ns)} leaves under {ROWS} "
            f"({order.count(name)} runs in turns {'/'.join(order)}; "
            f"{how[name]}); "
            f"issue floor {floor:.3f} ms = {n_sel} z × {c['total']:.2f} "
            f"instructions at {mhz:.0f} MHz; " + floors_text(
                n_sel, c, mhz, sum(times[name]) / len(times[name]))
            + f" — on {card}")
    if "parent" in outs:
        log(f"K10: the parent's norms ({how['parent']}) and this tree's "
            f"({how['change']}) are bitwise equal")


def rows_turns(torch, _build, leaves, libs, order, card, mhz) -> None:
    """K7 (one record) and K9 (one 8-stream update) of every leaf in
    ``leaves`` under rows(block=1, k=4) at phase 0 (a pass of paths (e) and
    (f)), one C call per leaf, through the parent's entry points (its own
    signatures: no divide constants) and this tree's, in turns ``order``.
    Every leaf's K7 and K9 output must have the parent's bits.  Prints the
    times, the SASS instructions per z of ``affine_rows_kernel`` and
    ``chain_rows_kernel`` (bf16, gaussian) by unit with the issue floor
    they set at ``mhz`` and the share of it reached, their registers and
    spills, and the route each leaf takes in this tree."""
    import ctypes
    from repro_torch.kernels.zo_fused import rows as kr
    from repro_torch.kernels.zo_fused.kernel import DTYPE_CODES, _f32
    from repro_torch.select import parse_selection
    rsel = parse_selection(ROWS)
    plans = []
    for p in leaves:
        rb = rsel.block_mask(p, 0)
        _, be, k, ph = kr._plan(p.numel(), rb.block_elems, rb.k, rb.phase)
        plans.append((kr.selected_count(p.numel(), be, k, ph), be, k, ph))
    vp, i64, i, u32, f = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_uint32, ctypes.c_float)
    seeds = [(u32 * B_SEEDS)(*[(1000003 * li + 17 + j) & 0xFFFFFFFF
                               for j in range(B_SEEDS)])
             for li in range(len(leaves))]
    coeffs = {"check": ((f * B_SEEDS)(*[_f32(v) for v in A8]),
                        (f * B_SEEDS)(*[_f32(v) for v in B8])),
              "time": ((f * B_SEEDS)(*[1.0] * B_SEEDS),
                       (f * B_SEEDS)(*[_f32(1e-12)] * B_SEEDS))}
    stream = _build.stream_of(leaves[0])
    launch, sigs = {}, {}
    for name, paths in libs.items():
        lib = ctypes.CDLL(str(paths["zo_rows"]))
        k7, k9 = lib.zo_affine_rows, lib.zo_affine_chain_rows
        new = hasattr(lib, "zo_rows_route")      # the divide constants
        div = [u32, u32] if new else []
        k7.argtypes = [vp, vp, i64, i, u32, u32, u32, *div, u32, f, f, i, vp]
        k9.argtypes = [vp, vp, i64, i, u32, u32, u32, *div, vp, vp, vp, i,
                       i, vp]
        k7.restype = k9.restype = i
        sigs[name] = "this tree's" if new else "its own"

        def one(which, li, y, how, k7=k7, k9=k9, new=new):
            p, (sel, be, k, ph) = leaves[li], plans[li]
            a, b = coeffs[how]
            head = (y, y, sel, DTYPE_CODES[p.dtype], be, k, ph)
            d = kr._vector_divide(be, p.element_size()) if new else ()
            err = (k7(*head, *d, seeds[li][0], a[0], b[0], 0, stream)
                   if which == "K7" else
                   k9(*head, *d, seeds[li], a, b, B_SEEDS, 0, stream))
            if err:
                fail(f"{which} timing launch: CUDA error {err}")
        launch[name] = one
    if "parent" in libs:
        for li, p in enumerate(leaves):
            for which in ("K7", "K9"):
                outs = {}
                for name in libs:
                    outs[name] = p.clone()
                    launch[name](which, li, outs[name].data_ptr(), "check")
                if not same_bits(outs["parent"], outs["change"]):
                    fail(f"{which}: the parent's and this tree's output of "
                         f"leaf {li} {tuple(p.shape)} differ in bits")
                del outs
    times = {}
    for name in order:
        for which, reps in (("K7", 10), ("K9", 5)):
            times.setdefault((which, name), []).append(cuda_ms(
                lambda: [launch[name](which, li, p.data_ptr(), "time")
                         for li, p in enumerate(leaves)], reps))
    routes = {}
    for p, (_, be, _, _) in zip(leaves, plans):
        r = kr.rows_route(p, be)
        routes[r] = routes.get(r, 0) + 1
    n_sel = sum(pl[0] for pl in plans)
    for name, paths in libs.items():
        for which, key, kname, nz in (
                ("K7", "zo_affine_rows", "affine_rows_kernel", n_sel),
                ("K9", "zo_affine_chain_rows", "chain_rows_kernel",
                 B_SEEDS * n_sel)):
            c = sass_report(paths["zo_rows"],
                            {which: Z_KERNEL_SASS[key][1]})[which]
            log(f"{name} {which} {kname}<bf16, 0>: "
                + _regs(_build, paths, "zo_rows", f"{kname}<bf16, 0>"))
            log(f"{name} " + sass_line(f"{which} {kname}<bf16, 0>", c))
            floor = issue_floor_ms(nz, c["total"], mhz)
            ts = times[which, name]
            log(f"{which} {name}: " + ", ".join(f"{t:.3f}" for t in ts)
                + f" ms per pass over {len(leaves)} leaves under {ROWS} "
                f"({order.count(name)} runs in turns {'/'.join(order)}; one "
                f"call per leaf, {sigs[name]} C signature); issue floor "
                f"{floor:.3f} ms = {nz} z × {c['total']:.2f} instructions at "
                f"{mhz:.0f} MHz, {100 * floor * len(ts) / sum(ts):.0f}% of it"
                f" reached; " + floors_text(nz, c, mhz, sum(ts) / len(ts))
                + f" — on {card}")
    log("K7/K9 routes of the timed pass (this tree): " + ", ".join(
        f"{r} {n} leaves" for r, n in sorted(routes.items()))
        + ("; every leaf's K7 and K9 output bitwise the parent's"
           if "parent" in libs else ""))


#: K11's shapes timed in turns: the rwkv6-3b training call and a
#: single-request prefill of 32 tokens (B, S, H, hd, C)
K11_TURN_SHAPES = ((TRAIN_BATCH, TRAIN_SEQ, 40, 64, 16), (1, 32, 40, 64, 16))


def k11_turns(torch, _build, libs, card) -> None:
    """K11 at ``K11_TURN_SHAPES`` (f32, the model's (B, S, H, hd) layout):
    the parent's C entry point (its tiled route where it has one — its
    entry point then takes a ``tiled`` flag — else its scalar kernel) and
    this tree's wrapper (the tiled route), both held to the plain version,
    then timed in CUDA-graph runs of launches, in turns (parent, change,
    change, parent, …).  Prints the times and the registers, shared memory
    and spills of ``wkv6_fwd<64, false>`` and ``wkv6_tile`` in each
    library."""
    import ctypes
    from repro_torch.kernels.rwkv6 import kernel as kw
    from repro_torch.kernels.rwkv6 import ops as ko
    g = torch.Generator(device="cuda").manual_seed(19)
    parent, tiled = None, ()
    if "parent" in libs:
        lib = ctypes.CDLL(str(libs["parent"]["wkv6"]))
        tiled = (1,) if hasattr(lib, "wkv6_tile_smem_bytes") else ()
        parent = lib.wkv6_chunked
        parent.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                           + [ctypes.c_int64] * 21
                           + [ctypes.c_int] * len(tiled) + [ctypes.c_void_p])
        parent.restype = ctypes.c_int
    for B, S, H, hd, C in K11_TURN_SHAPES:
        r, k, v, lw, u, s0 = k11_inputs(torch, g, B, S, H, hd)
        yp, sp = ko.wkv6_plain(r, k, v, lw, u, s0, chunk=C)
        if kw.plan(r, k, v, lw) != "tile":
            fail(f"K11 ({B}, {S}, {H}, {hd}): planned {kw.plan(r, k, v, lw)}"
                 ", not the tiled route")
        fns = {"change": lambda: ko.wkv6(r, k, v, lw, u, s0, chunk=C)}
        outs = {"change": fns["change"]()}
        if parent is not None:
            y = torch.empty_like(r)
            s_out = torch.empty_like(s0)

            def run_parent():
                err = parent(*(t.data_ptr() for t in
                               (r, k, v, lw, u, s0, y, s_out)),
                             B, H, S, hd, C,
                             *(st for t in (r, k, v, lw, y)
                               for st in t.stride()[:3]),
                             0, u.stride(0), *s0.stride()[:2],
                             *s_out.stride()[:2], *tiled,
                             _build.stream_of(r))
                if err:
                    fail(f"the parent's K11: CUDA error {err}")
            run_parent()
            fns = {"parent": run_parent, **fns}
            outs["parent"] = (y, s_out)
        for name, (y, s) in outs.items():
            for got, want in ((y, yp), (s, sp)):
                if (got - want).abs().max().item() > \
                        K11_REL * want.abs().max().item():
                    fail(f"K11 {name} ({B}, {S}, {H}, {hd}): beyond "
                         f"{K11_REL} × max|out| of plain")
        n = 20 if B > 1 else RUN_N
        run = run_ms(fns, n)
        log(f"K11 at ({B}, {S}, {H}, {hd}) C {C} f32, {n} launches per CUDA "
            "graph and event pair, in turns: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in run.items())
            + f" — on {card}")
    for name, paths in libs.items():
        regs = ptxas_facts(_build, "wkv6", Path(
            paths["wkv6"]).with_suffix(".log").read_text())
        for fn in ("wkv6_fwd<64, false>", "wkv6_tile"):
            if fn in regs:
                log(f"{name} K11 {fn}: {regs[fn]}")
    smem = ctypes.CDLL(str(libs["change"]["wkv6"])).wkv6_tile_smem_bytes()
    log(f"change K11 wkv6_tile: {smem} bytes of dynamic shared memory per "
        "CTA")


def time_k2_hd128(torch, kf, card) -> dict:
    """K2 at OPT-13b's attention shape (16, 256, 40, 128) bf16, MHA, beside
    one SDPA call, in runs of RUN_N launches per CUDA graph, in turns."""
    g = torch.Generator(device="cuda").manual_seed(18)
    B, S, H, hd = TRAIN_BATCH, TRAIN_SEQ, 40, 128
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    err = _hold_k2(torch, kf, q, k, v, 0, f"at ({B}, {S}, {H}, {hd})")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    run = run_ms({"kernel": lambda: kf.flash_attention(q, k, v),
                  "library": lambda: sdpa(qt, kt, vt, is_causal=True)}, RUN_N)
    plain_ms = run_ms({"plain": lambda: kf.flash_attention_plain(q, k, v)},
                      RUN_N_PLAIN, graph=False)["plain"]
    bms, by = costs.bound_ms(costs.flash_attention(B, S, H, H, hd,
                                                   q.element_size()))
    log(f"K2 hd 128 at OPT-13b's shape ({B}, {S}, {H}, {hd}) bf16 MHA: "
        f"{run['kernel']:.4f} ms, one SDPA call {run['library']:.4f} ms "
        f"({RUN_N} launches per CUDA graph and event pair, in turns), plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), max abs err "
        f"{err:.2e} — on {card}")
    # the hd-128 row of the ``kernels`` line: its launches are K2's on
    # the opt-13b / opt-30b paths (MHA at hd 128), filled in by main
    return {"name": "flash_attention_hd128", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
            "launches": 0, "max_abs_err": err, "ms": run["kernel"],
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": run["library"]}


def ssm_prompts(np, vocab: int):
    rng = np.random.default_rng(13)
    return [[int(t) for t in rng.integers(1, vocab - 1,
                                          int(rng.integers(8, 41)))]
            for _ in range(SSM_REQUESTS)]


def serve_ssm(torch, np, cfg, params0, replayed, ledger, _build, counts,
              card) -> None:
    """Serve the rwkv6-3b fine-tune: ``composition_for_ledger`` → replay (K1)
    onto θ₀ → the non-paged engine (exact-length prefill through K11, the
    lockstep decode carrying the per-slot state)."""
    from repro_torch.core import replay
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import tree_leaves
    prompts = ssm_prompts(np, cfg.vocab_size)
    params = _clone_tree(params0)
    warm = ServeEngine(cfg, params, slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                       device="cuda")                   # cuBLAS warm-up
    warm.submit(Request(0, prompts[0][:8], max_new_tokens=2))
    warm.run()
    del warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    replay(params, ledger, composition_for_ledger(ledger))
    eng = ServeEngine(cfg, params, slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                      device="cuda")
    reqs = [Request(i, p, max_new_tokens=SSM_NEW)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    add_counts(counts, _build, ("zo_affine", "wkv6_chunked"),
               "serve the ssm fine-tune")
    if eng.paged or eng.state is None:
        fail("the ssm engine did not take the per-slot recurrent path")
    for a, b in zip(tree_leaves(params), tree_leaves(replayed)):
        if not same_bits(a, b):
            fail("the served ssm fine-tune != the replayed trained θ")
    if any(len(r.out_ids) != SSM_NEW or not all(
            0 <= t < cfg.vocab_size for t in r.out_ids) for r in reqs):
        fail("an ssm request did not produce its tokens")
    tokens = tokens_of([r.out_ids for r in reqs])
    ttft = sorted(r.times["prefill"] - r.times["queued"] for r in reqs)
    log(f"served the ssm fine-tune ({len(ledger)} records replayed through "
        f"composition_for_ledger, θ bitwise the replayed trained θ): "
        f"{len(reqs)} requests of {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} prompt tokens, {tokens} tokens in "
        f"{wall:.3f} s: {tokens / wall:.1f} tok/s, TTFT p50 "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, {SSM_SLOTS} slots, peak "
        f"memory over the resident trees {peak / 2**30:.3f} GiB — on {card}")
    eng = ServeEngine(cfg, params, slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                      device="cuda")
    for i, p in enumerate(prompts[:SSM_SLOTS]):
        eng.submit(Request(i, p, max_new_tokens=SSM_NEW))
    eng.step()                        # admission (exact-length prefills)
    eng.step()
    log(busy_line(f"ssm decode step ({SSM_SLOTS} slots, {cfg.n_layers} "
                  "layers)", *device_busy(torch, eng.step, 3)))


def ssm_checks(torch, cfg, params0) -> None:
    """Two checks of the rwkv6-3b forward at full width and depth.

    The card's analogue of test_wkv_decode_chain_matches_full, in f32:
    prefill 40 tokens (K11), decode 7 more carrying the state (the per-token
    recurrence), against one chunk-mode prefill of all 47 (K11).

    One forward in chunk mode (K11) against fused_recurrent (``wkv6_ref``)
    on the same batch: in f32 within SSM_MODES_F32_REL, and in bf16 within
    SSM_MODES_NOISE times the bf16 rounding noise of the two modes, measured
    on the same batch as each bf16 forward's distance from the f32 one."""
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import bundle, rwkv6
    cfg32 = cfg.replace(dtype="float32")
    p32 = _cast_tree(params0, torch.float32)
    b = bundle(cfg32)
    g = torch.Generator().manual_seed(14)
    toks = torch.randint(1, cfg.vocab_size - 1, (2, 47), generator=g).cuda()
    with torch.no_grad():
        _, st = b.prefill_fn()(p32, {"tokens": toks[:, :40]})
        for t in range(40, 47):
            _, st = b.decode_fn()(p32, {"token": toks[:, t:t + 1],
                                        "state": st,
                                        "cache_pos": torch.tensor(
                                            [t, t], device="cuda")})
        _, full = b.prefill_fn()(p32, {"tokens": toks})
    torch.cuda.synchronize()
    worst = {}
    for name, a, want in zip(full._fields, st, full):
        rel = ((a - want).abs().max() / want.abs().max()).item()
        worst[name] = rel
        if not bool(torch.isfinite(a).all()) or rel > SSM_STATE_REL:
            fail(f"ssm state after prefill + decode: {name} max |Δ| is "
                 f"{rel:.3e} of max |state| > {SSM_STATE_REL}")
    log("ssm state, prefill(40) + 7 decode steps vs one prefill(47), f32, "
        f"{cfg.n_layers} layers: max |Δ| / max |state| "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (tolerance {SSM_STATE_REL})")
    del st, full

    toks = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             vocab=cfg.vocab_size, seed=SEED),
                    device="cuda").batch(0)["tokens"][:4]

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    logits = {}
    with torch.no_grad():
        for dt, c, p in (("f32", cfg32, p32), ("bf16", cfg, params0)):
            for mode in ("chunk", "fused_recurrent"):
                t0 = time.perf_counter()
                lg, _ = rwkv6.forward(c, p, tokens=toks, mode=mode)
                torch.cuda.synchronize()
                logits[dt, mode] = (lg, time.perf_counter() - t0)
                if not bool(torch.isfinite(lg).all()):
                    fail(f"ssm {dt} {mode} logits not finite")
    del p32
    f32_gap = rel(logits["f32", "chunk"][0], logits["f32", "fused_recurrent"][0])
    gap = rel(logits["bf16", "chunk"][0], logits["bf16", "fused_recurrent"][0])
    noise = max(rel(logits["bf16", m][0], logits["f32", m][0])
                for m in ("chunk", "fused_recurrent"))
    if f32_gap > SSM_MODES_F32_REL:
        fail(f"ssm chunk vs fused_recurrent logits, f32: ‖Δ‖/‖logits‖ "
             f"{f32_gap:.3e} > {SSM_MODES_F32_REL}")
    if gap > SSM_MODES_NOISE * noise:
        fail(f"ssm chunk vs fused_recurrent logits, bf16: ‖Δ‖/‖logits‖ "
             f"{gap:.3e} > {SSM_MODES_NOISE} × the bf16 noise {noise:.3e}")
    log(f"ssm forward, chunk (K11) vs fused_recurrent on 4 × {TRAIN_SEQ} "
        f"tokens, {cfg.n_layers} layers: ‖Δ‖/‖logits‖ {f32_gap:.3e} in f32 "
        f"(tolerance {SSM_MODES_F32_REL}); {gap:.3e} in bf16, where each "
        f"bf16 forward is {noise:.3e} from its f32 forward (tolerance "
        f"{SSM_MODES_NOISE} × that); the bf16 forwards took "
        f"{logits['bf16', 'chunk'][1]:.2f} s (chunk) and "
        f"{logits['bf16', 'fused_recurrent'][1]:.2f} s (fused_recurrent)")


def ssm_paths(torch, np, kw, ko, _build, counts, step_ms, card,
              k11_err) -> dict:
    """rwkv6-3b at full width and depth: (i) mezo spsa training (K1, K11)
    with its memory and busy share, replays, the served fine-tune, the
    state and scan-mode checks; returns the K11 row."""
    from repro_torch import zo
    from repro_torch.models import all_archs, bundle
    from repro_torch.tree_utils import tree_leaves
    cfg = all_archs()[SSM_ARCH].cfg
    t0 = time.perf_counter()
    params0 = bundle(cfg).init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params0))
    log(f"{SSM_ARCH}: {n_params} params bf16 in "
        f"{len(tree_leaves(params0))} leaves, {cfg.n_layers} layers, scan "
        f"chunk {cfg.scan_chunk}, init {time.perf_counter() - t0:.1f} s")
    memory_and_busy(torch, cfg, params0)

    name = "i_ssm_spsa"

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="pallas")

    p, led, _, ms = train_phase(torch, cfg, params0, name, make_opt, None,
                                _build, counts)
    step_ms[name] = ms
    replayed = check_replays(torch, name, params0, p, led, make_opt)
    del p
    serve_ssm(torch, np, cfg, params0, replayed, led, _build, counts, card)
    del replayed
    ssm_checks(torch, cfg, params0)
    del params0

    B, S, H, hd, C = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd, \
        cfg.scan_chunk
    g = torch.Generator(device="cuda").manual_seed(15)
    args = k11_inputs(torch, g, B, S, H, hd)
    ms = cuda_ms(lambda: ko.wkv6(*args, chunk=C), 20)
    plain_ms = cuda_ms(lambda: ko.wkv6_plain(*args, chunk=C), 5)
    work = costs.wkv6_chunked(B, S, H, hd, C)
    log(f"K11 wkv6_chunked at the training shape ({B}, {S}, {H}, {hd}) C={C}"
        f" f32: {ms:.3f} ms (median of 20 CUDA-event pairs), plain "
        f"{plain_ms:.3f} ms (median of 5); {work.bytes / 1e6:.1f} MB, "
        f"{work.ops / 1e9:.2f} GFLOP — on {card}")
    bms, by = costs.bound_ms(work)
    # no single PyTorch call computes WKV6: library_ms is null
    return {"name": "wkv6_chunked", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:77",
            "launches": 0, "max_abs_err": k11_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def qwen2_kernel_rows(torch, np, cfg, params0, pool_k, nblk_slot, k1_err,
                      k2_err, card, kz, km, kr, kf, kp) -> list:
    """Time K1, K3-K10, K2 and K12 at the qwen2-0.5b paths' shapes; the
    rows of the ``kernels`` line, launches filled in by the caller."""
    from repro_torch.select import parse_selection
    from repro_torch.tree_utils import is_floating, tree_leaves
    leaves = [p for p in tree_leaves(params0) if is_floating(p)]
    n_all = sum(p.numel() for p in leaves)
    seeds = [[1000003 * i + 17 + j for j in range(B_SEEDS)]
             for i in range(len(leaves))]
    ones, tiny = [1.0] * B_SEEDS, [1e-12] * B_SEEDS

    def k1_record():
        for i, p in enumerate(leaves):
            kz.zo_affine(p, seeds[i][0], 1.0, 1e-12, out=p)

    def k3_update(chain=km.zo_affine_chain):
        for i, p in enumerate(leaves):
            chain(p, seeds[i], ones, tiny, out=p)

    def k4_fanout(multi=km.zo_affine_multi):
        for i, p in enumerate(leaves):
            multi(p, seeds[i], ones, tiny)

    def k5_fanout(batched=kz.zo_affine_batched):
        for i, p in enumerate(leaves):
            batched(p, seeds[i], 1.0, 1e-12)

    def k6_pass(sq=km.zo_sqnorm_many):
        sq([p.numel() for p in leaves], [sd[0] for sd in seeds], "gaussian",
           "cuda")

    def k1_plain_record():
        for i, p in enumerate(leaves):
            kz.zo_affine_plain(p, seeds[i][0], 1.0, 1e-12, out=p)

    clock = ClockSampler().__enter__()
    times = {
        "zo_affine": (cuda_ms(k1_record, 10), host_ms(k1_plain_record)),
        "zo_affine_chain": (cuda_ms(k3_update, 5), host_ms(
            lambda: k3_update(km.zo_affine_chain_plain))),
        "zo_affine_multi": (cuda_ms(k4_fanout, 5), host_ms(
            lambda: k4_fanout(km.zo_affine_multi_plain))),
        "zo_affine_batched": (cuda_ms(k5_fanout, 5), host_ms(
            lambda: k5_fanout(kz.zo_affine_batched_plain))),
        "zo_sqnorm": (cuda_ms(k6_pass, 10), host_ms(
            lambda: k6_pass(km.zo_sqnorm_many_plain))),
    }

    # the rows kernels over all leaves under rows(block=1, k=4), phase 0
    rsel = parse_selection(ROWS)
    plans = [rsel.block_mask(p, 0) for p in leaves]
    n_sel = sum(rb.selected_elems() for rb in plans)

    def k7_record(fn=kr.zo_affine_rows):
        for i, (p, rb) in enumerate(zip(leaves, plans)):
            fn(p, seeds[i][0], 1.0, 1e-12, rb.block_elems, rb.k, rb.phase,
               out=p)

    def k9_update(fn=kr.zo_affine_chain_rows):
        for i, (p, rb) in enumerate(zip(leaves, plans)):
            fn(p, seeds[i], ones, tiny, rb.block_elems, rb.k, rb.phase, out=p)

    def k8_fanout(fn=kr.zo_affine_multi_rows):
        for i, (p, rb) in enumerate(zip(leaves, plans)):
            fn(p, seeds[i], ones, tiny, rb.block_elems, rb.k, rb.phase)

    def k10_pass(fn=kr.zo_sqnorm_rows_many):
        fn([p.numel() for p in leaves], [sd[0] for sd in seeds],
           [(rb.block_elems, rb.k, rb.phase) for rb in plans], "gaussian",
           "cuda")

    times.update({
        "zo_affine_rows": (cuda_ms(k7_record, 10), host_ms(
            lambda: k7_record(kr.zo_affine_rows_plain))),
        "zo_affine_chain_rows": (cuda_ms(k9_update, 5), host_ms(
            lambda: k9_update(kr.zo_affine_chain_rows_plain))),
        "zo_affine_multi_rows": (cuda_ms(k8_fanout, 5), host_ms(
            lambda: k8_fanout(kr.zo_affine_multi_rows_plain))),
        "zo_sqnorm_rows": (cuda_ms(k10_pass, 10), host_ms(
            lambda: k10_pass(kr.zo_sqnorm_rows_many_plain))),
    })
    clock.__exit__(None, None, None)
    # K7's pass is 15 launches issued from Python, some on leaves of a few
    # hundred elements: how much of its event time is gaps between kernels
    k7_ms = times["zo_affine_rows"][0]
    k7_dev, k7_n = kernel_sum_ms(torch, k7_record)
    k7_graph = run_ms({"graph": k7_record}, 10)["graph"]
    log(f"K7 launch gaps: one pass of {len(leaves)} Python-issued launches "
        f"{k7_ms:.3f} ms between CUDA events, {k7_graph:.3f} ms as a CUDA "
        "graph (10 passes per graph and event pair), "
        + (f"the profiler's sum of its kernels {k7_dev:.3f} ms ({k7_n:.1f} "
           f"launches seen per pass): gaps {k7_ms - k7_dev:.3f} ms, "
           f"{100 * (k7_ms - k7_dev) / k7_ms:.1f}% of the pass"
           if k7_dev else "kernel time not measured (the profiler saw no "
           "kernels)") + f" — on {card}")
    from repro_torch.kernels import _build
    for name, nz in (("zo_affine", n_all),
                     ("zo_affine_chain", B_SEEDS * n_all),
                     ("zo_affine_multi", B_SEEDS * n_all),
                     ("zo_affine_batched", B_SEEDS * n_all),
                     ("zo_sqnorm", n_all), ("zo_affine_rows", n_sel),
                     ("zo_affine_multi_rows", B_SEEDS * n_sel),
                     ("zo_affine_chain_rows", B_SEEDS * n_sel),
                     ("zo_sqnorm_rows", n_sel)):
        lib, pat = Z_KERNEL_SASS[name]
        c = sass_report(_build.lib_path(lib), {name: pat})[name]
        floor = issue_floor_ms(nz, c["total"], clock.mhz)
        log(sass_line(name, c) + f"; issue floor {floor:.3f} ms for {nz} z "
            f"at {clock.mhz:.0f} MHz (measured {times[name][0]:.3f} ms, "
            f"{100 * floor / times[name][0]:.0f}% of it); "
            + floors_text(nz, c, clock.mhz, times[name][0]))

    g = torch.Generator(device="cuda").manual_seed(6)
    S = TRAIN_SEQ
    q = torch.randn(TRAIN_BATCH, S, cfg.n_heads, cfg.hd, generator=g,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn(TRAIN_BATCH, S, cfg.kv_heads, cfg.hd, generator=g,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn_like(k)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def k2():
        kf.flash_attention(q, k, v)

    def k2_lib():
        sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    k2_run = run_ms({"kernel": k2, "library": k2_lib}, RUN_N)
    k2_ms, k2_lib_ms = k2_run["kernel"], k2_run["library"]
    k2_eager = run_ms({"kernel": k2, "library": k2_lib}, RUN_N, graph=False)
    k2_plain_ms = run_ms({"plain": lambda: kf.flash_attention_plain(q, k, v)},
                         RUN_N_PLAIN, graph=False)["plain"]
    k2_work = costs.flash_attention(TRAIN_BATCH, S, cfg.n_heads,
                                    cfg.kv_heads, cfg.hd, q.element_size())
    log(f"K2 flash_attention at the training shape ({TRAIN_BATCH}, {S}, "
        f"{cfg.n_heads}, {cfg.hd}) bf16: {k2_ms:.4f} ms, one SDPA call "
        f"{k2_lib_ms:.4f} ms ({RUN_N} launches per CUDA graph and event "
        f"pair, kernel and SDPA in turns), plain {k2_plain_ms:.4f} ms — on "
        f"{card}")
    log(f"K2 and SDPA issued from Python ({RUN_N} calls per event pair, in "
        f"turns): K2 {k2_eager['kernel']:.4f} ms, SDPA "
        f"{k2_eager['library']:.4f} ms per call — on {card}")

    L, NT = cfg.n_layers, pool_k.shape[1]
    D = cfg.kv_heads * cfg.hd
    pool = pool_k.view(L, NT, D)
    tab = np.arange(SLOTS * nblk_slot, dtype=np.int32) % (NT // BLOCK)
    tab_dev = torch.as_tensor(tab).cuda()
    pool_blocks = pool.view(L, NT // BLOCK, BLOCK * D)

    def k12():
        kp.paged_gather(pool, tab_dev, BLOCK)

    def k12_lib():
        pool_blocks.index_select(1, tab_dev)

    def k12_host():
        kp.paged_gather(pool, tab, BLOCK)

    k12_run = run_ms({"kernel": k12, "library": k12_lib}, RUN_N)
    k12_ms, k12_lib_ms = k12_run["kernel"], k12_run["library"]
    k12_eager = run_ms({"kernel": k12, "library": k12_lib, "host": k12_host},
                       RUN_N, graph=False)
    k12_plain_ms = run_ms({"plain": lambda: kp.paged_gather_plain(
        pool, tab_dev, BLOCK)}, RUN_N, graph=False)["plain"]
    k12_work = costs.paged_gather(L, tab.size, BLOCK, D,
                                  pool.element_size())
    log(f"K12 paged_gather, one decode step ({tab.size} blocks × {L} layers)"
        f": {k12_ms:.4f} ms with the device table, index_select "
        f"{k12_lib_ms:.4f} ms on the same table ({RUN_N} launches per CUDA "
        f"graph and event pair, in turns), plain {k12_plain_ms:.4f} ms — on "
        f"{card}")
    log(f"K12 and index_select issued from Python ({RUN_N} calls per event "
        f"pair, in turns): K12 {k12_eager['kernel']:.4f} ms, index_select "
        f"{k12_eager['library']:.4f} ms per call")
    log(f"K12 wrapper with a host table (check, pinned upload, launch): "
        f"{k12_eager['host']:.4f} ms per call ({RUN_N} calls per event "
        f"pair) — on {card}")
    log("the earlier yardstick, one event pair per launch, median of 20: K2 "
        f"{cuda_ms(k2, 20):.4f} ms, SDPA {cuda_ms(k2_lib, 20):.4f} ms, K12 "
        f"with the host table {cuda_ms(k12_host, 20):.4f} ms, index_select "
        f"{cuda_ms(k12_lib, 20):.4f} ms — on {card}")

    zf = "src/repro_torch/kernels/zo_fused/csrc/"
    zr = "src/repro/kernels/zo_fused/"
    rows = []
    sizes = [(p.numel(), p.element_size()) for p in leaves]
    sel = [(rb.selected_elems(), p.numel(), p.element_size())
           for rb, p in zip(plans, leaves)]
    for name, src, rep, err, lib_ms, work in (
            ("zo_affine", zf + "zo_affine.cu", zr + "kernel.py:233", k1_err,
             None, [costs.zo_affine(n, es) for n, es in sizes]),
            ("zo_affine_chain", zf + "zo_multi.cu", zr + "multi.py:137", 0.0,
             None, [costs.zo_affine_chain(n, es, B_SEEDS)
                    for n, es in sizes]),
            ("zo_affine_multi", zf + "zo_multi.cu", zr + "multi.py:80", 0.0,
             None, [costs.zo_affine_fanout(n, es, B_SEEDS)
                    for n, es in sizes]),
            ("zo_affine_batched", zf + "zo_multi.cu", zr + "kernel.py:283",
             0.0, None, [costs.zo_affine_fanout(n, es, B_SEEDS)
                         for n, es in sizes]),
            ("zo_sqnorm", zf + "zo_sqnorm.cu", zr + "multi.py:200", 0.0,
             None, [costs.zo_sqnorm(n) for n, _ in sizes]),
            # the rows kernels: K7 / K9 read and write the selected elements
            # once; K8 reads θ once and writes B copies of it; K10 moves
            # nothing; z on the selected elements only
            ("zo_affine_rows", zf + "zo_rows.cu", zr + "rows.py:161", 0.0,
             None, [costs.zo_affine_rows(ns, es) for ns, _, es in sel]),
            ("zo_affine_multi_rows", zf + "zo_rows.cu", zr + "rows.py:219",
             0.0, None, [costs.zo_affine_multi_rows(n, ns, es, B_SEEDS)
                         for ns, n, es in sel]),
            ("zo_affine_chain_rows", zf + "zo_rows.cu", zr + "rows.py:287",
             0.0, None, [costs.zo_affine_chain_rows(ns, es, B_SEEDS)
                         for ns, _, es in sel]),
            ("zo_sqnorm_rows", zf + "zo_rows.cu", zr + "rows.py:355", 0.0,
             None, [costs.zo_sqnorm_rows(ns) for ns, _, _ in sel])):
        ms, pms = times[name]
        bms, by = costs.bound_ms(work)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    for name, src, rep, err, ms, pms, lms, work in (
            ("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:89", k2_err, k2_ms,
             k2_plain_ms, k2_lib_ms, k2_work),
            ("paged_gather", "src/repro_torch/kernels/paged/csrc/paged_gather.cu",
             "src/repro/kernels/paged/gather.py:54", 0.0, k12_ms,
             k12_plain_ms, k12_lib_ms, k12_work)):
        bms, by = costs.bound_ms(work)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "library_ms": lms})
    log(f"shapes: zo_affine = one record over all {len(leaves)} leaves; "
        f"zo_affine_chain = one {B_SEEDS}-stream update over all leaves; "
        f"zo_affine_multi / zo_affine_batched = one {B_SEEDS}-stream fan-out "
        f"over all leaves; zo_sqnorm = one stream's ||z||^2 over all leaves "
        f"({n_all} elements) in one zo_sqnorm_many call; the *_rows kernels "
        f"the same work under {ROWS} at phase 0 ({n_sel} selected elements; "
        "zo_sqnorm_rows in one zo_sqnorm_rows_many call); flash_attention = "
        f"the "
        f"training shape ({TRAIN_BATCH}, {S}, {cfg.n_heads}, {cfg.hd}) bf16; "
        f"paged_gather = one decode-step gather of {tab.size} blocks × {L} "
        f"layers; kernel ms = median of 10 (K1, K6, K7, K10) or 5 (K3-K5, "
        f"K8, K9) CUDA-event pairs, K2 / K12 and their library calls the "
        f"median of 4 rounds of {RUN_N} back-to-back launches in one CUDA "
        f"graph per event pair (K12 with the device table); plain ms = one "
        f"host-clock run (K2, K12: rounds of {RUN_N_PLAIN} / {RUN_N} calls "
        f"issued from Python)")
    return rows


# --------------------------------------------------------------------------- #
# The paper's own models: roberta-large, opt-13b, opt-30b
# --------------------------------------------------------------------------- #
def free_card(torch, what: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{what} freed: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        "still allocated")


def init_logged(torch, arch: str, **replace):
    """(cfg with ``pallas_flash`` and ``replace``, θ₀ on the card): the
    registry's init from seed 0, timed, its peak allocation over the
    parameters logged and held to the largest f32 draw (one layer's slice
    of a stacked leaf, or a whole 2-D leaf) — the initializer allocates
    each leaf once."""
    from repro_torch.models import all_archs, bundle
    from repro_torch.tree_utils import tree_leaves
    cfg = all_archs()[arch].cfg.replace(attention_impl="pallas_flash",
                                        **replace)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle(cfg).init(0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    nbytes = sum(p.numel() * p.element_size() for p in leaves)
    draw = 4 * max(p[0].numel() if p.dim() >= 3 else p.numel()
                   for p in leaves)
    extra = torch.cuda.max_memory_allocated() - base - nbytes
    if extra > draw + (64 << 20):
        fail(f"{arch} init: {extra / 2**30:.3f} GiB over the parameters, "
             f"more than the largest f32 draw {draw / 2**30:.3f} GiB")
    log(f"{arch}: {n} params bf16 in {len(leaves)} leaves ({nbytes / 2**30:.2f}"
        f" GiB; JAX's analytic n_params {cfg.n_params()}, active "
        f"{cfg.n_active_params()}), {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads × {cfg.hd}, d_ff {cfg.d_ff}; init on the card "
        f"{init_s:.1f} s, peak {extra / 2**30:.3f} GiB over the parameters "
        f"(largest f32 draw {draw / 2**30:.3f} GiB)")
    return cfg, params


def checksums(torch, tree) -> list:
    """A bitwise checksum per leaf, computed on the card: the int64 sums of
    the raw bits and of the bits times (index mod 65521) + 1."""
    from repro_torch.tree_utils import tree_leaves
    out = []
    for leaf in tree_leaves(tree):
        flat = bits_of(leaf).reshape(-1)
        s1 = s2 = 0
        for lo in range(0, flat.numel(), CHUNK):
            b = flat[lo:lo + CHUNK].to(torch.int64)
            w = torch.arange(lo, lo + b.numel(), device=b.device) % 65521 + 1
            s1 += int(b.sum())
            s2 += int((b * w).sum())
        out.append((s1, s2))
    return out


def sample_slices(tree) -> dict:
    """{path: slice} of a few slices per leaf: the whole of each 1-D leaf
    outside ``layers`` (the final norm), and layers 0 and L−1 of each
    stacked leaf."""
    from repro_torch.tree_utils import flatten_with_path
    out = {}
    for path, leaf in flatten_with_path(tree):
        if "layers" in path:
            out[path + "[0]"], out[path + "[-1]"] = leaf[0], leaf[-1]
        elif leaf.dim() == 1:
            out[path] = leaf
    return out


def samples_vs(torch, name, tree, samples) -> None:
    """``tree``'s slices against ``samples`` (host copies of the trained
    θ's) within the sequential-spsa bf16-ulp bound of ``name``."""
    got = sample_slices(tree)
    text = hold_ulps(torch, name, ((got[k], want.to("cuda"))
                                   for k, want in samples.items()))
    log(f"{name}: replay vs trained θ on {len(samples)} sampled slices "
        f"(layers 0 and L−1 of every stacked leaf, the final norm): {text}")


def hold_windows(torch, np, leaf, what) -> None:
    """K1 (one ``pallas+z2`` write) and then X1 (one bf16 axpbz write), each
    in place over the whole of ``leaf``, held bitwise to their plain
    versions on WINDOW-element windows: the first elements, those around
    every counter multiple of 2^31 the leaf reaches, and the last.  K1's
    counter is the flat index mod 2^32 (JAX's uint32 counter wraps); X1's
    the 64-bit index (threefry's two counter words)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.threefry import kernel as x1
    from repro_torch.kernels.zo_fused import kernel as kz
    flat = leaf.view(-1)
    n = flat.numel()
    starts = sorted({0, n - WINDOW} | {
        m - WINDOW // 2 for m in range(1 << 31, n, 1 << 31)})
    seed, key, bval = 987654321, (31337, 7), -0.0001220703125
    for kernel in ("K1", "X1"):
        saved = [(s, flat[s:s + WINDOW].clone()) for s in starts]
        _build.reset_launch_counts()
        if kernel == "K1":
            kz.zo_affine(leaf, seed, 1.0, 1e-3, out=leaf)
        else:
            x1.zo_affine_threefry(leaf, key, "axpbz", a=1.0, b=bval,
                                  out=leaf)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        for s, x in saved:
            if kernel == "K1":
                want = kz.zo_affine_plain(x, seed, 1.0, 1e-3, offset=s)
            else:
                want = x1.zo_affine_threefry_plain(x, key, "axpbz", a=1.0,
                                                   b=bval, offset=s)
            if not same_bits(flat[s:s + WINDOW], want):
                fail(f"{kernel} on {what} != its plain version on the window "
                     f"at {s}")
        log(f"{kernel} on {what} ({n} elements, bf16, in place; launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
            + f"): windows of {WINDOW} at " + ", ".join(map(str, starts))
            + " bitwise its plain version")
    _build.reset_launch_counts()


def require_signal(name, ledger) -> int:
    """The number of steps whose recorded g is nonzero; fails at none — an
    objective that stays put between θ + εz and θ − εz records g = 0 at
    every step, and then only the bf16 roundings of θ ± εz move θ."""
    moved = sum(1 for g in ledger.grads if g != 0.0)
    if moved == 0:
        fail(f"{name}: every recorded g is 0 — the objective never moved "
             "between θ + εz and θ − εz")
    return moved


class FixedBatches:
    """A pipeline of given batches, ``batches[step]`` at each step, with the
    ``spec`` and ``seq_len`` of the pipeline they were drawn from."""

    def __init__(self, pipe, batches: dict):
        self.spec, self.seq_len, self._batches = pipe.spec, pipe.seq_len, \
            batches

    def batch(self, step: int) -> dict:
        return self._batches[step]


def record_k2_shapes(shapes: set):
    """Records the shape of every K2 call the models make into ``shapes``
    (the attention module calls the wrapper by its module-level name);
    returns the function that stops the recording."""
    from repro_torch.models import attention
    inner = attention.flash_attention

    def recording(q, k, v, **kw):
        shapes.add((tuple(q.shape), k.shape[2], q.dtype, kw.get("causal", True),
                    kw.get("window", 0)))
        return inner(q, k, v, **kw)

    attention.flash_attention = recording

    def stop():
        attention.flash_attention = inner
    return stop


def hold_k2_shapes(torch, kf, shapes: set, what: str) -> None:
    """K2 against its plain version on random q, k, v at every recorded
    shape (B, S, H, hd) with its KV heads, dtype and window."""
    if not shapes:
        fail(f"K2: no call recorded on {what}")
    g = torch.Generator(device="cuda").manual_seed(22)
    worst = 0.0
    for (B, S, H, hd), KV, dt, causal, window in sorted(shapes, key=str):
        if not causal:
            fail(f"K2 was called with causal=False on {what}")
        q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
                for _ in range(2))
        worst = max(worst, _hold_k2(torch, kf, q, k, v, window,
                                    f"at ({B}, {S}, {H}, {hd}) KV {KV}"))
    log(f"K2 held to its plain version at every shape {what} gave it "
        f"({len(shapes)}: " + ", ".join(
            f"{tuple(sh)} KV {kv}" for sh, kv, *_ in sorted(shapes, key=str))
        + f"), max abs err {worst:.2e}")


def roberta_paths(torch, np, _build, counts, step_ms, card) -> None:
    """(k) roberta-large at full width (24 layers, d 1024, 16 × 64,
    causal=False, GELU, sinusoidal positions, bf16): mezo spsa on ``xla``
    under the accuracy objective on prompt-classification batches through
    the training loop with a ledger and a checkpoint; two replays bitwise
    equal and within the ulp bound of the trained θ; K2 launched zero times
    (JAX's routing rule sends causal=False to the chunked path), X1 on
    every write; label-word accuracy before and after, printed only.  θ₀'s
    head columns of the label words are scaled by VERBALIZER_GAIN, and the
    phase fails unless some step records a nonzero g."""
    from repro_torch import zo
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.data.synthetic import PromptClassification
    from repro_torch.models import bundle
    from repro_torch.perturb.stream import prng_key
    from repro_torch.tree_utils import is_floating, tree_leaves
    cfg, params0 = init_logged(torch, "roberta-large")
    b = bundle(cfg)
    task = PromptClassification(vocab=cfg.vocab_size, seed=SEED)
    words = task.label_word(torch.arange(task.n_classes))
    params0["head"][:, words] *= VERBALIZER_GAIN
    pipe = Pipeline(DataSpec("prompt_cls", batch=PAPER_BATCH,
                             vocab=cfg.vocab_size, seed=SEED), device="cuda")
    loss_fn = b.loss_fn("accuracy")
    memory_and_busy(torch, cfg, params0, backend="xla", loss_fn=loss_fn,
                    batch=pipe.batch(0))
    with torch.no_grad():
        obj0 = -float(loss_fn(params0, pipe.batch(0)))

    def accuracy(params):
        return task.eval_accuracy(cfg, b.train_logits_fn(), params,
                                  prng_key(SEED + 1), n=256, device="cuda")

    acc0 = accuracy(params0)
    name = "k_roberta_acc"

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="xla")

    p, led, _, ms = train_phase(torch, cfg, params0, name, make_opt, None,
                                _build, counts, loss_fn=loss_fn, pipe=pipe)
    step_ms[name] = ms
    moved = require_signal(name, led)
    got = dict(_build.launch_counts)
    n_leaves = sum(1 for q in tree_leaves(params0) if is_floating(q))
    want_x1 = 3 * n_leaves * ALL_STEPS[name]
    if got["flash_attention"] or got["zo_affine_threefry"] != want_x1:
        fail(f"{name}: K2 launched {got['flash_attention']} times (0 under "
             f"causal=False), X1 {got['zo_affine_threefry']} (3 writes × "
             f"{n_leaves} leaves × {ALL_STEPS[name]} steps = {want_x1})")
    r1 = check_replays(torch, name, params0, p, led, make_opt)
    acc1 = accuracy(p)
    log(f"{name}: K2 0 launches (causal=False takes the chunked path), X1 "
        f"{want_x1} (every write of every leaf); g nonzero at {moved} of "
        f"{len(led)} steps (the label words' head columns × "
        f"{VERBALIZER_GAIN}: accuracy over the whole vocabulary "
        f"{obj0:.4f} on the first batch at θ₀); label-word accuracy on 256 "
        f"held-out prompts {acc0:.4f} before, {acc1:.4f} after "
        f"{ALL_STEPS[name]} steps (random weights: printed, not a claim) — "
        f"on {card}")
    del p, r1, params0


def opt13b_paths(torch, np, _build, counts, step_ms, card) -> None:
    """opt-13b at full width and depth (40 layers, d 5120, 40 × 128, d_ff
    20480, ReLU, LayerNorm, bf16, ``pallas_flash``): (l) mezo spsa on
    ``xla``, CE on 16 × 256 lm batches, peak gated at 1.10 × one forward's,
    the step's profiler breakdown; two replays of its ledger from θ₀
    regenerated from the seed, bitwise equal and within the ulp bound of
    the trained θ; the fine-tune served through the paged engine (X1, K2 at
    hd 128, K12), K12 held to its plain version at the serving pool's
    shape first and the served ids to a serve through the plain gather;
    (m) the F1 objective on span-extraction batches whose labels are θ's
    own greedy answers; K1 / X1 on windows of the 4.19e9-element w1
    leaf."""
    from repro_torch import zo
    from repro_torch.core import replay
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.kernels.paged import gather as kp
    from repro_torch.models import all_archs, bundle
    from repro_torch.serve import engine as serve_engine
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import tree_leaves
    big = all_archs()["opt-13b"].cfg
    n_blocks = 1 + 2 * SLOTS * (OPT_MAX_LEN // BLOCK)
    check_k12(torch, kp, big.n_layers, n_blocks, big.kv_heads * big.hd,
              OPT_MAX_LEN)
    free_card(torch, "K12's check at opt-13b's pool")
    cfg, params = init_logged(torch, "opt-13b")
    b = bundle(cfg)
    sums0 = checksums(torch, params)
    memory_and_busy(torch, cfg, params, backend="xla")
    name = "l_opt13b_spsa"

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="xla")

    trained, led, _, ms = train_phase(torch, cfg, params, name, make_opt,
                                      None, _build, counts, in_place=True,
                                      with_ckpt=False)
    step_ms[name] = ms
    # the fine-tune: θ₀ from the seed again, its ledger replayed (X1) and
    # held to the trained θ, which is then freed; the fine-tune served
    prompts = workload(np, cfg.vocab_size)
    warm, _, _ = serve(cfg, trained, prompts[:1], True, max_len=OPT_MAX_LEN)
    del warm                                        # cuBLAS warm-up
    r1 = b.init(0, device="cuda")
    if checksums(torch, r1) != sums0:
        fail("opt-13b: θ₀ regenerated from the seed differs from θ₀")
    _build.reset_launch_counts()
    replay(r1, led, composition_for_ledger(led))
    text = hold_ulps(torch, name, zip(tree_leaves(r1), tree_leaves(trained)))
    del trained, params
    free_card(torch, "opt-13b's trained θ")
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, wall = serve(cfg, r1, prompts, True, max_len=OPT_MAX_LEN)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention",
                                "paged_gather"), "serve the opt-13b fine-tune")
    if any(len(r.out_ids) != NEW_TOKENS for r in reqs):
        fail("an opt-13b request did not produce its tokens")
    pool = tuple(eng.pool.k.shape)
    if pool != (cfg.n_layers, n_blocks * BLOCK, cfg.kv_heads, cfg.hd):
        fail(f"opt-13b's serving pool {pool} is not the one K12 was held "
             f"to: {n_blocks} blocks of {BLOCK}")
    ps = eng.prefix_stats()
    tokens = tokens_of([r.out_ids for r in reqs])
    ttft = sorted(r.times["prefill"] - r.times["queued"] for r in reqs)
    log(f"opt-13b served {len(reqs)} requests / {tokens} tokens in "
        f"{wall:.3f} s: {tokens / wall:.1f} tok/s, TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms, peak memory "
        f"{peak / 2**30:.2f} GiB (pool {eng.pool.k.numel() * 4 / 2**30:.2f}"
        f" GiB of K and V), prefix hit rate {ps['prefix_hit_rate']:.2f} — "
        f"on {card}")
    del eng
    # the served ids against two more serves: through K12's plain version
    # (K12 is its plain version bit for bit, so every id must agree), and
    # with the prefix cache off (bf16 near-ties may flip: reported)
    ids = [r.out_ids for r in reqs]
    serve_engine.paged_gather = kp.paged_gather_plain
    try:
        _, plain_reqs, _ = serve(cfg, r1, prompts, True, max_len=OPT_MAX_LEN)
    finally:
        serve_engine.paged_gather = kp.paged_gather
    if [r.out_ids for r in plain_reqs] != ids:
        fail("opt-13b: the served ids differ when the engine gathers "
             "through K12's plain version")
    _, off, _ = serve(cfg, r1, prompts, False, max_len=OPT_MAX_LEN)
    same = sum(a == b for r, o in zip(reqs, off)
               for a, b in zip(r.out_ids, o.out_ids))
    log(f"opt-13b served ids: identical through K12's plain gather "
        f"({tokens} tokens); with the prefix cache off, bf16 ids agree on "
        f"{same}/{tokens}")
    del plain_reqs, off
    # a second replay, bitwise the first
    r2 = b.init(0, device="cuda")
    replay(r2, led, make_opt())
    torch.cuda.synchronize()
    for x, y in zip(tree_leaves(r1), tree_leaves(r2)):
        if not same_bits(x, y):
            fail(f"{name}: two replays of the ledger differ")
    del r2
    log(f"{name}: replay ≡ replay bitwise; replay vs trained θ: {text}")
    # (m) the F1 objective on span extraction, on the served fine-tune.  A
    # random model's greedy answer shares no token with a random span, so
    # F1 is 0 at θ ± εz alike; the labels under the mask are θ's own greedy
    # answers (F1 = 1 at θ), which θ ± εz moves
    name = "m_opt13b_f1"
    span = Pipeline(DataSpec("span", batch=PAPER_BATCH, vocab=cfg.vocab_size,
                             seed=SEED), device="cuda")
    f1, logits_fn = b.loss_fn("f1"), b.train_logits_fn()
    batches = {}
    with torch.no_grad():
        task_f1 = -float(f1(r1, span.batch(0)))
        for step in range(ALL_STEPS[name]):
            bt = dict(span.batch(step))
            pred = torch.argmax(logits_fn(r1, bt)[..., :cfg.vocab_size], -1)
            bt["labels"] = torch.where(bt["loss_mask"] > 0,
                                       pred.to(bt["labels"].dtype),
                                       bt["labels"])
            batches[step] = bt
    _, led, _, ms = train_phase(torch, cfg, r1, name, make_opt, None, _build,
                                counts, loss_fn=f1,
                                pipe=FixedBatches(span, batches),
                                in_place=True, with_ckpt=False)
    step_ms[name] = ms
    log(f"{name}: g nonzero at {require_signal(name, led)} of {len(led)} "
        f"steps; F1 on the task's own labels at θ {task_f1:.4f}")
    hold_windows(torch, np, r1["layers"]["mlp"]["w1"],
                 "opt-13b's w1 (40, 5120, 20480)")
    del r1


def opt30b_paths(torch, np, _build, counts, step_ms, card) -> None:
    """opt-30b at full width and depth (48 layers, d 7168, 56 × 128, d_ff
    28672, 56.47 GiB of bf16) initialized on the card: (n) mezo spsa on
    ``xla``, CE on 16 × 256 lm batches, in place, peak gated at 1.10 × one
    forward's and printed against the card's memory; two in-place replays
    from θ₀ regenerated from the seed — no second copy of θ fits — their
    per-leaf checksums equal, the first within the ulp bound of host
    samples of the trained θ; K1 / X1 on windows of the 9.87e9-element w1
    leaf, across counters 2^31, 2^32 and 2^33.  opt-66b is only logged."""
    from repro_torch import zo
    from repro_torch.core import replay
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import all_archs, bundle
    cfg, params = init_logged(torch, "opt-30b")
    b = bundle(cfg)
    sums0 = checksums(torch, params)
    loss_fn = b.loss_fn()
    batch = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                              vocab=cfg.vocab_size, seed=SEED),
                     device="cuda").batch(0)
    with torch.no_grad():
        loss_fn(params, batch).item()                    # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        loss_fn(params, batch).item()
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated() - base
    del batch
    name = "n_opt30b_spsa"

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="xla")

    torch.cuda.reset_peak_memory_stats()
    trained, led, _, ms = train_phase(torch, cfg, params, name, make_opt,
                                      None, _build, counts, in_place=True,
                                      with_ckpt=False)
    step_ms[name] = ms
    peak_abs = torch.cuda.max_memory_allocated()
    stp = peak_abs - base
    _, total = torch.cuda.mem_get_info()
    if stp > MEM_SLACK * fwd:
        fail(f"{name}: the steps peak {stp / 2**30:.3f} GiB over θ > "
             f"{MEM_SLACK} × one forward's {fwd / 2**30:.3f} GiB")
    log(f"memory (opt-30b): {ALL_STEPS[name]} spsa steps peak at "
        f"{stp / 2**30:.3f} GiB over θ, one forward (no_grad) at "
        f"{fwd / 2**30:.3f} GiB — ratio {stp / fwd:.4f}; the whole peak "
        f"{peak_abs / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB "
        f"({100 * peak_abs / total:.1f}%) — on {card}")
    samples = {k: v.cpu() for k, v in sample_slices(trained).items()}
    # one more step's profile, in place on the trained θ (its samples are
    # taken; no second copy of θ fits)
    batch = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                              vocab=cfg.vocab_size, seed=SEED),
                     device="cuda").batch(0)
    opt = make_opt()
    holder = {"p": trained, "s": opt.init(trained, seed=SEED)}
    step = opt.step_fn(loss_fn)

    def one():
        holder["p"], holder["s"], _ = step(holder["p"], holder["s"], batch)

    log(busy_line(f"one spsa on xla step ({TRAIN_BATCH} × {TRAIN_SEQ} "
                  f"tokens, {cfg.name}, {cfg.n_layers} layers)",
                  *device_busy(torch, one, 2)))
    del holder, opt, step, batch, trained, params
    free_card(torch, "opt-30b's trained θ")
    sums = []
    for rep in range(2):
        p = b.init(0, device="cuda")
        if checksums(torch, p) != sums0:
            fail("opt-30b: θ₀ regenerated from the seed differs from θ₀")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        replay(p, led, make_opt())
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        if rep == 0:
            add_counts(counts, _build, ("zo_affine_threefry",),
                       "replay the opt-30b fine-tune")
            samples_vs(torch, name, p, samples)
        sums.append(checksums(torch, p))
        log(f"{name}: in-place replay {rep + 1} of {len(led)} records in "
            f"{replay_s:.3f} s")
        if rep == 0:
            del p
            free_card(torch, "opt-30b's first replay")
    if sums[0] != sums[1]:
        fail(f"{name}: the two in-place replays' checksums differ")
    log(f"{name}: the two in-place replays' per-leaf checksums are equal "
        f"({len(sums[0])} leaves)")
    hold_windows(torch, np, p["layers"]["mlp"]["w1"],
                 "opt-30b's w1 (48, 7168, 28672)")
    del p, samples
    big = all_archs()["opt-66b"].cfg
    log(f"opt-66b: {big.n_params()} params by JAX's n_params, "
        f"{2 * big.n_params() / 2**30:.1f} GiB of bf16 against the card's "
        f"{total / 2**30:.2f} GiB: not run on one card (its shapes wait for "
        "launch/dryrun)")


# --------------------------------------------------------------------------- #
# The backprop baseline (train.adam) against MeZO, and the memory reckoning
# --------------------------------------------------------------------------- #
def _peak_forward(torch, loss_fn, params, batch) -> tuple:
    """(total peak, peak over what was allocated before) of one no_grad
    forward, after a warm-up forward."""
    with torch.no_grad():
        loss_fn(params, batch).item()                    # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        loss_fn(params, batch).item()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - base


def bp_run(torch, np, _build, counts, step_ms, card, arch, name, make_opt,
           pipe, steps) -> dict:
    """One run of (o) / (p), CE under ``xla`` attention: θ₀ from seed 0 on
    the card (each run from a fresh θ₀, so each total peak is this run's
    alone), one forward's peak, ``steps`` steps through ``train.loop.train``, their
    peak over the resident θ and in total, ms per step (host clock,
    median of steps 2..), then one more step under torch.profiler.  Adam /
    SGD runs launch none of the port's kernels (JAX's default ``xla``
    attention, no z) and are held to finite losses, a finite gradient norm
    > 0, θ moved and f32 moments; MeZO runs (X1 on every write) to a peak
    within MEM_SLACK × one forward's."""
    from repro_torch.models import all_archs, bundle
    from repro_torch.train import Adam
    from repro_torch.train.loop import train
    from repro_torch.tree_utils import tree_leaves
    cfg = all_archs()[arch].cfg.replace(attention_impl="xla")
    params = bundle(cfg).init(0, device="cuda")
    loss_fn = bundle(cfg).loss_fn()
    batch0 = pipe.batch(0)
    fwd_total, fwd_over = _peak_forward(torch, loss_fn, params, batch0)
    probe = {k: tree_leaves(params)[i].reshape(-1)[:4096].clone()
             for k, i in (("first", 0), ("last", -1))}
    opt = make_opt()
    backprop = isinstance(opt, Adam)
    clock = StepClock()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = train(loss_fn, params, opt, pipe, total_steps=steps,
                monitor=clock.mon, log_every=1, seed=SEED)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if backprop:
        got = {k: v for k, v in _build.launch_counts.items() if v}
        if got:
            fail(f"{name}: the backprop run launched the port's kernels "
                 f"{got} (its path has none: xla attention, no z)")
    else:
        add_counts(counts, _build, ("zo_affine_threefry",), f"train {name}")
    losses = [loss for _, loss in res.losses]
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"{name}: losses not finite: {losses}")
    ms = float(np.median(clock.dts[1:])) * 1e3
    step_ms[name] = ms
    params, state = res.params, res.opt_state
    step = opt.step_fn(loss_fn)
    holder = {"p": params, "s": state, "m": None}

    def one():
        holder["p"], holder["s"], holder["m"] = step(holder["p"],
                                                     holder["s"], batch0)

    busy = busy_line(f"one {name} step", *device_busy(torch, one, 2))
    _build.reset_launch_counts()
    if backprop:
        gn = float(holder["m"]["grad_norm"])
        if not (np.isfinite(gn) and gn > 0):
            fail(f"{name}: grad_norm {gn} is not finite and > 0")
        if all(torch.equal(v, tree_leaves(holder["p"])[i].reshape(-1)[:4096])
               for v, i in ((probe["first"], 0), (probe["last"], -1))):
            fail(f"{name}: θ did not move")
        moments = tree_leaves((holder["s"].m, holder["s"].v))
        if any(t.dtype != torch.float32 for t in moments):
            fail(f"{name}: m / v are not f32 after step 1")
        extra = (f"grad_norm {gn:.4g}; m, v f32 ({len(moments)} leaves, "
                 f"{sum(t.numel() * 4 for t in moments) / 2**30:.3f} GiB)")
        del moments
    else:
        extra = "X1 on every write"
    log(f"{name} ({cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{pipe.spec.batch} × {pipe.seq_len} tokens): {steps} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, {ms:.1f} ms per step "
        f"(median, steps 2..); one forward peaks at {fwd_total / 2**30:.3f} "
        f"GiB ({fwd_over / 2**30:.3f} over θ); the steps peak at "
        f"{peak / 2**30:.3f} GiB in total, {(peak - base) / 2**30:.3f} GiB "
        f"over the resident θ ({base / 2**30:.3f} GiB); {extra} — on {card}")
    log(busy)
    if not backprop and peak > MEM_SLACK * fwd_total:
        fail(f"{name}: the MeZO steps peak at {peak / 2**30:.3f} GiB > "
             f"{MEM_SLACK} × one forward's {fwd_total / 2**30:.3f} GiB")
    del holder, params, state, res, step, opt
    free_card(torch, f"{name}'s trees")
    return {"total": peak, "over": peak - base, "fwd": fwd_total, "ms": ms}


def backprop_paths(torch, np, _build, counts, step_ms, card) -> None:
    """(o) roberta-large FT, the paper's Table 1 baseline: CE on
    ``PromptClassification(vocab=50265)`` (seq 32), batch 16, Adam
    (lr 1e-5, 10 steps) beside MeZO spsa on ``xla`` (10 steps, the same
    batches); (p) qwen2-0.5b on 16 × 256 lm batches under ``xla``
    attention: Adam, SGD and MeZO spsa, 5 steps each.  Every run at full
    width and depth from θ₀ of seed 0; the Adam-to-MeZO ratio of total
    peaks (the paper's measure) printed per model."""
    from repro_torch import zo
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import all_archs
    from repro_torch.train import Adam, AdamConfig

    def mezo():
        return zo.mezo(lr=LR, eps=EPS, backend="xla")

    for arch, kind, runs in (
            ("roberta-large", "o_roberta",
             {"o_roberta_adam": lambda: Adam(AdamConfig(
                 lr=1e-5, total_steps=BACKPROP_STEPS["o_roberta"])),
              "o_roberta_mezo": mezo}),
            ("qwen2-0.5b", "p_qwen2",
             {"p_qwen2_adam": lambda: Adam(AdamConfig(
                 lr=1e-4, total_steps=BACKPROP_STEPS["p_qwen2"])),
              "p_qwen2_sgd": lambda: Adam(AdamConfig(
                  lr=1e-3, sgd=True, total_steps=BACKPROP_STEPS["p_qwen2"])),
              "p_qwen2_mezo": mezo})):
        vocab = all_archs()[arch].cfg.vocab_size
        spec = (DataSpec("prompt_cls", batch=PAPER_BATCH, vocab=vocab,
                         seed=SEED) if kind == "o_roberta" else
                DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=vocab,
                         seed=SEED))
        pipe = Pipeline(spec, device="cuda")
        got = {name: bp_run(torch, np, _build, counts, step_ms, card, arch,
                            name, make, pipe, BACKPROP_STEPS[kind])
               for name, make in runs.items()}
        adam, zo_run = got[f"{kind}_adam"], got[f"{kind}_mezo"]
        log(f"Adam-to-MeZO ratio of total peaks ({arch}): "
            f"{adam['total'] / 2**30:.3f} / {zo_run['total'] / 2**30:.3f} "
            f"GiB = {adam['total'] / zo_run['total']:.2f}× (over the resident θ: "
            f"{adam['over'] / 2**30:.3f} / {zo_run['over'] / 2**30:.3f} "
            "GiB); "
            + ", ".join(f"{n} {g['total'] / 2**30:.3f} GiB, {g['ms']:.1f} ms"
                        for n, g in got.items()) + f" — on {card}")


def _adam_card_vs_cpu(torch, _build, cfg, what: str) -> dict:
    """One Adam step of ``cfg`` in f32 (TF32 off) on the CPU and on the
    card from the same θ₀ and batch (BP_BATCH × BP_SEQ): the loss, the
    gradient norm, every gradient leaf (the step's own ``value_and_grad``,
    recorded) and the updated θ within the stated tolerances.  Returns the
    card run's launch and record counts."""
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import bundle
    from repro_torch.train import Adam, AdamConfig
    from repro_torch.train import adam as adam_mod
    from repro_torch.train.adam import value_and_grad
    from repro_torch.tree_utils import flatten_with_path, tree_leaves, \
        tree_map
    loss_fn = bundle(cfg).loss_fn()
    cpu0 = bundle(cfg).init(0, device="cpu")
    batch = Pipeline(DataSpec("lm", batch=BP_BATCH, seq=BP_SEQ,
                              vocab=cfg.vocab_size, seed=SEED),
                     device="cpu").batch(0)
    out, seen = {}, {}
    taken = {}

    def recording(fn, params, b):
        """``value_and_grad`` as the Adam step calls it, its gradients kept
        (one forward and backward a device)"""
        loss, grads = value_and_grad(fn, params, b)
        taken["grads"] = [(k, g.cpu()) for k, g in flatten_with_path(grads)]
        return loss, grads

    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True), cpu0)
        b = {k: v.to(dev) for k, v in batch.items()}
        _build.reset_launch_counts()
        opt = Adam(AdamConfig(lr=BP_LR))
        adam_mod.value_and_grad = recording
        try:
            p, state, m = opt.step_fn(loss_fn)(p, opt.init(p), b)
        finally:
            adam_mod.value_and_grad = value_and_grad
        torch.cuda.synchronize()
        seen = {**_build.launch_counts, **_build.record_counts}
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    taken.pop("grads"), [t.cpu() for t in tree_leaves(p)])
        del p, state
    del cpu0
    (lc, nc, gc, pc), (lg, ng, gg, pg) = out["cpu"], out["cuda"]
    if abs(lc - lg) > BP_LOSS_REL * abs(lc):
        fail(f"(q) {what}: loss on the card {lg} vs the CPU {lc}")
    if abs(nc - ng) > BP_GRAD_REL * nc:
        fail(f"(q) {what}: grad_norm on the card {ng} vs the CPU {nc}")
    worst_g = 0.0
    for (path, a), (_, b) in zip(gc, gg):
        rel = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        worst_g = max(worst_g, rel)
        if rel > BP_GRAD_REL:
            fail(f"(q) {what}: gradient {path}: card vs CPU {rel:.3e} of "
                 f"its largest |g| > {BP_GRAD_REL}")
    gaps = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(pc, pg)])
    far = float((gaps > BP_THETA_ATOL * BP_LR).float().mean())
    if float(gaps.max()) > 2 * BP_LR or far > BP_THETA_OUTLIERS:
        fail(f"(q) {what}: θ after one Adam step: max gap "
             f"{float(gaps.max()):.3e} (bound 2η = {2 * BP_LR}), {far:.2e} "
             f"of the elements beyond {BP_THETA_ATOL}·η (bound "
             f"{BP_THETA_OUTLIERS})")
    log(f"(q) card ≡ CPU, one Adam step of {what}, {cfg.n_layers} layers, "
        f"f32, {BP_BATCH} × {BP_SEQ}: loss {lg:.6f} vs {lc:.6f} (bound "
        f"{BP_LOSS_REL} relative), grad_norm {ng:.6f} vs {nc:.6f}, every "
        f"one of {len(gg)} gradient leaves within {worst_g:.2e} of its "
        f"largest |g| (bound {BP_GRAD_REL}), θ max gap "
        f"{float(gaps.max()):.2e} (2η = {2 * BP_LR}), {far:.2e} of its "
        f"elements beyond {BP_THETA_ATOL}·η")
    return seen


def backprop_card_vs_cpu(torch, np, _build) -> None:
    """(q) the same port code on the card and on the CPU: one Adam step at
    qwen2-0.5b's width with BP_LAYERS layers, and one of rwkv6-3b at full
    width with BP_LAYERS layers in chunk mode — K11's forward on the card,
    its gradient the VJP of the plain chunk form (``ops.ChunkedWKV``),
    both counted — each held card ≡ CPU (``_adam_card_vs_cpu``); K2's
    refusal of autograd on the card, before any launch; and
    ``fused_recurrent`` differentiating on the card."""
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import all_archs, bundle
    from repro_torch.train.adam import value_and_grad
    from repro_torch.tree_utils import tree_leaves
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(
        n_layers=BP_LAYERS, dtype="float32", attention_impl="xla")
    _adam_card_vs_cpu(torch, _build, cfg, "qwen2-0.5b at full width")
    rcfg = all_archs()["rwkv6-3b"].cfg.replace(
        n_layers=BP_LAYERS, dtype="float32", scan_mode="chunk")
    seen = _adam_card_vs_cpu(torch, _build, rcfg,
                             "rwkv6-3b at full width in chunk mode")
    fwd, bwd = seen["wkv6_chunked"], seen["wkv6_chunked_backward"]
    if fwd == 0 or bwd == 0:
        fail(f"(q): rwkv6 chunk mode under autograd on the card: K11 "
             f"launched {fwd} times, its backward ran {bwd} times")
    log(f"(q) rwkv6-3b chunk mode under autograd on the card: K11 forward "
        f"launches {fwd}, backward records (the VJP of the plain chunk "
        f"form, recomputed) {bwd}")
    # K2 refuses autograd before any launch, as JAX's Pallas flash has no
    # backward either
    batch = Pipeline(DataSpec("lm", batch=BP_BATCH, seq=BP_SEQ,
                              vocab=cfg.vocab_size, seed=SEED),
                     device="cpu").batch(0)
    fcfg = cfg.replace(attention_impl="pallas_flash")
    params = bundle(fcfg).init(0, device="cuda")
    b = {k: v[:, :32].to("cuda") for k, v in batch.items()}
    _build.reset_launch_counts()
    try:
        value_and_grad(bundle(fcfg).loss_fn(), params, b)
    except RuntimeError as e:
        if "flash_attention" not in str(e) or "no backward" not in str(e):
            raise
        if _build.launch_counts["flash_attention"]:
            fail("(q): flash_attention launched before it refused autograd")
        log(f"(q) autograd through pallas_flash on the card refused before "
            f"any launch: {e}")
    else:
        fail("(q): autograd through pallas_flash on the card did not raise")
    del params
    scfg = all_archs()["rwkv6-3b"].smoke_cfg.replace(
        scan_mode="fused_recurrent")
    params = bundle(scfg).init(0, device="cuda")
    b = {k: (v % scfg.vocab_size if k in ("tokens", "labels") else v)
         for k, v in b.items()}
    loss, grads = value_and_grad(bundle(scfg).loss_fn(), params, b)
    if not (np.isfinite(float(loss)) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(grads))):
        fail("(q): rwkv6 fused_recurrent gradients on the card not finite")
    log(f"(q) rwkv6 fused_recurrent differentiates on the card: loss "
        f"{float(loss):.4f}, {len(tree_leaves(grads))} finite gradient "
        "leaves")
    _build.reset_launch_counts()


def reckon_adam_vs_mezo(torch, card) -> None:
    """(r) reckoned, not measured: for every registry arch, Adam's
    θ + grads (the arch's dtype) + m + v (f32) against MeZO's θ, both
    without activations, against the card's total memory."""
    from repro_torch.models import all_archs
    total = torch.cuda.get_device_properties(0).total_memory
    only_mezo = []
    for arch_id, arch in sorted(all_archs().items(),
                                key=lambda kv: kv[1].cfg.n_params()):
        cfg = arch.cfg
        n = cfg.n_params()
        width = torch.empty((), dtype=cfg.param_dtype).element_size()
        theta, adam = n * width, n * (2 * width + 8)
        fits = (adam <= total, theta <= total)
        if fits == (False, True):
            only_mezo.append(arch_id)
        log(f"reckoned, not measured — {arch_id}: {n} params; Adam θ + "
            f"grads + m + v {adam / 2**30:.2f} GiB ({2 * width + 8} B a "
            f"param), MeZO θ {theta / 2**30:.2f} GiB ({width} B), "
            f"activations not counted; of the card's {total / 2**30:.2f} "
            f"GiB Adam {'fits' if fits[0] else 'does not fit'}, MeZO "
            f"{'fits' if fits[1] else 'does not fit'}")
    log(f"reckoned, not measured: the arches MeZO holds on one {card} and "
        f"Adam does not: {', '.join(only_mezo) or 'none'}; Adam holds at "
        f"most {total / 12 / 1e9:.2f} × 10^9 bf16 parameters, MeZO "
        f"{total / 2 / 1e9:.2f} × 10^9 (before activations)")


# --------------------------------------------------------------------------- #
# X1's route for the original threefry layout
# --------------------------------------------------------------------------- #
def check_x1_original(torch, np) -> float:
    """X1's ``original`` route (``jax_threefry_partitionable`` off) against
    its plain version, bitwise: every dtype × dist × form on whole leaves
    whose word count is odd and even, windows (an offset and the leaf's
    total) that straddle the half h, a band list, and windows of virtual
    leaves past 2^32 − 1 words (one key per block, no leaf allocated); then
    against JAX's writes under that layout (``x1_original_golden.npz``):
    each form on leaves of odd and even m, the rank-1 write under a rows
    plan, and the bits of windows past 2^32 − 1 words.  Returns the max abs
    error (0 when bitwise)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.threefry import kernel as x1
    from repro_torch.perturb import XLABackend
    from repro_torch.perturb.stream import (StreamRef, fold_in,
                                            threefry_partitionable)
    from repro_torch.perturb.xla import in_dtype
    from repro_torch.select import rows
    g = torch.Generator().manual_seed(5)
    _build.reset_launch_counts()
    cases = 0
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        big = (1 << 32) + 10 if dt == torch.float32 else 17_179_869_201
        layouts = [(n, 0, n, None) for n in (1, 3, 4097, 4102, 1_000_003)]
        layouts += [(1000, 2000, 4097, None), (40, 2030, 4097, None),
                    (4097, 0, 4097, [(3, 700), (1500, 2999), (4000, 4097)]),
                    (4096, big - 4100, big, None),
                    (4096, big - 4096, big, [(0, 1000), (3000, 4096)])]
        for n, off, total, bands in layouts:
            x = torch.randn(n, generator=g).to(dt).cuda()
            for dist in ("gaussian", "rademacher"):
                for form in ("z", "axpbz", "xpbz", "restore"):
                    kw = dict(a=0.5, b=-0.25, e=0.125, dist=dist,
                              bands=bands, offset=off, total=total,
                              partitionable=False)
                    xin = None if form == "z" else x
                    yk = x1.zo_affine_threefry(xin, (7, 2**31 + 5), form,
                                               out=x.clone(), **kw)
                    yp = x1.zo_affine_threefry_plain(
                        xin, (7, 2**31 + 5), form, out=x.clone(), **kw)
                    if not same_bits(yk, yp):
                        fail(f"X1 original {dt} n={n} offset={off} "
                             f"total={total} {dist} {form}: kernel != plain")
                    cases += 1
    cases += check_x1_original_vector(torch, x1, g)
    routes = {k: v for k, v in _build.route_counts.items()
              if k.startswith("zo_affine_threefry_original")}
    want = {f"zo_affine_threefry_original/{r}"
            for r in ("pairs", "pairs/vector", "pairs/scalar", "bands")}
    if _build.launch_counts["zo_affine_threefry"] or set(routes) != want:
        fail(f"X1 original's checks: launches {dict(_build.launch_counts)}, "
             f"routes {routes}")
    gold = np.load(X1_ORIG_GOLDEN)
    key = fold_in(tuple(int(k) for k in gold["key"]), 0)
    names = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16}
    sizes = sorted({int(k.split("_")[1]) for k in gold.files
                    if k.startswith("x_") and k != "x_bands"})
    held = 0
    for n in sizes:
        for name, dt in names.items():
            x = torch.from_numpy(gold[f"x_{n}"]).to(dt).cuda()
            for dist in ("gaussian", "rademacher"):
                for form, a, b, e in (("z", 0, 0, 0), ("xpbz", 0, 1e-3, 0),
                                      ("axpbz", 1 - np.float32(1e-3), -0.37,
                                       0),
                                      ("restore", 1 - np.float32(1e-4),
                                       -0.0123, 1e-3)):
                    y = x1.zo_affine_threefry(
                        None if form == "z" else x.clone(), key, form,
                        in_dtype(a, dt), in_dtype(b, dt), in_dtype(e, dt),
                        dist=dist, out=torch.empty_like(x),
                        partitionable=False)
                    want = gold[f"{dist}_{name}_{n}_{form}"]
                    if not np.array_equal(y.float().cpu().numpy(), want):
                        fail(f"X1 original {dist} {name} n={n} {form} != the "
                             "JAX fixture")
                    held += 1
    with threefry_partitionable(False):
        for name, dt in names.items():
            ref = StreamRef(tuple(int(k) for k in gold["key"])).with_selection(
                rows(block=2, k=3), 1)
            tree = {"a": torch.from_numpy(gold["x_bands"]).to(dt).cuda()}
            out = XLABackend().apply_rank1(tree, ref, np.float32(0.5),
                                           np.float32(1e-3))
            if not np.array_equal(out["a"].float().cpu().numpy(),
                                  gold[f"bands_{name}"]):
                fail(f"X1 original bands {name} != the JAX fixture")
            held += 1
    for i, (n, bw, lo, hi) in enumerate(((((1 << 32) + 10), 32,
                                          (1 << 32) - 6, (1 << 32) + 10),
                                         (17_179_869_201, 8, 17_179_869_170,
                                          17_179_869_201))):
        bits = torch.from_numpy(gold[f"window{i}_bits"]).cuda()
        dt = torch.float32 if bw == 32 else torch.bfloat16
        for dist in (("gaussian", "rademacher") if bw == 32
                     else ("gaussian",)):
            y = x1.zo_affine_threefry(None, key, "z", dist=dist,
                                      out=torch.empty(hi - lo, dtype=dt,
                                                      device="cuda"),
                                      offset=lo, total=n, partitionable=False)
            k = x1.folded_scalars(dt, dist, 0.0, 0.0, None)[0]
            unit = x1._z_unit(bits, dt, dist)
            want = (unit * k) if dt == torch.float32 else unit
            if not same_bits(y, want.to(dt)):
                fail(f"X1 original z on the window [{lo}, {hi}) of a "
                     f"{n}-element leaf ({dist}) != JAX's bits")
            held += 1
    log(f"X1 original layout: {cases} writes (f32/bf16/f16 × gaussian/"
        "rademacher × z/axpbz/xpbz/restore; whole leaves of odd and even "
        "word counts at every residue of h mod R, windows straddling h, "
        "meeting or not, off the vector grid, x and y misaligned, bands, "
        "windows of virtual leaves past 2^32 − 1 words) bitwise its plain "
        "version, launches by route "
        + ", ".join(f"{k.split('/', 1)[1]} {v}" for k, v in sorted(
            routes.items())) + f"; {held} writes == the JAX fixture "
        "(x1_original_golden.npz: every form, odd and even m, rows bands, "
        "windows past 2^32 − 1 words)")
    return 0.0


def check_x1_original_vector(torch, x1, g) -> int:
    """The ``pairs`` route's vector design against its plain version,
    bitwise, every form, in place: for each dtype × dist (R pairs a
    16-byte vector) whole leaves of odd and even m at every residue of h
    mod R (site 2's shift d = h mod R), the last word whole or partial;
    x (or y) one element off y's (x's) 16-byte grid — the all-scalar
    launches; and windows off the vector grid, inside one half, straddling
    h with their pair ranges meeting, and nearly the whole leaf.  Returns
    the writes held."""
    cases = 0

    def hold(n, off, total, dt, dist, form, xshift=0, yshift=0):
        """y = the write of x; in place where x and y lie alike."""
        nonlocal cases
        x = torch.randn(n + 8, generator=g).to(dt).cuda()[xshift:xshift + n]
        y = (x if xshift == yshift else
             torch.empty(n + 8, dtype=dt, device="cuda")[yshift:yshift + n])
        kw = dict(a=0.5, b=-0.25, e=0.125, dist=dist, offset=off,
                  total=total, partitionable=False)
        yp = x1.zo_affine_threefry_plain(
            None if form == "z" else x.clone(), (7, 2**31 + 5), form,
            out=torch.empty_like(x), **kw)
        yk = x1.zo_affine_threefry(None if form == "z" else x,
                                   (7, 2**31 + 5), form, out=y, **kw)
        if not same_bits(yk, yp):
            fail(f"X1 original (vector design) {dt} {dist} {form} n={n} "
                 f"offset={off} total={total} x+{xshift} y+{yshift}: "
                 "kernel != plain")
        cases += 1

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for dist in ("gaussian", "rademacher"):
            epw = 32 // x1.bit_width(dt, dist)
            R = 16 // (epw * dt.itemsize)
            for res in range(R):
                h = 1500 * R + res          # ≈ 23 chunks of 64 runs
                for m in (2 * h, 2 * h - 1):
                    n = m * epw - (res % 2) * (epw - 1)
                    for form in ("z", "axpbz", "xpbz", "restore"):
                        hold(n, 0, n, dt, dist, form)
            n = 40000 * epw + 3
            H = ((-(-n // epw) + 1) // 2) * epw     # site 2's first element
            for form in ("axpbz", "restore", "z"):
                hold(n, 0, n, dt, dist, form, xshift=1)
                hold(n, 0, n, dt, dist, form, yshift=1)
                for lo, hi in ((3, H // 2), (H + 5, n - 1),
                               (H - 700, H + 900), (H // 3, H + H // 2),
                               (8, n - 8), (4 * epw, n - 4 * epw)):
                    hold(hi - lo, lo, n, dt, dist, form)
    return cases


def x1_original_sass(lib_path, parent: bool = False):
    """SASS per z of X1's original-layout kernel (bf16 gaussian axpbz) in
    its hot loop, by unit; None when the kernel is not that shape.  This
    tree's: the zone's loop over 32 runs — the backward branch's span that
    holds the most 16-byte stores (two an iteration: site 1's vector and
    site 2's), the shortest on a tie — over its 2 × 8 z an iteration;
    every instruction of the span is counted, the not-taken sides of its
    uniform branches (the rotation by d, the shuffles) included.  With
    ``parent``, the route's first design: one hash per pair, 4 elements a
    word written in versioned inner loops — (head + each word's shortest
    copy × 4 / its LDS count) / 8 per z."""
    funcs = sass_of(lib_path)
    names = [n for n in funcs
             if re.search(r"orig_kernelI13__nv_bfloat16Li0ELi1EE", n)]
    if len(names) != 1:
        return None
    instrs = funcs[names[0]]
    spans = []
    for addr, op, rest in instrs:
        m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    if not spans:
        return None
    if parent:
        return _x1_original_sass_pairs(instrs, spans)
    best = None
    for lo, hi in spans:
        body = [(op, rest) for a, op, rest in instrs if lo <= a <= hi]
        vec = sum(1 for op, rest in body
                  if op == "STG" and rest.startswith(".E.128"))
        key = (vec, -len(body))
        if vec and (best is None or key > best[0]):
            best = (key, [op for op, _ in body])
    if best is None:
        return None
    (vec, _), body = best
    nz = vec * 8
    counts = {g: 0.0 for g, _ in SASS_GROUPS}
    counts.update(alu=0.0, uniform=0.0)
    for op in body:
        counts[sass_group(op)] += 1
    out = {g: v / nz for g, v in counts.items()}
    out["total"] = len(body) / nz
    out["rsq_in_loop"] = nz
    return out


def _x1_original_sass_pairs(instrs, spans):
    """The first design's per-z count (its shortest path): a grid-stride
    loop over word pairs around versioned loops over a word's 4 elements."""
    per = 4
    outer = max(spans, key=lambda sp: sp[1] - sp[0])
    inner = sorted(sp for sp in spans if sp != outer and outer[0] <= sp[0]
                   and sp[1] <= outer[1])
    bodies = [[op for a, op, _ in instrs if lo <= a <= hi]
              for lo, hi in inner]
    first_branch = next((a for a, op, _ in instrs
                         if op == "BRA" and a >= outer[0]), None)
    if (len(bodies) % 2 or not bodies or first_branch is None
            or any(b.count("LDS") == 0 or per % b.count("LDS")
                   for b in bodies)):
        return None
    head = [op for a, op, _ in instrs if outer[0] <= a <= first_branch]
    half = len(bodies) // 2
    counts = {g: 0.0 for g, _ in SASS_GROUPS}
    counts.update(alu=0.0, uniform=0.0)
    total = 0.0
    for weight, ops in ([(1, head)] + [
            (per // b.count("LDS"), b)
            for b in (min(w, key=len) for w in (bodies[:half],
                                                bodies[half:]))]):
        for op in ops:
            counts[sass_group(op)] += weight
        total += weight * len(ops)
    out = {g: v / (2 * per) for g, v in counts.items()}
    out["total"] = total / (2 * per)
    out["rsq_in_loop"] = 2 * per
    return out


def _orig_pass_fn(lib_path, leaves, bval: float):
    """One X1 original-layout pass over ``leaves`` (bf16 gaussian axpbz,
    key (12345, i) for leaf i) through the C entry ``zo_threefry_original``
    of the library at ``lib_path`` — whose signature the redesign keeps —
    on the launches ``original_launches`` plans, the host's work done
    once."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.threefry import kernel as x1
    vp, i, f, u32, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint32, ctypes.c_uint64)
    fn = ctypes.CDLL(str(lib_path)).zo_threefry_original
    fn.argtypes = [vp, vp, i, u32, u32, u64, u32, u32, u32, u32, u64, u64,
                   u64, i, i, i, f, f, f, f, i, f, vp]
    fn.restype = i
    calls = []
    for j, q in enumerate(leaves):
        n = q.numel()
        for ln in x1.original_launches(0, n, n, 8):
            calls.append((j, (1, 12345, j, ln.wbase, ln.m, ln.h, ln.p0,
                              ln.np, 0, n, 0, 8, 0, 1, 1.0, bval, 0.0, 1.0,
                              0, 0.0)))

    def run(ys=None):
        stream = _build.stream_of(leaves[0])      # a graph's, when captured
        for j, args in calls:
            at = leaves[j].data_ptr() if ys is None else ys[j]
            if fn(at, at, *args, stream):
                fail(f"X1 original timing launch failed ({lib_path})")
    return run


def _orig_bands_pass_fn(leaves, ranges, bval: float):
    """One pass of X1's original ``bands`` route over ``leaves`` (bf16
    gaussian axpbz) on the band lists ``ranges`` (a leaf's rows plan; None
    for a leaf written whole, which the pass skips) through the C entry
    ``zo_threefry_original_bands``, the band tensors uploaded once.
    Returns (the pass, the elements it writes, its launches)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.threefry import kernel as x1
    lib = x1._lib()
    calls = []
    for j, (q, bands) in enumerate(zip(leaves, ranges)):
        if bands is None:
            continue
        m = x1.draw_words(q.numel(), 8)
        for blk, group in x1._original_bands(bands, 0, 8):
            bl = torch.tensor(group, dtype=torch.int64)
            lens = bl[:, 1] - bl[:, 0]
            cum = torch.cat([torch.zeros(1, dtype=torch.int64),
                             torch.cumsum(lens, 0)])
            mb = x1.block_words(m, blk)
            calls.append((q, bl[:, 0].cuda(), cum.cuda(),
                          (1, 12345, j, blk * x1.BLOCK_WORDS, mb,
                           (mb + 1) // 2, 0, 8, 0, 1, 1.0, bval, 0.0, 1.0,
                           0, 0.0), len(group), int(lens.sum())))

    def run():
        stream = _build.stream_of(leaves[0])      # a graph's, when captured
        for q, starts, cum, args, nb, total in calls:
            err = lib.zo_threefry_original_bands(
                q.data_ptr(), q.data_ptr(), *args, starts.data_ptr(),
                cum.data_ptr(), nb, total, stream)
            if err:
                fail(f"X1 original bands timing launch: CUDA error {err}")
    return run, sum(c[-1] for c in calls), len(calls)


def x1_original_row(torch, np, _build, params0, card, err,
                    parent_lib=None) -> dict:
    """X1's original route over the 15 qwen2-0.5b leaves (bf16 gaussian
    axpbz, the replay / update write): in turns with the partitionable
    route on the same leaves (``run_ms``: CUDA-graph runs of 10 passes,
    the order reversed every round, so P O O P …; and Python-issued runs,
    the wrappers' host work included), and with ``parent_lib`` — the
    parent's ``zo_threefry`` library — in turns with the parent's
    ``orig_kernel`` through the same C entry (P C C P …), one pass of each
    from the same leaves held bitwise equal; its launches by route, its
    plain version's time, its SASS per z and floors, registers and spills;
    the bands route's time under ``rows(block=1,k=4)`` (one
    ``apply_rank1`` of the xla backend, Python-issued); its row of the
    ``kernels`` line (launches filled in from the counted paths)."""
    from repro_torch.kernels.threefry import kernel as x1
    from repro_torch.perturb import XLABackend
    from repro_torch.perturb.stream import StreamRef, threefry_partitionable
    from repro_torch.select import parse_selection
    from repro_torch.tree_utils import is_floating, tree_leaves
    leaves = [q.clone() for q in tree_leaves(params0) if is_floating(q)]
    n_all = sum(q.numel() for q in leaves)
    bval = -0.0001220703125

    def record(part, fn=x1.zo_affine_threefry):
        for i, q in enumerate(leaves):
            fn(q, (12345, i), "axpbz", a=1.0, b=bval, out=q,
               partitionable=part)

    fns = {"partitionable": lambda: record(True),
           "original": lambda: record(False)}
    with ClockSampler() as clock:
        graphed = run_ms(fns, 10, rounds=4)
        eager = run_ms(fns, 10, rounds=2, graph=False)
    ms_o, ms_p = graphed["original"], graphed["partitionable"]
    _build.reset_launch_counts()
    record(False)
    routes = {k.split("/", 1)[1]: v for k, v in _build.route_counts.items()
              if "original" in k}
    plain_ms = host_ms(lambda: record(False, x1.zo_affine_threefry_plain))
    bms, by = costs.bound_ms([costs.zo_affine_threefry(q.numel(),
                                                       q.element_size())
                              for q in leaves])
    log(f"X1 original layout, one pass over the 15 qwen2-0.5b leaves "
        f"({n_all} bf16 elements, gaussian axpbz; launches by route "
        f"{routes}): {ms_o:.4f} ms against the partitionable route's "
        f"{ms_p:.4f} ms on the same leaves in turns (CUDA-graph runs of 10 "
        f"passes, 4 rounds, the order reversed every round); Python-issued "
        f"{eager['original']:.4f} / {eager['partitionable']:.4f} ms (the "
        f"wrappers' host work included); plain version {plain_ms:.1f} ms; "
        f"bound {bms:.4f} ms ({by}), {100 * bms / ms_o:.1f}% of it reached "
        f"— on {card}")
    if parent_lib is not None:
        libs = {"parent": parent_lib,
                "change": _build.lib_path("zo_threefry")}
        runs = {k: _orig_pass_fn(v, leaves, bval) for k, v in libs.items()}
        outs = {}
        for k, run in runs.items():
            outs[k] = [q.clone() for q in leaves]
            run([o.data_ptr() for o in outs[k]])
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(outs["parent"],
                                                   outs["change"])):
            fail("X1 original: this tree's pass != the parent's pass")
        del outs
        turns = run_ms({"parent": runs["parent"], "change": runs["change"]},
                       10, rounds=4)
        for k in ("parent", "change"):
            c = x1_original_sass(libs[k], parent=k == "parent")
            text = ("SASS not counted (an unknown loop shape)" if c is None
                    else floors_text(n_all, c, clock.mhz, turns[k]))
            log(f"X1 original {k}: {turns[k]:.4f} ms per pass (CUDA-graph "
                f"runs of 10 passes through zo_threefry_original, 4 rounds "
                f"P C C P …); {text} — on {card}")
        log(f"X1 original: the parent's pass / this tree's "
            f"{turns['parent'] / turns['change']:.3f}×; one pass of each "
            "from the same leaves bitwise equal")
    c = x1_original_sass(_build.lib_path("zo_threefry"))
    if c is None:
        fail("X1 original SASS: no zone loop with 16-byte stores in "
             "orig_kernel<bf16, gaussian, axpbz>")
    mhz = clock.mhz if clock.mhz == clock.mhz else sm_clocks()[0]
    log(sass_line("X1 zo_affine_threefry_original (bf16 gaussian axpbz; "
                  "the zone's loop, 2 pairs a lane and site)", c))
    log("X1 original layout: " + floors_text(n_all, c, mhz, ms_o)
        + f" at {mhz:.0f} MHz; the bytes bound {bms:.4f} ms is "
        f"{100 * bms / ms_o:.1f}% of its time — on {card}")
    log("X1 original registers / shared memory / spills (gaussian axpbz): "
        + "; ".join(f"{k}: {v}" for k, v in sorted(ptxas_facts(
            _build, "zo_threefry").items())
            if k.startswith("orig_kernel") and k.endswith(", 0, 1>")))
    # the bands route (not redesigned) under rows(block=1,k=4)
    tree = {f"l{i:02d}": q for i, q in enumerate(leaves)}
    sel = parse_selection(ROWS)
    ref = StreamRef((12345, 0)).with_selection(sel, 1)
    blocks = ref.selection_blocks(tree)
    ranges = [None if rb is None or rb.all_selected else rb.ranges()
              for rb in blocks]
    run_b, picked, nlaunch = _orig_bands_pass_fn(leaves, ranges, bval)
    ms_b = run_ms({"bands": run_b}, 10, rounds=2)["bands"]
    backend = XLABackend()
    with threefry_partitionable(False):
        _build.reset_launch_counts()
        backend.apply_rank1(tree, ref, np.float32(bval), np.float32(0.0))
        bands = dict(_build.route_counts)
        ms_py = cuda_ms(lambda: backend.apply_rank1(
            tree, ref, np.float32(bval), np.float32(0.0)), 3)
    bms_b = costs.bound_ms(costs.zo_affine_threefry(picked, 2))[0]
    log(f"X1 original bands route (not redesigned) under {ROWS}: one pass "
        f"over the 15 leaves' selected rows ({picked} of {n_all} elements; "
        f"{nlaunch} launches through zo_threefry_original_bands, the band "
        f"tensors uploaded once): {ms_b:.4f} ms (CUDA-graph runs of 10 "
        f"passes), bound {bms_b:.4f} ms by bytes ({100 * bms_b / ms_b:.1f}% "
        f"of it reached); one apply_rank1 of the xla backend (launches "
        f"{bands}), Python-issued, the band lists built and uploaded each "
        f"call: {ms_py:.2f} ms — on {card}")
    del leaves, tree
    return {"name": "zo_affine_threefry_original", "route": "cuda",
            "source": "src/repro_torch/kernels/threefry/csrc/zo_threefry.cu",
            "replaces": "src/repro/perturb/xla.py:38", "launches": 0,
            "max_abs_err": err, "ms": ms_o, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


# --------------------------------------------------------------------------- #
# The moe family: (s) granite-moe-3b-a800m, (t) mixtral-8x7b
# --------------------------------------------------------------------------- #
def granite_paths(torch, np, _build, counts, step_ms, card) -> None:
    """granite-moe-3b-a800m at full width and depth (32 layers, d 1536, 24
    × 64 heads, GQA 8, 40 experts top-8, d_ff 512, bf16, ``pallas_flash``)
    with its experts in GRANITE_GROUPS leaf groups: (s) mezo spsa on
    ``xla`` under ``moe_experts(G)`` on 16 × 256 lm batches — one step's
    peak against one forward's (the 1.10 gate), its busy share and top
    kernels, the router and the inactive groups at θ₀'s bits after it; 5
    steps through the training loop; two replays from θ₀ bitwise equal,
    θ₀ regenerated from the seed bitwise θ₀; the fine-tune served through
    the paged engine (K2 hd 64, K12); then one step with the threefry
    layout switched off (X1's original route), its replay ≡ the plain
    replay under the same layout bitwise, within the ulp bound of the
    trained θ, and unlike the replay under the partitionable layout."""
    from repro_torch import zo
    from repro_torch.core import replay
    from repro_torch.models import bundle
    from repro_torch.perturb.stream import threefry_partitionable
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import tree_leaves
    cfg, params0 = init_logged(torch, "granite-moe-3b-a800m",
                               expert_groups=GRANITE_GROUPS)
    b = bundle(cfg)
    sel = b.default_selection()
    if sel != f"moe_experts({GRANITE_GROUPS})":
        fail(f"granite's default selection is {sel!r}")
    sums0 = checksums(torch, params0)

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="xla", selection=sel)

    memory_and_busy(torch, cfg, params0, selection=sel, backend="xla")
    name = "s_granite_spsa"
    p, led, _, ms = train_phase(torch, cfg, params0, name, make_opt, None,
                                _build, counts)
    step_ms[name] = ms
    if led.selection != sel or led.to_bytes()[:5] != b"MZOL5":
        fail(f"{name}: the ledger records {led.selection!r}, not {sel!r}")
    r1 = check_replays(torch, name, params0, p, led, make_opt)
    del p
    again = b.init(0, device="cuda")
    if checksums(torch, again) != sums0:
        fail("granite: θ₀ regenerated from the seed differs from θ₀")
    _build.reset_launch_counts()
    replay(again, led, composition_for_ledger(led))
    prompts = workload(np, cfg.vocab_size)
    eng, reqs, wall = serve(cfg, again, prompts, True)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention",
                                "paged_gather"),
               "serve the granite fine-tune")
    hit = eng.prefix_stats()["prefix_hit_rate"]
    del eng
    for x, y in zip(tree_leaves(again), tree_leaves(r1)):
        if not same_bits(x, y):
            fail("granite: the served fine-tune (θ₀ regenerated, replayed "
                 "through composition_for_ledger) != the replay from θ₀")
    if any(len(r.out_ids) != NEW_TOKENS for r in reqs):
        fail("a granite request did not produce its tokens")
    tokens = tokens_of([r.out_ids for r in reqs])
    log(f"granite: θ₀ regenerated from the seed ≡ θ₀ (per-leaf checksums); "
        f"its {len(led)} MZOL5 records ({sel}) replayed through "
        f"composition_for_ledger ≡ the replay; served {len(reqs)} requests "
        f"/ {tokens} tokens in {wall:.3f} s through the paged engine "
        f"({tokens / wall:.1f} tok/s, prefix hit rate {hit:.2f}) — on {card}")
    del again, r1
    # one step with the threefry layout off: X1's original route
    name = "s_granite_orig"
    with threefry_partitionable(False):
        p, led_o, _, ms = train_phase(torch, cfg, params0, name, make_opt,
                                      None, _build, counts)
        step_ms[name] = ms
        ro = replay(_clone_tree(params0), led_o, make_opt())
        plain = _clone_tree(params0)
        plain_replay_xla(plain, led_o, np, selection=make_opt().selection,
                         partitionable=False)
        torch.cuda.synchronize()
    for x, y in zip(tree_leaves(ro), tree_leaves(plain)):
        if not same_bits(x, y):
            fail(f"{name}: the X1 original replay != the plain replay")
    text = hold_ulps(torch, name, zip(tree_leaves(ro), tree_leaves(p)))
    other = replay(_clone_tree(params0), led_o, make_opt())
    moved = sum(not same_bits(x, y) for x, y in zip(tree_leaves(other),
                                                     tree_leaves(ro)))
    if moved == 0:
        fail(f"{name}: the replay under the partitionable layout equals the "
             "original layout's")
    log(f"{name}: one spsa step under the original threefry layout; its "
        f"replay through X1's original route ≡ the plain replay under that "
        f"layout, bitwise; vs the trained θ: {text}; the same ledger under "
        f"the partitionable layout moves {moved} leaves otherwise")
    del p, ro, plain, other, params0


def serve_slab(cfg, params, prompts, slots: int, max_len: int,
               new_tokens: int):
    """Serve ``prompts`` through the engine's dense slab (``paged=False``):
    (engine, requests, wall seconds)."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=slots, max_len=max_len,
                      paged=False, device="cuda")
    reqs = [Request(i, q, max_new_tokens=new_tokens)
            for i, q in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs, time.perf_counter() - t0


def ttft_p50(reqs) -> float:
    """Median ms from a request's submission to its first token (its
    admission: the prefill samples the first token)."""
    import statistics
    return 1e3 * statistics.median(r.times["prefill"] - r.times["queued"]
                                   for r in reqs)


def mixtral_paths(torch, np, _build, counts, step_ms, card) -> None:
    """mixtral-8x7b at full width (d 4096, 32 × 128 heads, GQA 8, sliding
    window 4096, 8 experts top-2, d_ff 14336, bf16, ``pallas_flash``), its
    depth cut to MIXTRAL_LAYERS of 32 (the cut printed): (t) 3 mezo spsa
    steps on ``xla`` in place under its default selection, their peak
    against one forward's and the card's memory; one replay from θ₀
    regenerated from the seed (checksums ≡ θ₀), held on sampled slices
    within the ulp bound of the trained θ; the fine-tune served through the
    engine's dense slab (per-slot ring caches of the window; K2 at hd 128
    with the window in the bucketed prefills)."""
    from repro_torch import zo
    from repro_torch.core import replay
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import all_archs, bundle
    from repro_torch.serve.engine import ServeEngine
    full = all_archs()["mixtral-8x7b"].cfg
    _, total = torch.cuda.mem_get_info()
    log(f"mixtral-8x7b: {full.n_params()} params by JAX's n_params "
        f"({full.n_active_params()} active), {2 * full.n_params() / 2**30:.2f}"
        f" GiB of bf16 against the card's {total / 2**30:.2f} GiB: its depth "
        f"is cut to {MIXTRAL_LAYERS} of {full.n_layers} layers, full width")
    for layers in (MIXTRAL_LAYERS, MIXTRAL_FALLBACK_LAYERS):
        cfg, params = init_logged(torch, "mixtral-8x7b", n_layers=layers)
        b = bundle(cfg)
        loss_fn = b.loss_fn()
        batch = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                  vocab=cfg.vocab_size, seed=SEED),
                         device="cuda").batch(0)
        with torch.no_grad():
            loss_fn(params, batch).item()                # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            loss_fn(params, batch).item()
        torch.cuda.synchronize()
        fwd = torch.cuda.max_memory_allocated() - base
        room = total - base - MEM_SLACK * fwd
        del batch
        if room >= MIXTRAL_MIN_FREE or layers == MIXTRAL_FALLBACK_LAYERS:
            break
        log(f"mixtral-8x7b at {layers} layers: a step at {MEM_SLACK} × one "
            f"forward's peak would leave {room / 2**30:.2f} GiB free (under "
            f"{MIXTRAL_MIN_FREE / 2**30:.0f} GiB): cut to "
            f"{MIXTRAL_FALLBACK_LAYERS} layers")
        del params, loss_fn
        free_card(torch, f"mixtral-8x7b at {layers} layers")
    log(f"mixtral-8x7b cut to {cfg.n_layers} of {full.n_layers} layers "
        "(full width): the whole model does not fit one card")
    try:
        ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN, paged=True,
                    device="cuda")
    except ValueError as e:
        log(f"mixtral-8x7b: the paged engine refuses its window, as JAX's "
            f"does: {e}")
    else:
        fail("the paged engine took mixtral-8x7b's sliding window")
    sums0 = checksums(torch, params)
    sel = b.default_selection()
    name = "t_mixtral_spsa"

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="xla", selection=sel)

    torch.cuda.reset_peak_memory_stats()
    trained, led, _, ms = train_phase(torch, cfg, params, name, make_opt,
                                      None, _build, counts, in_place=True,
                                      with_ckpt=False)
    step_ms[name] = ms
    peak_abs = torch.cuda.max_memory_allocated()
    stp = peak_abs - base
    if stp > MEM_SLACK * fwd:
        fail(f"{name}: the steps peak {stp / 2**30:.3f} GiB over θ > "
             f"{MEM_SLACK} × one forward's {fwd / 2**30:.3f} GiB")
    log(f"memory (mixtral-8x7b, {cfg.n_layers} layers, {sel}): "
        f"{ALL_STEPS[name]} spsa steps peak at {stp / 2**30:.3f} GiB over θ, "
        f"one forward (no_grad) at {fwd / 2**30:.3f} GiB — ratio "
        f"{stp / fwd:.4f}; the whole peak {peak_abs / 2**30:.2f} GiB of the "
        f"card's {total / 2**30:.2f} GiB ({100 * peak_abs / total:.1f}%) — "
        f"on {card}")
    samples = {k: v.cpu() for k, v in sample_slices(trained).items()}
    del trained, params
    free_card(torch, "mixtral-8x7b's trained θ")
    p = b.init(0, device="cuda")
    if checksums(torch, p) != sums0:
        fail("mixtral: θ₀ regenerated from the seed differs from θ₀")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    replay(p, led, make_opt())
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry",),
               "replay the mixtral fine-tune")
    log(f"{name}: in-place replay of {len(led)} records in "
        f"{time.perf_counter() - t0:.3f} s")
    samples_vs(torch, name, p, samples)
    del samples
    # the fine-tune through the engine's dense slab
    prompts = workload(np, cfg.vocab_size)[:MIXTRAL_REQUESTS]
    _build.reset_launch_counts()
    eng, reqs, wall = serve_slab(cfg, p, prompts, MIXTRAL_REQUESTS,
                                 MIXTRAL_MAX_LEN, MIXTRAL_NEW)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("flash_attention",),
               "serve the mixtral fine-tune (dense slab)")
    if eng.paged or eng.cache["k"].shape[2] != min(MIXTRAL_MAX_LEN,
                                                   cfg.sliding_window):
        fail("mixtral was not served through the dense slab's ring caches")
    if any(len(r.out_ids) != MIXTRAL_NEW for r in reqs):
        fail("a mixtral request did not produce its tokens")
    tokens = tokens_of([r.out_ids for r in reqs])
    log(f"mixtral-8x7b ({cfg.n_layers} layers): served {len(reqs)} requests "
        f"(prompts {[len(q) for q in prompts]}) / {tokens} tokens in "
        f"{wall:.3f} s through the dense slab ({eng.slots} slots × "
        f"{eng.cache['k'].shape[2]} KV rows; {tokens / wall:.1f} tok/s, "
        f"TTFT p50 {ttft_p50(reqs):.1f} ms) — on {card}")
    del eng, p


# --------------------------------------------------------------------------- #
# The hybrid and encdec families: (u) hymba-1.5b, (w) whisper-large-v3
# --------------------------------------------------------------------------- #
def hymba_ring_check(torch, card) -> None:
    """The SWA ring in f32 at hymba's full width, RING_LAYERS layers: a
    prefill of RING_PREFILL tokens, then one-token decodes through position
    RING_END (the 2048-row ring wraps past 2048), the last logits held to
    one full forward of the whole sequence (``xla`` attention: the window's
    mask in place of the ring).  Outside the counts."""
    from repro_torch.models import all_archs, bundle, transformer
    cfg = all_archs()["hymba-1.5b"].cfg.replace(
        n_layers=RING_LAYERS, dtype="float32", attention_impl="xla")
    b = bundle(cfg)
    params = b.init(0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (1, RING_END + 1), generator=g,
                         device="cuda")
    dec = b.decode_fn()
    with torch.no_grad():
        full = transformer.forward(cfg, params, tokens=toks).logits[
            0, RING_END, :cfg.vocab_size]
        _, (cache, state) = b.prefill_fn()(params,
                                           {"tokens": toks[:, :RING_PREFILL]})
        cap = cache["k"].shape[2]
        for t in range(RING_PREFILL, RING_END + 1):
            lg, (cache, state) = dec(params, {
                "token": toks[:, t:t + 1], "cache_pos": t, "cache": cache,
                "state": state})
    last = lg[0, 0, :cfg.vocab_size]
    err = (last - full).abs().max().item()
    top = full.abs().max().item()
    if not bool(torch.isfinite(last).all()) or err > RING_REL * top:
        fail(f"hymba ring wrap: max |Δ| {err:.3e} > {RING_REL} × max |logits| "
             f"{top:.3e}")
    log(f"hymba ring wrap (f32, full width, {RING_LAYERS} of 32 layers, "
        f"cut for the f32 check; ring of {cap} rows): prefill "
        f"{RING_PREFILL} tokens, decode through position {RING_END}; last "
        f"logits vs one full forward: max |Δ| {err:.3e}, {err / top:.2e} of "
        f"max |logits| {top:.3f} (bound {RING_REL}); argmax "
        f"{int(last.argmax())} vs {int(full.argmax())} — on {card}")
    del params, cache, state


def hymba_ssd_check(torch, card) -> None:
    """The SSD chunk form against the per-token recurrence on one
    full-width hymba SSM layer in f32 (y and the final state), within
    JAX's SCAN_PARITY_ATOL."""
    from repro_torch.models import all_archs
    from repro_torch.models import ssm
    cfg = all_archs()["hymba-1.5b"].cfg.replace(dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(9)
    p = {k: v[0] for k, v in ssm.ssm_params(cfg, g, torch.float32,
                                             1).items()}
    u = torch.randn(2, SSD_SEQ + 7, cfg.d_model, generator=g, device="cuda")
    with torch.no_grad():
        yc, hc = ssm.ssm_scan(cfg, p, u, None, mode="chunk")
        yr, hr = ssm.ssm_scan(cfg, p, u, None, mode="fused_recurrent")
    worst = 0.0
    for a, b, what in ((yc, yr, "y"), (hc, hr, "state")):
        err = (a - b).abs()
        if bool((err > SSD_ATOL + SSD_RTOL * b.abs()).any()):
            fail(f"hymba SSD chunk vs fused_recurrent ({what}): max |Δ| "
                 f"{err.max().item():.3e} beyond {SSD_ATOL} + {SSD_RTOL}·|x|")
        worst = max(worst, err.max().item())
    log(f"hymba SSD chunk vs fused_recurrent, one full-width layer in f32 "
        f"(2 × {SSD_SEQ + 7} tokens, {SSD_SEQ // cfg.scan_chunk + 1} chunks "
        f"of {cfg.scan_chunk}, the last padded): max |Δ| {worst:.3e} over y "
        f"and the final state (bound {SSD_ATOL} + {SSD_RTOL}·|x|) — on "
        f"{card}")


def hymba_paths(torch, np, kf, _build, counts, step_ms, card) -> None:
    """hymba-1.5b at full width, HYMBA_LAYERS of its 32 layers (d 1600,
    25 × 64 heads over 5 KV heads, SWA 2048, 25 SSM heads of state 16, d_ff 5504,
    bf16, ``pallas_flash``): (u) mezo spsa on ``xla`` — one step's peak
    against one forward's (the 1.10 gate), its busy share and top kernels;
    10 steps through the training loop; two replays bitwise equal, within
    the ulp bound of the trained θ; one ``pallas+z2`` step, its replay
    through K1 ≡ the plain replay; K2 at HYMBA_K2_SHAPE with the window;
    the ring wrap and the SSD modes in f32; θ₀ regenerated ≡ θ₀ and the
    ledger replayed onto it through ``composition_for_ledger`` ≡ the
    replay, then served through the dense slab (every ring wraps)."""
    from repro_torch import zo
    from repro_torch.core import replay
    from repro_torch.models import bundle
    from repro_torch.serve.tenants import composition_for_ledger
    from repro_torch.tree_utils import tree_leaves
    cfg, params0 = init_logged(torch, "hymba-1.5b", n_layers=HYMBA_LAYERS)
    b = bundle(cfg)
    if b.default_selection() != "full":
        fail(f"hymba's default selection is {b.default_selection()!r}")
    sums0 = checksums(torch, params0)

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="xla")

    def make_pallas():
        return zo.mezo(lr=LR, eps=EPS, backend="pallas")

    memory_and_busy(torch, cfg, params0, backend="xla")
    name = "u_hymba_spsa"
    p, led, _, ms = train_phase(torch, cfg, params0, name, make_opt, None,
                                _build, counts)
    step_ms[name] = ms
    r1 = check_replays(torch, name, params0, p, led, make_opt)
    del p
    # one step on the counter stream, replayed through K1
    name_k1 = "u_hymba_pallas"
    p, led_k1, _, ms = train_phase(torch, cfg, params0, name_k1, make_pallas,
                                   None, _build, counts, with_ckpt=False)
    step_ms[name_k1] = ms
    rk = check_replays(torch, name_k1, params0, p, led_k1, make_pallas)
    plain = _clone_tree(params0)
    plain_replay(plain, led_k1, np)
    torch.cuda.synchronize()
    for x, y in zip(tree_leaves(rk), tree_leaves(plain)):
        if not same_bits(x, y):
            fail(f"{name_k1}: the replay through K1 != K1's plain replay")
    log(f"{name_k1}: its {led_k1.backend} record replayed through K1 ≡ K1's "
        "plain replay, bitwise")
    del p, rk, plain
    # K2 at hymba's heads over a sequence the window binds
    B_, S_, H_, hd_ = HYMBA_K2_SHAPE
    gk = torch.Generator(device="cuda").manual_seed(25)
    q = torch.randn(B_, S_, H_, hd_, generator=gk, device="cuda").bfloat16()
    k, v = (torch.randn(B_, S_, cfg.kv_heads, hd_, generator=gk,
                        device="cuda").bfloat16() for _ in range(2))
    err = _hold_k2(torch, kf, q, k, v, cfg.sliding_window,
                   f"at {HYMBA_K2_SHAPE} KV {cfg.kv_heads} window "
                   f"{cfg.sliding_window}")
    ms_k2 = cuda_ms(lambda: kf.flash_attention(q, k, v,
                                               window=cfg.sliding_window), 20)
    # beside one SDPA call on the same inputs: the window as a boolean mask
    # (built once), the KV heads repeated to the query heads (once)
    W = cfg.sliding_window
    i = torch.arange(S_, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(H_ // cfg.kv_heads, dim=1)
              for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    run = run_ms({"kernel": lambda: kf.flash_attention(q, k, v, window=W),
                  "library": lambda: sdpa(qt, kt, vt, attn_mask=band)},
                 RUN_N)
    work = costs.flash_attention(B_, S_, H_, cfg.kv_heads, hd_,
                                 q.element_size(), window=W)
    bms, by = costs.bound_ms(work)
    log(f"K2 at {HYMBA_K2_SHAPE} over {cfg.kv_heads} KV heads (group "
        f"{H_ // cfg.kv_heads}), window {W}, bf16: held to its plain "
        f"version, max abs err {err:.2e}; {ms_k2:.4f} ms (median of 20 "
        f"CUDA-event pairs); in turns with one SDPA call (the window as a "
        f"boolean mask, KV heads repeated, both outside the call), "
        f"{RUN_N} launches per CUDA graph: K2 {run['kernel']:.4f} ms, SDPA "
        f"{run['library']:.4f} ms; bound {bms:.4f} ms ({by}: {work.bytes} "
        f"bytes, {work.ops:.4e} operations) — on {card}")
    del q, k, v, qt, kt, vt, band
    hymba_ring_check(torch, card)
    hymba_ssd_check(torch, card)
    # θ₀ regenerated, the ledger replayed onto it, served through the slab
    again = b.init(0, device="cuda")
    if checksums(torch, again) != sums0:
        fail("hymba: θ₀ regenerated from the seed differs from θ₀")
    _build.reset_launch_counts()
    replay(again, led, composition_for_ledger(led))
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry",),
               "replay the hymba fine-tune")
    for x, y in zip(tree_leaves(again), tree_leaves(r1)):
        if not same_bits(x, y):
            fail("hymba: the replay onto the regenerated θ₀ (through "
                 "composition_for_ledger) != the replay from θ₀")
    del r1
    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size - 1,
                                             HYMBA_PROMPT + 3 * i)]
               for i in range(HYMBA_SLOTS)]
    _build.reset_launch_counts()
    eng, reqs, wall = serve_slab(cfg, again, prompts, HYMBA_SLOTS,
                                 HYMBA_MAX_LEN, HYMBA_NEW)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("flash_attention",),
               "serve the hymba fine-tune (dense slab)")
    cap = eng.cache["k"].shape[2]
    if eng.paged or cap != cfg.sliding_window:
        fail(f"hymba was not served through the dense slab's {cfg.sliding_window}"
             f"-row rings (cap {cap})")
    if any(len(r.out_ids) != HYMBA_NEW for r in reqs):
        fail("a hymba request did not produce its tokens")
    wrapped = sum(len(r.prompt_ids) + len(r.out_ids) - 1 > cap for r in reqs)
    if wrapped != len(reqs):
        fail(f"only {wrapped} of {len(reqs)} hymba requests wrapped the ring")
    tokens = tokens_of([r.out_ids for r in reqs])
    slab = sum(t.numel() * t.element_size() for t in eng.cache.values())
    log(f"hymba: θ₀ regenerated ≡ θ₀; its {len(led)} records replayed "
        f"through composition_for_ledger ≡ the replay; served "
        f"{len(reqs)} requests (prompts {len(prompts[0])}–"
        f"{len(prompts[-1])} tokens, {HYMBA_NEW} new each: every ring of "
        f"{cap} rows wraps) / {tokens} tokens in {wall:.3f} s through the "
        f"dense slab ({tokens / wall:.1f} tok/s, TTFT p50 "
        f"{ttft_p50(reqs):.1f} ms; slab caches {slab / 2**30:.3f} GiB, SSM "
        f"state {eng.state.numel() * 4 / 2**20:.1f} MiB) — on {card}")
    del eng, again, params0


def whisper_paths(torch, np, _build, counts, step_ms, card) -> None:
    """whisper-large-v3 at full width and depth (32 encoder + 32 decoder
    layers, d 1280, 20 × 64 heads, MHA, layernorm, GELU, bf16,
    ``pallas_flash``): (w) ``make_batch`` 16 × 256 batches (frames by the
    stub normal), mezo spsa on ``xla`` — one step's peak against one
    forward's and its busy share; 5 steps through the training loop; two
    replays bitwise equal, within the ulp bound; greedy decode of
    WHISPER_NEW tokens for WHISPER_ROWS rows through ``prefill_fn`` /
    ``decode_fn``; the f32 prefill + decode vs teacher-forcing check."""
    from repro_torch import zo
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import all_archs, bundle, encdec
    from repro_torch.perturb.stream import fold_in, prng_key
    cfg, params0 = init_logged(torch, "whisper-large-v3")
    b = bundle(cfg)
    key = prng_key(SEED)
    batches = {t: b.make_batch(fold_in(key, t), TRAIN_BATCH, TRAIN_SEQ,
                               device="cuda")
               for t in range(FAMILY_STEPS["w_whisper_spsa"])}
    f = batches[0]["frames"]
    if f.shape != (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model) or \
            f.dtype != torch.bfloat16 or not bool(torch.isfinite(f.float())
                                                  .all()):
        fail(f"whisper make_batch frames {tuple(f.shape)} {f.dtype}")
    pipe = FixedBatches(Pipeline(DataSpec("lm", batch=TRAIN_BATCH,
                                          seq=TRAIN_SEQ,
                                          vocab=cfg.vocab_size, seed=SEED)),
                        batches)
    loss_fn = b.loss_fn()
    memory_and_busy(torch, cfg, params0, backend="xla", loss_fn=loss_fn,
                    batch=batches[0])

    def make_opt():
        return zo.mezo(lr=LR, eps=EPS, backend="xla")

    name = "w_whisper_spsa"
    k2_before = counts.get("flash_attention", 0)
    p, led, _, ms = train_phase(torch, cfg, params0, name, make_opt, None,
                                _build, counts, loss_fn=loss_fn, pipe=pipe)
    step_ms[name] = ms
    k2 = counts.get("flash_attention", 0) - k2_before
    want = 2 * cfg.n_layers * FAMILY_STEPS[name]
    if k2 != want:
        fail(f"{name}: K2 launched {k2} times, not once per decoder layer "
             f"of each forward ({want}): the encoder and the cross-attention "
             "are non-causal and never reach it")
    log(f"{name}: K2 launched {k2} times = 2 forwards × {cfg.n_layers} "
        f"decoder layers × {FAMILY_STEPS[name]} steps (the "
        f"{cfg.encoder_layers} encoder layers and the cross-attention take "
        "the chunked path)")
    r1 = check_replays(torch, name, params0, p, led, make_opt)
    del p, batches, pipe
    # greedy decode through the registry
    rows = WHISPER_ROWS
    db = b.make_batch(fold_in(key, 99), rows, WHISPER_FRAMES, device="cuda")
    cache_bytes = (2 * cfg.n_layers * cfg.max_seq * cfg.kv_heads * cfg.hd
                   * 2)
    log(f"whisper decode cache, reckoned: 2 (K, V) × {cfg.n_layers} layers × "
        f"{cfg.max_seq} rows × {cfg.kv_heads} × {cfg.hd} bf16 = "
        f"{cache_bytes / 2**30:.2f} GiB per row, {rows} rows "
        f"{rows * cache_bytes / 2**30:.2f} GiB (JAX's prefill_fn allocates "
        f"cfg.max_seq rows)")
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, (cache, cross) = b.prefill_fn()(r1, {
            "frames": db["frames"], "tokens": db["tokens"][:, :1]})
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        ids = [lg[:, -1, :cfg.vocab_size].argmax(-1)]
        dec = b.decode_fn()
        for t in range(1, WHISPER_NEW):
            lg, cache = dec(r1, {"token": ids[-1][:, None],
                                 "cache_pos": t, "cache": cache,
                                 "cross_kv": cross})
            if not bool(torch.isfinite(lg).all()):
                fail(f"whisper decode step {t}: logits not finite")
            ids.append(lg[:, 0, :cfg.vocab_size].argmax(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    add_counts(counts, _build, (), "whisper prefill + greedy decode")
    got = torch.stack(ids, 1)
    if got.shape != (rows, WHISPER_NEW) or cache["k"].shape[2] != cfg.max_seq:
        fail(f"whisper decode: ids {tuple(got.shape)}, cache rows "
             f"{cache['k'].shape[2]}")
    log(f"whisper greedy decode: {rows} rows × {WHISPER_NEW} tokens against "
        f"{WHISPER_FRAMES} frames in {wall:.3f} s (prefill incl. the encoder "
        f"{1e3 * ttft:.1f} ms, then {1e3 * (wall - ttft) / (WHISPER_NEW - 1):.1f}"
        f" ms per token; allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB peak); ids {got[0].tolist()} — on {card}")
    del cache, cross, lg, r1, db, params0
    free_card(torch, "whisper's trees")
    # f32 at full width, WHISPER_CHECK_LAYERS layers: prefill + incremental
    # decode against teacher forcing of the same tokens
    c32 = all_archs()["whisper-large-v3"].cfg.replace(
        n_layers=WHISPER_CHECK_LAYERS, encoder_layers=WHISPER_CHECK_LAYERS,
        dtype="float32", attention_impl="xla", max_seq=64)
    b32 = bundle(c32)
    w32 = b32.init(0, device="cuda")
    fb = b32.make_batch(fold_in(key, 7), 2, 64, device="cuda")
    toks = fb["tokens"][:, :WHISPER_NEW + 1]
    with torch.no_grad():
        full = encdec.forward_train(c32, w32, fb["frames"], toks)
        _, (cache, cross) = b32.prefill_fn()(
            w32, {"frames": fb["frames"], "tokens": toks[:, :1]})
        for t in range(1, WHISPER_NEW + 1):
            lg, cache = b32.decode_fn()(w32, {
                "token": toks[:, t:t + 1], "cache_pos": t, "cache": cache,
                "cross_kv": cross})
    a = full[:, WHISPER_NEW, :c32.vocab_size]
    c = lg[:, 0, :c32.vocab_size]
    err, top = (a - c).abs().max().item(), a.abs().max().item()
    if err > WHISPER_REL * top:
        fail(f"whisper f32 decode vs teacher forcing: max |Δ| {err:.3e} > "
             f"{WHISPER_REL} × {top:.3e}")
    log(f"whisper f32 check (full width, {WHISPER_CHECK_LAYERS} + "
        f"{WHISPER_CHECK_LAYERS} layers, cut for f32): prefill + "
        f"{WHISPER_NEW} incremental decodes vs teacher forcing at position "
        f"{WHISPER_NEW}: max |Δ| {err:.3e}, {err / top:.2e} of max |logits| "
        f"(bound {WHISPER_REL}) — on {card}")
    del w32, cache, cross


# --------------------------------------------------------------------------- #
# (x) multi-tenant LoRA serving on qwen2-0.5b at full width, X_LAYERS layers
# --------------------------------------------------------------------------- #
def _bf16_ulp(torch, x):
    """One bf16 ulp at each |x| (0 where x is 0), in f32."""
    m, e = torch.frexp(x.float().abs())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


def _same_delta(a, b) -> bool:
    return a.indices == b.indices and all(
        same_bits(x, y) for x, y in zip(a.values, b.values))


def _decode_step_ms(torch, eng, reqs) -> tuple:
    """(median host ms of one decode step, steps timed) for ``reqs`` in
    ``eng``: the first step admits them all (prefills, timed out), every
    later step is a lockstep decode with no admission."""
    import statistics
    for r in reqs:
        eng.submit(r)
    eng.step()
    times = []
    while eng.queue or any(r is not None for r in eng.active):
        times.append(host_ms(eng.step))
    return statistics.median(times), len(times)


def _single_slot_ids(cfg, params, deltas, tagged, new: int, max_len: int):
    """One single-slot engine per request: the reference ids."""
    from repro_torch.serve.engine import Request, ServeEngine
    out = []
    for tenant, req in tagged:
        e1 = ServeEngine(cfg, params, slots=1, max_len=max_len,
                         device="cuda")
        if tenant is not None:
            e1.register_adapter(tenant, deltas[tenant])
        r1 = Request(req.rid, list(req.prompt_ids), max_new_tokens=new,
                     adapter=tenant)
        e1.submit(r1)
        e1.run()
        out.append(r1.out_ids)
    return out


def _stacked_vs_grouped(torch, eng, deltas, tagged) -> tuple:
    """Admit ``tagged`` (one request a slot) into ``eng`` and decode its
    first step twice from the same assembled cache: the stacked call, and
    the grouped calls (one per adapter: the per-adapter reference).
    Returns (max |Δlogits| / max |logits| over the live slots, argmax
    agreement, slots); the engine then runs on from the admitted state."""
    import numpy as np
    for tenant, req in tagged:
        if tenant is not None:
            eng.register_adapter(tenant, deltas[tenant])
            req.adapter = tenant
        eng.submit(req)
    eng._admit()
    live = [s for s, r in enumerate(eng.active) if r is not None]
    toks = np.zeros((eng.slots, 1), np.int64)
    for s in live:
        toks[s, 0] = eng.active[s].out_ids[-1]
    token = torch.as_tensor(toks).cuda()
    pos = torch.as_tensor(eng.pos.astype(np.int64)).cuda()
    eng._ensure_decode_blocks(live)
    cache = eng._assemble_decode_cache()
    eng.cache = {k: v.clone() for k, v in cache.items()}
    stacked = eng._stacked_decode(token, pos)[live].float()
    eng.cache = {k: v.clone() for k, v in cache.items()}
    grouped = eng._grouped_decode(token, pos, live)[live].float()
    eng.cache = None
    V = eng.cfg.vocab_size
    gap = float((stacked - grouped).abs().max() / grouped.abs().max())
    agree = int((stacked[..., :V].argmax(-1)
                 == grouped[..., :V].argmax(-1)).sum())
    return gap, agree, len(live)


def tenants_paths(torch, np, _build, counts, step_ms, card) -> None:
    """(x) Multi-tenant LoRA serving (``repro_torch.serve.tenants``) at
    qwen2-0.5b's full width, ``X_LAYERS`` of its 24 layers (bf16,
    ``pallas_flash``):
    X_TENANTS LoRA tenants trained on ``xla`` (X1) and one on ``pallas``
    (K1); cached ≡ compacted ≡ fresh deltas bitwise for one tenant of each
    stream, the card's replayed LoRA tree ≡ the CPU's plain replay bitwise,
    the merged serving leaves within their bound of the CPU's, a cache hit
    replays nothing; then the serving load through one paged engine (K2 on
    cold prefills, K12 on prefix hits and decode; the stacked decode), a
    byte-budgeted cache that must evict; decode steps timed on each path;
    in f32 the stacked decode's logits held to the grouped (per-adapter)
    decode's and its ids to single-slot engines, a full-tree delta on the
    grouped path likewise; in bf16 the same gap and agreement reported."""
    import statistics

    from repro_torch.core import replay
    from repro_torch.models import all_archs, bundle
    from repro_torch.models.peft import merge_lora
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.tenants import (AdapterDelta, compact,
                                           composition_for_ledger,
                                           lora_runtime, make_lora_tenants,
                                           materialize, serve_load,
                                           synthetic_requests,
                                           template_requests, tenant_name)
    from repro_torch.serve.tenants.compact import replay_copy
    from repro_torch.serve.tenants import synth
    from repro_torch.serve.tenants.synth import lora_params0
    from repro_torch.tree_utils import tree_leaves, tree_map
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(attention_impl="pallas_flash",
                                                n_layers=X_LAYERS)
    base = bundle(cfg).init(SEED, device="cuda")
    torch.cuda.synchronize()
    x_counts: dict = {}

    # ---- training: X_TENANTS on xla (X1), one on pallas (K1) ------------ #
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    store = make_lora_tenants(cfg, base, X_TENANTS, steps=X_TENANT_STEPS,
                              batch=X_TENANT_BATCH, backend="xla",
                              seed0=X_SEED0)
    torch.cuda.synchronize()
    xla_s = time.perf_counter() - t0
    add_counts(x_counts, _build, ("zo_affine_threefry",),
               f"(x) {X_TENANTS} LoRA tenants trained on xla")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    pstore = make_lora_tenants(cfg, base, 1, steps=X_TENANT_STEPS,
                               batch=X_TENANT_BATCH, backend="pallas",
                               seed0=X_SEED0 + X_TENANTS)
    torch.cuda.synchronize()
    pallas_s = time.perf_counter() - t0
    add_counts(x_counts, _build, ("zo_affine",),
               "(x) one LoRA tenant trained on pallas")
    p_tenant = tenant_name(X_TENANTS)
    store.put(p_tenant, pstore.ledger(pstore.tenants()[0]))
    steps = (X_TENANTS + 1) * X_TENANT_STEPS
    step_ms["x_lora_tenants"] = 1e3 * (xla_s + pallas_s) / steps
    log(f"(x) trained {X_TENANTS} + 1 LoRA tenants (r {synth.LORA_RANK}, α "
        f"{synth.LORA_ALPHA:g} on {' / '.join(synth.LORA_TARGETS)})"
        f", {X_TENANT_STEPS} steps of {X_TENANT_BATCH} each: {xla_s:.1f} s "
        f"on xla, {pallas_s:.1f} s on pallas ({step_ms['x_lora_tenants']:.1f}"
        f" ms a step); {len(store)} ledgers, {store.nbytes()} bytes in all")

    # ---- cached ≡ compacted ≡ fresh; card ≡ CPU; hits replay nothing ---- #
    _build.reset_launch_counts()
    rt = lora_runtime(cfg, base, store, cache_bytes=X_CACHE_BYTES)
    base_cpu = tree_map(lambda t: t.to("cpu"), base)
    for t in (tenant_name(0), p_tenant):
        led = store.ledger(t)
        opt = composition_for_ledger(led)
        cached = rt.delta(t)
        n = rt.records_replayed
        if rt.delta(t) is not cached or rt.records_replayed != n:
            fail(f"(x) {t}: a cache hit replayed records or returned other "
                 "buffers")

        def serving(tuned):
            return AdapterDelta.diff(base, merge_lora(tuned["base"],
                                                      tuned["lora"]))
        fresh_tree = replay(lora_params0(cfg, base, led), led, opt)
        fresh = serving(fresh_tree)
        comp = compact(lora_params0(cfg, base, led), led, opt,
                       keep_tail=X_KEEP_TAIL)
        compacted = serving(materialize(lora_params0(cfg, base, led), comp,
                                        opt, ledger=led))
        if not (_same_delta(cached, fresh) and _same_delta(compacted, fresh)):
            fail(f"(x) {t} ({led.backend}): cached, compacted (keep_tail "
                 f"{X_KEEP_TAIL}) and fresh deltas are not bitwise equal")
        if cached.nbytes != X_DELTA_BYTES or len(cached.indices) != 2:
            fail(f"(x) {t}: a delta of {cached.nbytes} bytes in "
                 f"{len(cached.indices)} leaves, not the merged wq + wv's "
                 f"{X_DELTA_BYTES}")
        cpu_tree = replay(lora_params0(cfg, base_cpu, led), led, opt)
        for a, b in zip(tree_leaves(fresh_tree["lora"]),
                        tree_leaves(cpu_tree["lora"])):
            if not same_bits(a.cpu(), b):
                fail(f"(x) {t} ({led.backend}): the card's replayed LoRA "
                     "tree differs from the CPU's plain replay")
        cpu_delta = AdapterDelta.diff(base_cpu, merge_lora(
            cpu_tree["base"], cpu_tree["lora"]))
        # the merge W + (α/r)·A·B rounds twice in bf16 (the product, the
        # sum): where cuBLAS's product and the CPU's round apart, the two
        # merged leaves may differ by one ulp of the product and one of
        # the sum; which side rounds the f32-exact product is reported
        n_diff, worst, prod = 0, 0.0, []
        for t_name, a, b in zip(("wq", "wv"), cached.values,
                                cpu_delta.values):
            w = base_cpu["layers"]["attn"][t_name].float()
            a, b = a.cpu().float(), b.float()
            d = (a - b).abs()
            tol = (_bf16_ulp(torch, torch.maximum(a.abs(), b.abs()))
                   + _bf16_ulp(torch, (b - w).abs()))
            if bool((d > tol).any()):
                fail(f"(x) {t}: merged {t_name} past its bound (one bf16 "
                     f"ulp of the product and one of the sum) from the "
                     f"CPU's: max |Δ| {float(d.max()):.3g}")
            n_diff += int((d > 0).sum())
            worst = max(worst, float(d.max()))
            ab_card = fresh_tree["lora"][t_name]
            ab_cpu = cpu_tree["lora"][t_name]
            sc = fresh_tree["lora"]["_scale"]
            exact = (torch.einsum("ldr,lro->ldo", ab_cpu["a"].float(),
                                  ab_cpu["b"].float())
                     * sc.cpu().float()).to(torch.bfloat16)
            on_card = (torch.einsum("ldr,lro->ldo", ab_card["a"],
                                    ab_card["b"]) * sc).cpu()
            on_cpu = torch.einsum("ldr,lro->ldo", ab_cpu["a"],
                                  ab_cpu["b"]) * sc.cpu()
            prod.append(f"{t_name} card {int((on_card != exact).sum())}, "
                        f"CPU {int((on_cpu != exact).sum())}")
        log(f"(x) {t} ({led.backend}, {len(led)} records): cached ≡ "
            f"compacted (tail {X_KEEP_TAIL}) ≡ fresh delta bitwise "
            f"({cached.nbytes} bytes: wq + wv merged); a hit replays 0 "
            f"records; replayed LoRA tree ≡ the CPU plain replay bitwise; "
            f"merged leaves vs the CPU's merge: {n_diff} elements differ "
            f"(max |Δ| {worst:.3g}; bound one bf16 ulp of the product and "
            f"one of the sum); bf16 products off the rounded f32-exact "
            f"product: {'; '.join(prod)}")
        del fresh_tree, cpu_tree, comp
    add_counts(x_counts, _build, ("zo_affine_threefry", "zo_affine"),
               "(x) materializations and compaction")
    del base_cpu, rt

    # ---- the serving load ------------------------------------------------ #
    _build.reset_launch_counts()
    rt = lora_runtime(cfg, base, store, cache_bytes=X_CACHE_BYTES)
    cold_flags = []
    delta_fn = rt.delta

    def delta(t):
        m = rt.materializations
        d = delta_fn(t)
        cold_flags.append(rt.materializations > m)
        return d
    rt.delta = delta
    eng = ServeEngine(cfg, base, slots=X_SLOTS, max_len=X_MAX_LEN,
                      device="cuda")
    tenants = store.tenants()
    tagged = synthetic_requests(X_REQUESTS, cfg.vocab_size, tenants,
                                seed=SEED, max_new_tokens=X_NEW, skew=X_SKEW)
    tagged[3] = (None, tagged[3][1])          # one base-model request
    wave = template_requests(X_WAVE, cfg.vocab_size, tenants,
                             n_templates=X_TEMPLATES,
                             template_len=X_TEMPLATE_LEN, seed=SEED + 1,
                             max_new_tokens=X_NEW, rid0=1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = serve_load(eng, rt, tagged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flags = iter(cold_flags)
    cold = [next(flags) if t is not None else False for t, _ in tagged]
    rows_w = serve_load(eng, rt, wave)
    torch.cuda.synchronize()
    add_counts(x_counts, _build, ("zo_affine_threefry", "flash_attention",
                                  "paged_gather"), "(x) serving load")
    for name, n in x_counts.items():
        counts[name] = counts.get(name, 0) + n
    tokens = sum(r["n_out"] for r in rows)
    if tokens != X_REQUESTS * X_NEW or sum(
            r["n_out"] for r in rows_w) != X_WAVE * X_NEW:
        fail("(x) a request did not produce its tokens")
    st = rt.stats
    if st["evictions"] == 0:
        fail(f"(x) the {X_CACHE_BYTES}-byte cache never evicted: {st}")
    # decode_calls counts the registry decode's own calls: one a stacked
    # step under vmap, one per slot if the slots were looped over
    if eng.decode_steps["stacked"] == 0 or eng.decode_calls["stacked"] != \
            eng.decode_steps["stacked"]:
        fail(f"(x) stacked decode: {eng.decode_calls} calls over "
             f"{eng.decode_steps} steps")

    def pct(xs, q):
        xs = sorted(xs)
        return 1e3 * xs[min(len(xs) - 1, int(len(xs) * q))] if xs else 0.0
    tt_cold = [r["ttft_s"] for r, c in zip(rows, cold) if c]
    tt_warm = [r["ttft_s"] for r, c in zip(rows, cold) if not c]
    ps = eng.prefix_stats()
    log(f"(x) served {len(rows)} requests over {len(tenants)} tenants (skew "
        f"{X_SKEW}, 1 base) / {tokens} tokens in {wall:.2f} s: "
        f"{tokens / wall:.1f} tok/s; TTFT p50 / p99 cold "
        f"({len(tt_cold)}) {pct(tt_cold, 0.5):.1f} / {pct(tt_cold, 0.99):.1f}"
        f" ms, warm ({len(tt_warm)}) {pct(tt_warm, 0.5):.1f} / "
        f"{pct(tt_warm, 0.99):.1f} ms; cache hit rate {st['hit_rate']:.2f} "
        f"({st['hits']} hits, {st['misses']} misses, {st['evictions']} "
        f"evictions, budget {X_CACHE_BYTES} bytes), "
        f"{st['records_replayed']} records replayed; template wave "
        f"{len(rows_w)} requests: prefill {ps['prefill_tokens_computed']}/"
        f"{ps['prefill_tokens_submitted']} tokens computed, prefix hit rate "
        f"{ps['prefix_hit_rate']:.2f}; decode calls {eng.decode_calls} over "
        f"steps {eng.decode_steps} — on {card}")
    del eng

    # ---- cold materialization against a warm swap ------------------------ #
    rt = lora_runtime(cfg, base, store, cache_bytes=X_CACHE_BYTES)
    eng = ServeEngine(cfg, base, slots=X_SLOTS, max_len=X_MAX_LEN,
                      device="cuda")
    parts = {"replay": [], "merge": [], "diff": [], "cold": [], "swap": []}
    for i, t in enumerate(tenants[:3]):
        led = store.ledger(t)
        opt = composition_for_ledger(led)
        box = {}
        parts["replay"].append(host_ms(lambda: box.__setitem__(
            "t", replay_copy(lora_params0(cfg, base, led), led, opt))))
        parts["merge"].append(host_ms(lambda: box.__setitem__(
            "m", merge_lora(box["t"]["base"], box["t"]["lora"]))))
        parts["diff"].append(host_ms(lambda: AdapterDelta.diff(base,
                                                               box["m"])))
        parts["cold"].append(host_ms(lambda: rt.delta(t)))
        parts["swap"].append(host_ms(lambda: eng.register_adapter(
            f"{t}/swap{i}", rt.delta(t))))
    med = {k: statistics.median(v) for k, v in parts.items()}
    log(f"(x) cold materialization {med['cold']:.2f} ms (replay "
        f"{med['replay']:.2f} of {X_TENANT_STEPS} records + merge "
        f"{med['merge']:.2f} + diff {med['diff']:.2f}) against a warm swap "
        f"(cache hit + register) {med['swap']:.3f} ms — medians of 3, on "
        f"{card}")
    del eng, rt

    # ---- decode-step ms: single-model, stacked, grouped (bf16) ----------- #
    rt = lora_runtime(cfg, base, store)
    deltas = {t: rt.delta(t) for t in tenants[:X_SLOTS]}
    noisy = tree_map(lambda a: a + torch.tensor(0.01, dtype=a.dtype,
                                                device=a.device)
                     if a.dtype.is_floating_point else a, base)
    deltas["full"] = AdapterDelta.diff(base, noisy)
    del noisy
    if not deltas["full"].full_tree:
        fail("(x) the full-tree delta is not full")
    prompts = [r.prompt_ids for _, r in tagged[:X_SLOTS]]
    loads = {"single": [None] * X_SLOTS, "stacked": tenants[:X_SLOTS],
             "grouped": ["full", "full", None, None]}
    dec = {}
    for path, names in loads.items():
        eng = ServeEngine(cfg, base, slots=X_SLOTS, max_len=X_MAX_LEN,
                          device="cuda")
        reqs = []
        for i, (name, p) in enumerate(zip(names, prompts)):
            if name is not None:
                eng.register_adapter(name, deltas[name])
            reqs.append(Request(i, list(p), max_new_tokens=X_STEP_TOKENS,
                                adapter=name))
        dec[path] = _decode_step_ms(torch, eng, reqs)
        want = {"single": "base"}.get(path, path)
        if eng.decode_steps[want] == 0:
            fail(f"(x) the {path} load took {eng.decode_steps}")
    log("(x) decode step over 4 slots: " + ", ".join(
        f"{k} {v[0]:.2f} ms ({v[1]} steps)" for k, v in dec.items())
        + f" (grouped: 2 calls a step) — host clock, medians, on {card}")

    # ---- bf16: stacked vs grouped logits, ids vs single-slot engines ----- #
    eng = ServeEngine(cfg, base, slots=X_SLOTS, max_len=X_MAX_LEN,
                      device="cuda")
    mix = [(t, Request(i, list(p), max_new_tokens=X_CHECK_NEW))
           for i, (t, p) in enumerate(zip(tenants[:3] + [None], prompts))]
    gap16, agree16, n16 = _stacked_vs_grouped(torch, eng, deltas, mix)
    eng.run()
    ref16 = _single_slot_ids(cfg, base, deltas, mix, X_CHECK_NEW, X_MAX_LEN)
    same16 = sum(a == b for (_, r), ids in zip(mix, ref16)
                 for a, b in zip(r.out_ids, ids))
    del eng, deltas, rt

    # ---- f32: stacked ≡ per-adapter; a full-tree delta on grouped -------- #
    cfg32 = cfg.replace(dtype="float32")
    base32 = _cast_tree(base, torch.float32)
    del base
    free_card(torch, "(x) the bf16 base")
    rt32 = lora_runtime(cfg32, base32, store)
    d32 = {t: rt32.delta(t) for t in tenants[:3]}
    noisy = tree_map(lambda a: a + torch.tensor(0.01, dtype=a.dtype,
                                                device=a.device), base32)
    d32["full"] = AdapterDelta.diff(base32, noisy)
    del noisy
    eng = ServeEngine(cfg32, base32, slots=X_SLOTS, max_len=X_MAX_LEN,
                      device="cuda")
    mix = [(t, Request(i, list(p), max_new_tokens=X_CHECK_NEW))
           for i, (t, p) in enumerate(zip(tenants[:3] + [None], prompts))]
    gap32, agree32, n32 = _stacked_vs_grouped(torch, eng, d32, mix)
    eng.run()
    if gap32 > X_F32_LOGIT_REL or agree32 != n32:
        fail(f"(x) f32 stacked vs grouped logits: {gap32:.3e} of max "
             f"|logits| (tolerance {X_F32_LOGIT_REL}), argmax {agree32}/{n32}")
    if eng.decode_calls["stacked"] != eng.decode_steps["stacked"]:
        fail(f"(x) f32 stacked: {eng.decode_calls} over {eng.decode_steps}")
    ref32 = _single_slot_ids(cfg32, base32, d32, mix, X_CHECK_NEW, X_MAX_LEN)
    if [r.out_ids for _, r in mix] != ref32:
        fail("(x) f32 stacked-decode ids differ from single-slot engines")
    eng = ServeEngine(cfg32, base32, slots=X_SLOTS, max_len=X_MAX_LEN,
                      device="cuda")
    eng.register_adapter("full", d32["full"])
    full = [("full", Request(0, list(prompts[0]), max_new_tokens=X_CHECK_NEW,
                             adapter="full")),
            (None, Request(1, list(prompts[1]), max_new_tokens=X_CHECK_NEW))]
    for _, r in full:
        eng.submit(r)
    eng.run()
    if eng.decode_steps["grouped"] == 0 or eng.decode_steps["stacked"]:
        fail(f"(x) the full-tree delta took {eng.decode_steps}")
    if [r.out_ids for _, r in full] != _single_slot_ids(
            cfg32, base32, d32, full, X_CHECK_NEW, X_MAX_LEN):
        fail("(x) f32 full-tree (grouped) ids differ from single-slot "
             "engines")
    log(f"(x) stacked ≡ per-adapter: f32 logits {gap32:.3e} of max |logits| "
        f"apart (tolerance {X_F32_LOGIT_REL}), argmax {agree32}/{n32}, ids "
        f"of 3 tenants + the base ≡ single-slot engines ({X_CHECK_NEW} tokens"
        f" each); a full-tree delta took the grouped path "
        f"({eng.decode_calls['grouped']} calls over "
        f"{eng.decode_steps['grouped']} steps), ids ≡ single-slot engines; "
        f"bf16 (reported): logits {gap16:.3e} apart, argmax {agree16}/{n16}, "
        f"ids {same16}/{4 * X_CHECK_NEW} equal to single-slot engines")
    log("(x) launches on the phase: " + ", ".join(
        f"{k} {x_counts.get(k, 0)}" for k in (
            "zo_affine_threefry", "zo_affine", "flash_attention",
            "paged_gather")) + " (X1, K1, K2, K12)")
    for k in ("zo_affine_threefry", "zo_affine", "flash_attention",
              "paged_gather"):
        if x_counts.get(k, 0) == 0:
            fail(f"(x) {k} never launched on the phase")
    del eng, base32, d32, rt32


def shims_paths(torch, np, _build, counts, step_ms, card) -> None:
    """(y) The deprecated shims, the legacy-config interop and the
    functional primitives (``repro_torch.core``) at qwen2-0.5b's full width
    and depth (24 layers, d 896, bf16, ``pallas_flash``, random weights
    from seed 0, 16 × 256 lm batches, lr 1e-6, ε 1e-3): ``MeZO(MeZOConfig)``
    (legacy ``init(0)``) through ``train.loop`` with a ledger against
    ``zo.mezo`` (θ bitwise after every step, the ledgers' bytes equal), its
    step's peak gated at ``MEM_SLACK`` × one forward's; ``core.replay``
    through a bare ``MeZOConfig`` ≡ the preset's replay ≡ the plain replay,
    within the ulp bound of the trained θ; a config-like object naming
    ``backend="pallas"`` (K1) ≡ ``zo.mezo(backend="pallas")``;
    ``MeZOAdam`` ≡ ``zo.mezo_adam``; ``MeZOVariant`` (grad_norm_zo, its
    legacy ``init(params, loss_fn, batch)``) ≡ ``zo.mezo_rescaled``; the
    functional ``perturb`` / ``fused_restore_update`` / ``apply_rank1`` ≡
    the backend's in-place writes with the caller's leaves untouched;
    ``spsa_projected_grad``'s chain ≡ the ``spsa`` estimator's (trees, and
    ℓ± within ``Y_LOSS_REL``); ``sample_z_tree`` ≡ X1's ``z`` form; the
    oracle's leaf = g·z; the shim's step timed against the preset's in
    turns."""
    import dataclasses
    import statistics
    import types

    from repro_torch import zo
    from repro_torch.core import (MeZO, MeZOAdam, MeZOAdamConfig, MeZOConfig,
                                  MeZOVariant, MeZOVariantConfig,
                                  TrajectoryLedger, replay,
                                  spsa_full_gradient_oracle,
                                  spsa_projected_grad)
    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.kernels.threefry.kernel import zo_affine_threefry
    from repro_torch.models import all_archs, bundle
    from repro_torch.perturb import StreamRef, get_backend
    from repro_torch.perturb import xla as fx
    from repro_torch.perturb.stream import prng_key, step_key
    from repro_torch.train.loop import train
    from repro_torch.tree_utils import tree_leaves
    from repro_torch.zo.base import host_f32
    before = dict(counts)
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(attention_impl="pallas_flash")
    params0 = bundle(cfg).init(SEED, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params0))
    if n_params != QWEN2_PARAMS or cfg.n_layers != 24 or cfg.d_model != 896:
        fail(f"(y) qwen2-0.5b at {n_params} parameters, {cfg.n_layers} "
             f"layers, d {cfg.d_model}: not its full width and depth")
    loss_fn = bundle(cfg).loss_fn()

    def pipe():
        return Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                 vocab=cfg.vocab_size, seed=SEED),
                        device="cuda")

    data = pipe()
    batch = data.batch(0)
    conf = MeZOConfig(lr=LR, eps=EPS)

    def same_trees(a, b) -> bool:
        return all(same_bits(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    # ---- 1. the legacy shim through the loop, against the preset ------- #
    if MeZO(conf).init(SEED) != zo.mezo(lr=LR, eps=EPS).init(params0,
                                                             seed=SEED):
        fail("(y) MeZO's legacy init(0) != zo.mezo's init(θ₀, seed=0)")
    memory_and_busy(torch, cfg, params0, loss_fn=loss_fn, batch=batch,
                    opt=MeZO(conf), what="MeZO(MeZOConfig) shim (xla)")
    snaps: list = []

    def loop(opt, what, compare: bool):
        params = _clone_tree(params0)
        led = TrajectoryLedger(base_seed=SEED, grad_dtype="float32",
                               backend=opt.backend_name)

        def each(step, p):
            if not compare:
                snaps.append(_clone_tree(p))
            elif not same_trees(p, snaps[step - 1]):
                fail(f"(y) {what}: θ after step {step} != the shim's")

        _build.reset_launch_counts()
        res = train(loss_fn, params, opt, pipe(), total_steps=Y_STEPS,
                    ledger=led, eval_fn=each, eval_every=1, log_every=1,
                    seed=SEED)
        torch.cuda.synchronize()
        add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
                   f"(y) {what} through train.loop")
        losses = [v for _, v in res.losses]
        if len(losses) != Y_STEPS or not all(v == v and abs(v) < 1e30
                                             for v in losses):
            fail(f"(y) {what}: losses not finite: {losses}")
        return res.params, led, losses

    p_shim, led, l_shim = loop(MeZO(conf), "MeZO(MeZOConfig)", False)
    p_pre, led_pre, l_pre = loop(zo.mezo(lr=LR, eps=EPS), "zo.mezo", True)
    if led.to_bytes() != led_pre.to_bytes() or l_shim != l_pre:
        fail("(y) the shim's ledger bytes or losses != the preset's")
    snaps.clear()
    del p_pre
    log(f"(y) MeZO(MeZOConfig(lr {LR}, eps {EPS})) through train.loop ≡ "
        f"zo.mezo: θ bitwise after each of {Y_STEPS} steps, losses "
        f"{l_shim[0]:.4f} -> {l_shim[-1]:.4f} equal, ledgers "
        f"{led.to_bytes()[:5].decode()} {led.nbytes()} bytes identical")
    _build.reset_launch_counts()
    rep = replay(_clone_tree(params0), led, MeZOConfig(lr=LR, eps=EPS))
    rep2 = replay(_clone_tree(params0), led, zo.mezo(lr=LR, eps=EPS))
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry",),
               "(y) core.replay through a bare MeZOConfig")
    if not same_trees(rep, rep2):
        fail("(y) the replay through a bare MeZOConfig != through zo.mezo")
    del rep2
    plain = _clone_tree(params0)
    plain_replay_xla(plain, led, np)
    torch.cuda.synchronize()
    if not same_trees(rep, plain):
        fail("(y) the replay through a bare MeZOConfig != the plain replay")
    del plain
    log("(y) core.replay(θ₀, ledger, MeZOConfig) ≡ its replay through "
        "zo.mezo ≡ X1's plain replay, bitwise; vs the trained θ: "
        + hold_ulps(torch, "y_shim",
                    list(zip(tree_leaves(rep), tree_leaves(p_shim))))
        + " (the live chain rounds θ±εz in bf16)")
    del rep, p_shim

    # ---- 2.-3. a config naming the counter backend; the other shims ---- #
    def lockstep(opt_a, opt_b, steps, what, required, init_a=None,
                 init_b=None):
        pa, pb = _clone_tree(params0), _clone_tree(params0)
        _build.reset_launch_counts()
        sa = init_a(pa) if init_a else opt_a.init(pa, seed=SEED)
        sb = init_b(pb) if init_b else opt_b.init(pb, seed=SEED)
        fa, fb = opt_a.step_fn(loss_fn), opt_b.step_fn(loss_fn)
        losses = []
        for k in range(steps):
            b = data.batch(k)
            pa, sa, ma = fa(pa, sa, b)
            pb, sb, mb = fb(pb, sb, b)
            if not same_trees(pa, pb):
                fail(f"(y) {what}: θ after step {k + 1} differs")
            if (float(ma["loss"]), float(ma["projected_grad"])) != (
                    float(mb["loss"]), float(mb["projected_grad"])):
                fail(f"(y) {what}: step {k + 1}'s loss or g differs")
            losses.append(float(ma["loss"]))
        torch.cuda.synchronize()
        add_counts(counts, _build, required, f"(y) {what}")
        if not all(v == v and abs(v) < 1e30 for v in losses) or \
                same_trees(pa, params0):
            fail(f"(y) {what}: losses {losses} not finite or θ unmoved")
        log(f"(y) {what}: θ, loss and g bitwise after each of {steps} "
            f"steps (loss {losses[0]:.4f} -> {losses[-1]:.4f})")

    duck = types.SimpleNamespace(**dataclasses.asdict(conf), backend="pallas")
    from_cfg = zo.from_config(duck)
    if from_cfg.backend_name != "pallas+z2":
        fail(f"(y) from_config(backend='pallas') runs on "
             f"{from_cfg.backend_name}")
    lockstep(from_cfg, zo.mezo(lr=LR, eps=EPS, backend="pallas"),
             Y_PALLAS_STEPS, "from_config(config-like, backend='pallas') ≡ "
             "zo.mezo(backend='pallas')", ("zo_affine", "flash_attention"))
    adam = MeZOAdam(MeZOAdamConfig(lr=LR, eps=EPS, window=32))
    lockstep(adam, zo.mezo_adam(lr=LR, eps=EPS, window=32), Y_ADAM_STEPS,
             "MeZOAdam(window 32) ≡ zo.mezo_adam",
             ("zo_affine_threefry", "flash_attention"),
             init_a=lambda p: adam.init(p, SEED))
    var = MeZOVariant(MeZOVariantConfig(lr=LR, eps=EPS,
                                        d_source="grad_norm_zo"))
    lockstep(var, zo.mezo_rescaled(lr=LR, eps=EPS, d_source="grad_norm_zo",
                                   probe_loss_fn=loss_fn, probe_batch=batch),
             Y_VARIANT_STEPS, "MeZOVariant(grad_norm_zo), init(θ, loss_fn, "
             "batch) ≡ zo.mezo_rescaled(probe_loss_fn=, probe_batch=)",
             ("zo_affine_threefry", "flash_attention"),
             init_a=lambda p: var.init(p, loss_fn, batch, seed=SEED))

    # ---- 4. the functional primitives at full width --------------------- #
    key = step_key(prng_key(SEED), 12345)
    ref, be = StreamRef(key), get_backend("xla")
    kept = _clone_tree(params0)
    coeff = np.float32(LR) * np.float32(0.37)
    _build.reset_launch_counts()
    for what, pure, inplace in (
            ("perturb", lambda t: fx.perturb(t, key, EPS),
             lambda t: be.perturb(t, ref, EPS)),
            ("fused_restore_update",
             lambda t: fx.fused_restore_update(t, key, EPS, coeff, 0.0),
             lambda t: be.fused_restore_update(t, ref, EPS, coeff, 0.0)),
            ("apply_rank1", lambda t: fx.apply_rank1(t, key, coeff, 0.0),
             lambda t: be.apply_rank1(t, ref, coeff, 0.0))):
        got = pure(params0)
        want = inplace(_clone_tree(params0))
        torch.cuda.synchronize()
        if not same_trees(got, want):
            fail(f"(y) the functional {what} != the backend's in-place write")
        if not same_trees(params0, kept) or any(
                a is b for a, b in zip(tree_leaves(got),
                                       tree_leaves(params0))):
            fail(f"(y) the functional {what} wrote the caller's leaves")
        del got, want
    z = fx.sample_z_tree(params0, key)
    for i, (zl, p) in enumerate(zip(tree_leaves(z), tree_leaves(params0))):
        x1z = zo_affine_threefry(None, fx.leaf_key(key, i), "z",
                                 out=torch.empty_like(p))
        if not same_bits(zl, x1z):
            fail(f"(y) sample_z_tree's leaf {i} != X1's z form")
    del z, x1z
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry",),
               "(y) the functional writes and sample_z_tree")
    log("(y) the functional perturb / fused_restore_update / apply_rank1 "
        "(fresh leaves) ≡ the backend's in-place writes bitwise, the "
        "caller's leaves bitwise unchanged; sample_z_tree ≡ X1's z form "
        "leaf by leaf")
    # the functional spsa chain: its peak over one forward's, then its
    # trees and ℓ± against the in-place estimator's
    gc.collect()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        loss_fn(params0, batch).item()
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    spsa_projected_grad(loss_fn, params0, batch, key, EPS)
    torch.cuda.synchronize()
    chain = torch.cuda.max_memory_allocated() - base
    theta = sum(p.numel() * p.element_size() for p in tree_leaves(params0))
    log(f"(y) spsa_projected_grad(sequential=True) peaks at "
        f"{(chain + theta) / 2**30:.3f} GiB with θ, one forward at "
        f"{(fwd + theta) / 2**30:.3f} GiB — ratio "
        f"{(chain + theta) / (fwd + theta):.4f} (θ, θ+εz and θ−εz live at "
        "once; reported, not gated) — on " + card)
    seen: dict = {"f": [], "e": []}

    def recording(tag):
        def f(p, b):
            seen[tag].append(_clone_tree(p))
            return loss_fn(p, b)
        return f

    r = spsa_projected_grad(recording("f"), params0, batch, key, EPS)
    losses_e = []

    def rec_e(p, b):
        seen["e"].append(_clone_tree(p))
        out = loss_fn(p, b)
        losses_e.append(host_f32(out))
        return out

    with torch.no_grad():
        zo.estimators.spsa(eps=EPS, backend="xla").estimate(
            rec_e, _clone_tree(params0), batch, key, ())
    torch.cuda.synchronize()
    for a, b in zip(seen["f"], seen["e"]):
        if not same_trees(a, b):
            fail("(y) spsa_projected_grad's θ±εz != the spsa estimator's")
    seen.clear()
    bitwise = (r.l_plus, r.l_minus) == tuple(losses_e)
    for a, b in zip((r.l_plus, r.l_minus), losses_e):
        if abs(float(a) - float(b)) > Y_LOSS_REL * abs(float(b)):
            fail(f"(y) spsa_projected_grad's ℓ± {r.l_plus}, {r.l_minus} "
                 f"vs the estimator's {losses_e}")
    gz = spsa_full_gradient_oracle(loss_fn, params0, batch, key, EPS)
    i_leaf = len(tree_leaves(params0)) - 1
    leaf, p_last = tree_leaves(gz)[i_leaf], tree_leaves(params0)[i_leaf]
    zl = fx.sample_leaf_z(fx.leaf_key(key, i_leaf), p_last).float()
    nz = zl != 0
    # the oracle's g: the candidate (a ratio leaf / z) whose product with z
    # is the leaf, bit for bit
    g_star = next((float(c) for c in torch.unique(
        (leaf[nz] / zl[nz])[:64]) if torch.equal(leaf, zl * float(c))),
        None)
    if g_star is None:
        fail("(y) spsa_full_gradient_oracle's leaf != g·z for any g")
    r0 = spsa_projected_grad(loss_fn, params0, batch, key, EPS,
                             sequential=False)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
               "(y) spsa_projected_grad and the oracle")
    if abs(g_star - float(r0.projected_grad)) > 1e-3 * max(
            1.0, abs(float(r0.projected_grad))):
        fail(f"(y) the oracle's g {g_star} vs the centered estimate's "
             f"{r0.projected_grad}")
    if not same_trees(params0, kept):
        fail("(y) the functional spsa chain wrote θ₀")
    del gz, leaf, zl, kept
    log(f"(y) spsa_projected_grad(sequential=True): θ+εz and θ−εz ≡ the "
        f"spsa estimator's bitwise; ℓ± {float(r.l_plus):.6f} / "
        f"{float(r.l_minus):.6f} — "
        + ("bitwise the estimator's" if bitwise else
           f"the estimator's {losses_e} (within {Y_LOSS_REL} relative)")
        + f"; the oracle's last leaf ({p_last.numel()} elements) = g·z "
        f"with g {g_star:.6g} (the centered estimate's "
        f"{float(r0.projected_grad):.6g})")

    # ---- 5. the shim's step against the preset's, host clock, in turns - #
    opts = {"shim": MeZO(conf), "preset": zo.mezo(lr=LR, eps=EPS)}
    run = {}
    for who, opt in opts.items():
        p = _clone_tree(params0)
        st = opt.init(SEED) if who == "shim" else opt.init(p, seed=SEED)
        run[who] = [p, st, opt.step_fn(loss_fn)]
    times: dict = {"shim": [], "preset": []}
    _build.reset_launch_counts()
    for who in ("shim", "preset") + ("preset", "shim") * 2:
        for _ in range(Y_TURN_STEPS):
            p, st, fn = run[who]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, st, _ = fn(p, st, batch)
            torch.cuda.synchronize()
            times[who].append((time.perf_counter() - t0) * 1e3)
            run[who][:2] = [p, st]
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
               "(y) the timed turns")
    # the first turn of each warms up
    ms = {k: statistics.median(v[Y_TURN_STEPS:]) for k, v in times.items()}
    step_ms["y_shim"] = ms["shim"]
    del run
    log(f"(y) one spsa step on xla, host clock, turns S P P S P S of "
        f"{Y_TURN_STEPS} steps (the first of each discarded): MeZO shim "
        f"{ms['shim']:.2f} ms, zo.mezo {ms['preset']:.2f} ms (medians) — "
        f"on {card}")
    y = {k: counts.get(k, 0) - before.get(k, 0) for k in counts}
    x1_routes = {k.split("/", 1)[1]: v for k, v in y.items()
                 if k.startswith("zo_affine_threefry/") and v}
    for name in ("zo_affine_threefry", "zo_affine", "flash_attention"):
        if y.get(name, 0) <= 0:
            fail(f"(y) {name} never launched in the phase")
    log(f"(y) launches in the phase: X1 {y['zo_affine_threefry']} "
        f"(routes {x1_routes}), K1 {y['zo_affine']}, K2 "
        f"{y['flash_attention']} (hd 64: {y.get('flash_attention/hd64', 0)})")
    del params0


# --------------------------------------------------------------------------- #
# (z) distribution on qwen2-0.5b at full width and depth
# --------------------------------------------------------------------------- #
def distribution_paths(torch, np, _build, counts, step_ms, card) -> None:
    """(z) Distribution (``repro_torch.distributed``, ``launch.mesh``) at
    qwen2-0.5b's full width and depth (24 layers, d 896, bf16,
    ``pallas_flash``, random weights from seed 0, 16 × 256 lm batches, lr
    1e-6, ε 1e-3, the ``xla`` stream unless named), inside a one-rank NCCL
    group (a ``FileStore`` under the build directory) that lives for the
    whole phase: ``make_elastic_mesh``'s (1, 1) ``DeviceMesh`` on the card;
    the rule engine's sharded-leaf counts on the production meshes; every
    leaf placed with ``param_shardings`` and taken back bitwise, saved
    placed and loaded onto plain tensors bitwise; the data-parallel spsa
    step over the group ≡ the step without a mesh (θ and metrics bitwise),
    its collectives recorded (at most two f32 each, one per loss
    evaluation); ``collectives.seed_parallel_step_fn`` ≡
    ``StepProgram(seed_parallel(4))`` from the legacy state and from a
    ``ZOState``; Z_WORKERS async workers over Z_ROUNDS staleness-0 rounds
    (bitwise equal, held to ``seed_parallel(4)`` within the stated bound,
    their ledger replayed bitwise), one round each on ``pallas`` (K1; the
    antithetic pair, K4; fzoo, K5 and K3), a delayed schedule held within
    its bound, and a contribution older than the window dropped; the
    activation resolver over the card's mesh leaves the logits' bits alone
    and is consulted 2 + 4·L times; produce / consume against a local step,
    in turns."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataSpec, Pipeline
    from repro_torch.models import all_archs, bundle
    from repro_torch.tree_utils import tree_leaves
    t_phase = time.perf_counter()
    before = dict(counts)
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(attention_impl="pallas_flash")
    b = bundle(cfg)
    params0 = b.init(SEED, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params0))
    if n_params != QWEN2_PARAMS or cfg.n_layers != 24 or cfg.d_model != 896:
        fail(f"(z) qwen2-0.5b at {n_params} parameters, {cfg.n_layers} "
             f"layers, d {cfg.d_model}: not its full width and depth")
    data = Pipeline(DataSpec("lm", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             vocab=cfg.vocab_size, seed=SEED), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    store = RUN_DIR / "z_filestore"
    store.unlink(missing_ok=True)
    # a failed init fails the phase (no fallback)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        _distribution_on_group(torch, np, _build, counts, step_ms, card,
                               cfg, params0, data)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    z = {k: counts.get(k, 0) - before.get(k, 0) for k in counts}
    for name in ("zo_affine_threefry", "zo_affine", "flash_attention",
                 "zo_affine_chain", "zo_affine_multi", "zo_affine_batched"):
        if z.get(name, 0) <= 0:
            fail(f"(z) {name} never launched in the phase")
    log(f"(z) launches in the phase: X1 {z['zo_affine_threefry']}, K1 "
        f"{z['zo_affine']}, K2 {z['flash_attention']}, K3 "
        f"{z['zo_affine_chain']}, K4 {z['zo_affine_multi']}, K5 "
        f"{z['zo_affine_batched']}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; "
        f"{time.perf_counter() - t_phase:.1f} s — on {card}")


def _dict_leaves(tree) -> list:
    """The leaves of a nested dict in the flatten order (sorted keys) — for
    trees whose leaves are specs or shardings, which the tree utilities
    would walk into."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _dict_leaves(tree[k])]
    return [tree]


def _distribution_on_group(torch, np, _build, counts, step_ms, card, cfg,
                           params0, data) -> None:
    """Phase (z)'s checks, inside its one-rank process group."""
    import statistics

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import exec as zexec
    from repro_torch import zo
    from repro_torch.checkpoint.io import load_tree, save_tree
    from repro_torch.core import TrajectoryLedger
    from repro_torch.distributed import (make_activation_resolver,
                                         param_shardings, param_specs)
    from repro_torch.distributed.async_zo import (AsyncZOWorker,
                                                  contributions_to_ledger,
                                                  run_sync_equivalent)
    from repro_torch.distributed.collectives import (seed_parallel_init,
                                                     seed_parallel_step_fn)
    from repro_torch.distributed.sharding import as_mesh
    from repro_torch.launch.mesh import (make_elastic_mesh, make_ep_mesh,
                                         make_production_mesh)
    from repro_torch.models import bundle, common
    from repro_torch.tree_utils import (flatten_with_path, tree_leaves,
                                        tree_unflatten)
    b = bundle(cfg)
    loss_fn = b.loss_fn()
    per = TRAIN_BATCH // Z_WORKERS
    batch0 = data.batch(0)
    theta_gib = sum(p.numel() * p.element_size()
                    for p in tree_leaves(params0)) / 2**30

    def same_trees(a, c) -> bool:
        return all(same_bits(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(c)))

    def worst_ulps(a, c) -> tuple:
        w, mx = 0.0, 0.0
        for x, y in zip(tree_leaves(a), tree_leaves(c)):
            u, _, m = ulp_diff(torch, x, y)
            w, mx = max(w, u), max(mx, m)
        return w, mx

    def shard(w, step):
        """Worker w's rows of the step's batch."""
        return {k: v[w * per:(w + 1) * per]
                for k, v in data.batch(step).items()}

    def workers(mk, **kw):
        return [AsyncZOWorker(w, Z_WORKERS, params0, loss_fn, mk(),
                              base_seed=SEED, **kw)
                for w in range(Z_WORKERS)]

    def mezo():
        return zo.mezo(lr=LR, eps=EPS)

    # ---- 1. the one-card mesh ---------------------------------------- #
    mesh = make_elastic_mesh()
    if (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            mesh.device_type) != (("data", "model"), (1, 1), "cuda"):
        fail(f"(z) make_elastic_mesh() over the one-rank group gave {mesh}")
    shapes = b.param_shapes()

    def sharded(m) -> str:
        sizes = as_mesh(m).shape
        named = split = 0
        for spec in _dict_leaves(param_specs(shapes, m)):
            axes = [a for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))]
            named += bool(axes)
            split += any(sizes[a] > 1 for a in axes)
        return f"{named} / {split}"

    meshes = {"single-pod (16, 16)": make_production_mesh(),
              "multi-pod (2, 16, 16)": make_production_mesh(multi_pod=True),
              "EP, make_ep_mesh(8), (16, 8, 2)": make_ep_mesh(8),
              "the card's (1, 1)": mesh}
    log(f"(z) qwen2-0.5b's param_specs (of {len(tree_leaves(shapes))} "
        "leaves: with a sharded dim / split over more than one rank): "
        + "; ".join(f"{k} {sharded(m)}" for k, m in meshes.items()))
    placed = []
    for (path, leaf), s in zip(flatten_with_path(params0),
                               _dict_leaves(param_shardings(params0, mesh))):
        dt = distribute_tensor(leaf, mesh, s.placements)
        if not same_bits(dt.to_local(), leaf):
            fail(f"(z) {path} placed with {s.placements}: to_local() != θ₀")
        placed.append(dt)
    ckpt = RUN_DIR / "z_placed.mz"
    t0 = time.perf_counter()
    save_tree(str(ckpt), tree_unflatten(params0, placed))
    loaded, _ = load_tree(str(ckpt), params0)
    io_s = time.perf_counter() - t0
    ckpt.unlink()
    if not same_trees(loaded, params0) or any(
            type(x) is not torch.Tensor for x in tree_leaves(loaded)):
        fail("(z) the placed tree saved and loaded onto plain tensors != θ₀")
    del placed, loaded
    log(f"(z) make_elastic_mesh() over the one-rank NCCL group: a (data 1, "
        f"model 1) DeviceMesh on cuda; every leaf placed with "
        f"param_shardings and taken back with to_local() bitwise; the "
        f"placed tree saved and loaded onto plain tensors bitwise "
        f"({io_s:.1f} s for {theta_gib:.2f} GiB, save + load)")

    # ---- 2. the data-parallel step over the one-rank group ----------- #
    calls, evals = [], [0]
    real = dist.all_reduce

    def recording(t, *a, **k):
        calls.append((t.numel(), t.dtype))
        return real(t, *a, **k)

    def counted(p, bt):
        return loss_fn(p, bt)

    def counted_parts(p, bt):          # what the data-parallel loss runs
        evals[0] += 1
        return loss_fn.parts(p, bt)

    counted.parts = counted_parts
    opt = mezo()
    runs = {}
    _build.reset_launch_counts()
    for name, plan, fn_loss in (("mesh", zexec.local(mesh=mesh), counted),
                                ("plain", zexec.local(), loss_fn)):
        p = _clone_tree(params0)
        st = opt.init(p, seed=SEED)
        fn = zexec.StepProgram(opt, plan).step_fn(fn_loss)
        metrics = []
        dist.all_reduce = recording
        try:
            for k in range(2):
                p, st, m = fn(p, st, data.batch(k))
                metrics.append((float(m["loss"]),
                                float(m["projected_grad"])))
        finally:
            dist.all_reduce = real
        runs[name] = (p, metrics)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
               "(z) the data-parallel steps")
    if not same_trees(runs["mesh"][0], runs["plain"][0]) or \
            runs["mesh"][1] != runs["plain"][1]:
        fail("(z) the data-parallel step over the one-rank group != the step "
             "without a mesh")
    if len(calls) != evals[0] or evals[0] != 4 or any(
            n > 2 or dt != torch.float32 for n, dt in calls):
        fail(f"(z) collectives of the data-parallel steps: {calls} for "
             f"{evals[0]} loss evaluations")
    del runs
    log(f"(z) 2 data-parallel spsa steps (local plan, the card's mesh) ≡ "
        f"the steps without a mesh: θ, loss and g bitwise; collectives "
        f"{len(calls)}, each one all_reduce of {calls[0][0]} "
        f"{str(calls[0][1]).replace('torch.', '')}, for {evals[0]} loss "
        "evaluations, and nothing else")

    # ---- 3. seed-parallel: the legacy surface ≡ the engine ----------- #
    prog = zexec.StepProgram(opt, zexec.seed_parallel(Z_WORKERS))
    legacy = seed_parallel_step_fn(loss_fn, opt, Z_WORKERS)
    _build.reset_launch_counts()
    p_eng = _clone_tree(params0)
    p_eng, _, m_eng = prog.step_fn(loss_fn)(
        p_eng, prog.init(p_eng, seed=SEED), batch0)
    for what, state_of in (("legacy SeedParallelState",
                            lambda p: seed_parallel_init(SEED)),
                           ("ZOState", lambda p: opt.init(p, seed=SEED))):
        p = _clone_tree(params0)
        p, st, m = legacy(p, state_of(p), batch0)
        if not same_trees(p, p_eng) or st.step != 1 or \
                float(m["loss"]) != float(m_eng["loss"]) or \
                not np.array_equal(m["projected_grads"],
                                   m_eng["projected_grads"]):
            fail(f"(z) seed_parallel_step_fn from a {what} != "
                 "StepProgram(seed_parallel(4))")
        del p
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
               "(z) seed_parallel(4)")
    del p_eng
    log("(z) collectives.seed_parallel_step_fn(loss, mezo, 4) ≡ "
        "StepProgram(seed_parallel(4)): θ, loss and the 4 g bitwise, from "
        "the legacy SeedParallelState and from a ZOState")

    # ---- 4. async workers: staleness 0 on xla, the ledger ------------ #
    _build.reset_launch_counts()
    ws = workers(mezo)
    contribs = []
    for _ in range(Z_ROUNDS):
        run_sync_equivalent(ws, shard)
        contribs += [w.outbox[-1] for w in ws]
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
               "(z) async staleness 0 on xla")
    for w in ws[1:]:
        if not same_trees(w.params, ws[0].params):
            fail(f"(z) async worker {w.w}'s θ != worker 0's after "
                 f"{Z_ROUNDS} staleness-0 rounds")
    _build.reset_launch_counts()
    p_sp = _clone_tree(params0)
    st = prog.init(p_sp, seed=SEED)
    step_sp = prog.step_fn(loss_fn)
    for k in range(Z_ROUNDS):
        p_sp, st, _ = step_sp(p_sp, st, data.batch(k))
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
               f"(z) seed_parallel(4), {Z_ROUNDS} steps on the full batch")
    sp_bound = Z_SP_ULPS_PER_GROUP_STEP * Z_WORKERS * Z_ROUNDS
    if same_trees(p_sp, ws[0].params):
        sp_text = "bitwise"
    else:
        u, mx = worst_ulps(ws[0].params, p_sp)
        if u > sp_bound:
            fail(f"(z) async workers vs seed_parallel(4): {u} bf16 ulps > "
                 f"the bound {sp_bound}")
        sp_text = (f"max {u:.2f} bf16 ulps at |θ| + ε·{Z_MAX} (bound "
                   f"{sp_bound:.0f}), max abs {mx:.3e}")
    del p_sp
    led = TrajectoryLedger(base_seed=SEED, grad_dtype="float32",
                           backend=ws[0].opt.backend_name)
    rec_skip = contributions_to_ledger(led, contribs, n_workers=Z_WORKERS)
    if rec_skip != (Z_ROUNDS, 0) or (led.exec_plan, led.n_groups) != (
            "async_worker", Z_WORKERS):
        fail(f"(z) contributions_to_ledger: {rec_skip}, {led.exec_plan} × "
             f"{led.n_groups}")
    _build.reset_launch_counts()
    rep = zexec.StepProgram(mezo(), zexec.replay()).replay(
        _clone_tree(params0), led)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry",),
               "(z) the async ledger's replay")
    if not same_trees(rep, ws[0].params):
        fail("(z) the async ledger's replay != the workers' θ")
    del rep
    log(f"(z) {Z_WORKERS} async workers × {Z_ROUNDS} staleness-0 rounds on "
        f"xla (each its own θ and its {per} × {TRAIN_SEQ} rows): θ bitwise "
        f"equal across workers; against seed_parallel(4) on the full batch "
        f"{sp_text} (seed_parallel restores θ between its groups); "
        f"contributions_to_ledger {rec_skip}, plan {led.exec_plan} × "
        f"{led.n_groups}, {led.nbytes()} bytes, its replay ≡ the workers' θ "
        "bitwise")

    # ---- host clock: produce / consume against a local step, in turns #
    times: dict = {"local": [], "produce": [], "consume": []}
    p_loc = _clone_tree(params0)
    st_loc = opt.init(p_loc, seed=SEED)
    local_step = opt.step_fn(loss_fn)
    w0 = ws[0]
    _build.reset_launch_counts()
    for k in range(Z_TURNS):
        for what in (("local", "produce", "consume") if k % 2 == 0
                     else ("consume", "produce", "local")):
            if what == "consume":
                c = w0.produce(shard(0, w0.step))
            elif what == "produce":
                bt = shard(0, w0.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if what == "local":
                p_loc, st_loc, _ = local_step(p_loc, st_loc, batch0)
            elif what == "produce":
                w0.produce(bt)
            else:
                w0.consume(c)
            torch.cuda.synchronize()
            times[what].append((time.perf_counter() - t0) * 1e3)
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
               "(z) the timed turns")
    med = {k: statistics.median(v) for k, v in times.items()}
    step_ms["z_produce"], step_ms["z_consume"] = (med["produce"],
                                                  med["consume"])
    del ws, w0, p_loc
    log(f"(z) host clock, {Z_TURNS} turns (L P C, C P L, …), medians: a "
        f"worker's produce {med['produce']:.2f} ms (spsa on its {per} × "
        f"{TRAIN_SEQ} rows), consume {med['consume']:.2f} ms (one "
        f"contribution: X1 over θ), a local spsa step on {TRAIN_BATCH} × "
        f"{TRAIN_SEQ} {med['local']:.2f} ms — on {card}")

    # ---- one staleness-0 round each on pallas ------------------------ #
    for what, mk, req in (
            ("spsa", lambda: zo.mezo(lr=LR, eps=EPS, backend="pallas"),
             ("zo_affine", "flash_attention")),
            ("spsa with the antithetic pair",
             lambda: zo.mezo(lr=LR, eps=EPS, backend="pallas",
                             sequential_perturb=False),
             ("zo_affine", "zo_affine_multi", "flash_attention")),
            (f"fzoo({Z_FZOO_SEEDS})",
             lambda: zo.fzoo(lr=LR, eps=EPS, batch_seeds=Z_FZOO_SEEDS,
                             backend="pallas"),
             ("zo_affine_batched", "zo_affine_chain", "flash_attention"))):
        _build.reset_launch_counts()
        ws = workers(mk)
        run_sync_equivalent(ws, shard)
        torch.cuda.synchronize()
        add_counts(counts, _build, req,
                   f"(z) one async round on pallas, {what}")
        if any(not same_trees(w.params, ws[0].params) for w in ws[1:]) or \
                same_trees(ws[0].params, params0):
            fail(f"(z) one staleness-0 round on pallas, {what}: the workers "
                 "differ, or θ did not move")
        del ws
        log(f"(z) one staleness-0 round of {Z_WORKERS} workers on pallas, "
            f"{what}: θ bitwise equal across workers")

    # ---- a delayed schedule ------------------------------------------ #
    _build.reset_launch_counts()
    ws = workers(mezo, max_staleness=Z_DELAY_WINDOW)
    pending, every = [], []
    for _ in range(Z_ROUNDS):
        newly = []
        for w in ws:
            c = w.produce(shard(w.w, w.step))
            w.consume(c)                   # its own at once
            newly.append(c)
        for c in pending:                  # its peers' a round late
            for w in ws:
                if c.worker != w.w and not w.consume(c):
                    fail(f"(z) delayed: worker {w.w} refused {c}")
        pending = newly
        every += newly
    for c in pending:
        for w in ws:
            w.consume(c)
    late = AsyncZOWorker(0, Z_WORKERS, params0, loss_fn, mezo(),
                         base_seed=SEED, max_staleness=Z_DELAY_WINDOW)
    for _ in range(Z_ROUNDS):
        late.produce(shard(0, late.step))
    kept = _clone_tree(late.params)
    dropped = not late.consume(every[1])
    torch.cuda.synchronize()
    add_counts(counts, _build, ("zo_affine_threefry", "flash_attention"),
               "(z) the delayed schedule")
    if not dropped or not same_trees(late.params, kept) or \
            every[1].step + Z_DELAY_WINDOW >= late.step:
        fail(f"(z) a step-{every[1].step} contribution at step {late.step} "
             f"(window {Z_DELAY_WINDOW}) was applied")
    del late, kept
    if any(len(w.applied) != Z_WORKERS * Z_ROUNDS for w in ws):
        fail("(z) delayed: a worker did not apply every contribution")
    delay_bound = Z_DELAY_ULPS_PER_APPLY * Z_WORKERS * Z_ROUNDS
    worst, worst_abs, n_equal = 0.0, 0.0, 0
    for w in ws[1:]:
        if same_trees(w.params, ws[0].params):
            n_equal += 1
            continue
        u, mx = worst_ulps(w.params, ws[0].params)
        worst, worst_abs = max(worst, u), max(worst_abs, mx)
    if worst > delay_bound:
        fail(f"(z) delayed: the workers differ by {worst} bf16 ulps > the "
             f"bound {delay_bound}")
    del ws
    log(f"(z) delayed schedule, {Z_ROUNDS} rounds (a worker's own "
        f"contribution at once, its peers' a round late, max_staleness "
        f"{Z_DELAY_WINDOW}, then all delivered): against worker 0, "
        f"{n_equal} of {Z_WORKERS - 1} workers bitwise, max {worst:.2f} bf16 "
        f"ulps at |θ| + ε·{Z_MAX} (bound {delay_bound:.0f}), max abs "
        f"{worst_abs:.3e}; a step-{every[1].step} contribution reaching a "
        f"worker at step {Z_ROUNDS} is dropped (θ bitwise unchanged)")

    # ---- 5. shard hints at full width -------------------------------- #
    seen: list = []
    inner = make_activation_resolver(mesh, cfg)

    def resolver(logical, shape):
        seen.append(logical)
        return inner(logical, shape)

    logits_of = b.train_logits_fn()
    _build.reset_launch_counts()
    with torch.no_grad():
        plain = logits_of(params0, batch0)
        with common.shard_resolver(resolver):
            hinted = logits_of(params0, batch0)
    torch.cuda.synchronize()
    add_counts(counts, _build, ("flash_attention",),
               "(z) the forwards with and without the resolver")
    want = (["act_btd"] + ["act_heads", "act_kv_heads", "act_ff",
                           "act_btd"] * cfg.n_layers + ["act_vocab"])
    if not same_bits(plain, hinted) or seen != want:
        fail(f"(z) the activation resolver: logits bitwise "
             f"{same_bits(plain, hinted)}, consulted {len(seen)} times "
             f"(JAX's sequence: {len(want)})")
    del plain, hinted
    log(f"(z) make_activation_resolver over the card's mesh: the logits "
        f"({TRAIN_BATCH} × {TRAIN_SEQ} × {cfg.padded_vocab}) bitwise those "
        f"without it; consulted {len(seen)} times = 2 + 4 · {cfg.n_layers}, "
        "in JAX's order (tests/test_torch_shard_hints.py)")


# --------------------------------------------------------------------------- #
# (dr) the dry run against the card, then the five examples
# --------------------------------------------------------------------------- #
DR_CELL = ("smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
DR_TIMED_STEPS = 3
DR_CARD_GIB = 79.18         # an H100 80GB HBM3's memory as torch reports it
#: the card's max_memory_allocated over a step may reach this many times
#: the dry run's argument + output + temp bytes, and no more
DR_MEMORY_FACTOR = 1.0


def _dr_against_a_step(torch, np, _build, counts, step_ms, card, backend,
                       overrides, kernels) -> None:
    """The dry run of qwen2-0.5b's spsa step (16 × 256, one rank) against
    the same step on the card: hard checks on the charges, the argument
    bytes and the roofline; the rest recorded."""
    from repro_torch import exec as zexec
    from repro_torch import zo
    from repro_torch.launch import dryrun
    from repro_torch.models import ShapeCell, all_archs, bundle
    from repro_torch.perturb.stream import prng_key
    from repro_torch.tree_utils import tree_leaves
    cell = ShapeCell(*DR_CELL)
    rec = dryrun.run_case("qwen2-0.5b", cell, None, "single-1x1", overrides,
                          backend=backend, verbose=False)
    if rec["status"] != "ok":
        fail(f"(dr) the dry run on {backend}: {rec['error']}")
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(**overrides)
    b = bundle(cfg)
    params = b.init(0, device="cuda")
    batch = b.make_batch(prng_key(SEED), TRAIN_BATCH, TRAIN_SEQ,
                         device="cuda")
    prog = zexec.StepProgram(zo.mezo(lr=1e-6, eps=1e-3, backend=backend),
                             zexec.local())
    state = prog.init(seed=0)
    step = prog.step_fn(b.loss_fn())
    params, state, _ = step(params, state, batch)          # the warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with costs.counting() as real:
        params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    got = dict(_build.launch_counts)
    add_counts(counts, _build, kernels, f"(dr) one spsa step on {backend}")
    charged = rec["kernels"]
    if {k for k, v in got.items() if v} != set(charged):
        fail(f"(dr) {backend}: kernels launched {got}, charged {charged}")
    for k in kernels:
        want = got[k]
        if k == "zo_affine_threefry" and want != real.calls[k]:
            log(f"(dr) X1: {want} launches over {real.calls[k]} wrapper "
                "calls; the charges are held to the calls")
            want = real.calls[k]
        if charged[k]["calls"] != want:
            fail(f"(dr) {backend}: {k} charged {charged[k]['calls']} times "
                 f"by the dry run, {want} on the card")
    if real.as_dict() != charged:
        fail(f"(dr) {backend}: the card step's charges {real.as_dict()} != "
             f"the dry run's {charged}")
    arg = sum(t.numel() * t.element_size() for t in tree_leaves(params)) \
        + sum(t.numel() * t.element_size() for t in batch.values())
    dry_arg = rec["memory_analysis"]["argument_size_in_bytes"]
    if arg != dry_arg:
        fail(f"(dr) {backend}: the step holds {arg} argument bytes, the dry "
             f"run reckons {dry_arg}")
    times = []
    for _ in range(DR_TIMED_STEPS):
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    measured = float(np.median(times))
    if measured < rec["step_s"]:
        fail(f"(dr) {backend}: a step took {measured:.6f} s, below the dry "
             f"run's roofline {rec['step_s']:.6f} s")
    step_ms[f"dr_{backend}"] = 1e3 * measured
    dry_peak = rec["memory_analysis"]["peak_bytes"]
    mem = rec["memory_analysis"]
    dry_total = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                 + mem["temp_size_in_bytes"])
    if peak + base > DR_MEMORY_FACTOR * dry_total:
        fail(f"(dr) {backend}: max_memory_allocated over the step "
             f"{(peak + base) / 2**30:.3f} GiB is past {DR_MEMORY_FACTOR} × "
             f"the dry run's argument + output + temp bytes "
             f"({dry_total / 2**30:.3f} GiB)")
    log(f"(dr) {backend}: max_memory_allocated over the step "
        f"{(peak + base) / 2**30:.3f} GiB = {(peak + base) / dry_total:.3f} × "
        f"the dry run's argument + output + temp "
        f"({mem['argument_size_in_bytes'] / 2**30:.3f} + "
        f"{mem['output_size_in_bytes'] / 2**30:.3f} + "
        f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB; limit "
        f"{DR_MEMORY_FACTOR}); above the arguments the card "
        f"{peak / 2**30:.3f} GiB against temp "
        f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB "
        f"({peak / mem['temp_size_in_bytes']:.3f}×) — on {card}")
    log(f"(dr) qwen2-0.5b spsa on {backend} (16 × 256, one rank): charges "
        f"{ {k: v['calls'] for k, v in charged.items()} } = the card's "
        f"launches {({k: got[k] for k in kernels})}; argument bytes {arg} = "
        f"the dry run's; step {1e3 * measured:.2f} ms (median of "
        f"{DR_TIMED_STEPS}, each {', '.join(f'{1e3 * t:.2f}' for t in times)}"
        f") ≥ roofline {1e3 * rec['step_s']:.4f} ms ({rec['bottleneck']}: "
        f"compute {1e3 * rec['compute_s']:.4f}, memory "
        f"{1e3 * rec['memory_s']:.4f} ms), {rec['step_s'] / measured:.3f} of "
        f"it reached; model_flops / (989e12 × measured) = "
        f"{rec['model_flops'] / (989e12 * measured):.4f}; useful_ratio "
        f"{rec['useful_ratio']:.4f}; the dry run's peak above the arguments "
        f"{dry_peak / 2**30:.3f} GiB against max_memory_allocated over the "
        f"step {peak / 2**30:.3f} GiB ({peak / max(dry_peak, 1):.3f}×); "
        f"trace {rec['compile_s']:.2f} s — on {card}")
    del params, batch, state


def _dr_cli(torch, runs: list) -> list:
    """Each argument list through ``python -m repro_torch.launch.dryrun``
    in a subprocess that sees no card, all started together (each traces
    on one host core); the records of each.  Every case must trace
    ``ok``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, args in enumerate(runs):
        out = RUN_DIR / f"dryrun_{i}.jsonl"
        out.unlink(missing_ok=True)
        procs.append((args, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    results = []
    for args, out, proc in procs:
        text, _ = proc.communicate(timeout=300)
        recs = ([json.loads(line) for line in out.read_text().splitlines()]
                if out.exists() else [])
        if proc.returncode not in (0, 1) or not recs or \
                (proc.returncode == 1) == all(x["status"] == "ok"
                                              for x in recs):
            fail(f"(dr) dryrun {' '.join(args)} exited {proc.returncode}:"
                 f"\n{text[-3000:]}")
        for r in recs:
            if r["status"] != "ok":
                fail(f"(dr) dryrun {r['arch']} {r['cell']} on {r['mesh']} "
                     f"under torch {torch.__version__}: "
                     f"{r['error'][-1500:]}")
        results.append(recs)
    return results


def _dr_status(r: dict) -> str:
    return ("ok" if r["status"] == "ok" else
            f"error ({r['error'][-600:]})")


def _dr_examples(torch, _build, counts, card) -> None:
    """The five examples on the card at small sizes, each to its end with
    its kernels launched: X1 in each, K12 where serve_batch decodes through
    the paged engine; train_100m's frozen-row probe under a sub-leaf
    ``rows(...)`` selection, its X1 launches off the vector route counted
    under ``X1_ROWS_EXAMPLE``."""
    import contextlib
    import io
    from repro_torch.examples import (mezo_peft, nondiff_accuracy,
                                      quickstart, serve_batch, train_100m)
    ckpt = RUN_DIR / "dr_train_100m"
    shutil.rmtree(ckpt, ignore_errors=True)
    mezo_peft.STEPS = 20
    nondiff_accuracy.STEPS = 20
    runs = (
        ("quickstart", lambda: quickstart.main(["--steps", "40"]),
         ("zo_affine_threefry",), "FT(Adam) accuracy after 20 steps"),
        ("mezo_peft", lambda: mezo_peft.main([]), ("zo_affine_threefry",),
         "base tree bitwise-frozen by the selection"),
        ("nondiff_accuracy", lambda: nondiff_accuracy.main([]),
         ("zo_affine_threefry",), "final accuracy: "),
        ("serve_batch", lambda: serve_batch.main([]),
         ("zo_affine_threefry", "paged_gather"), "ledger records replayed"),
        # its sub-leaf rows(...) selection: X1's bands route (and the
        # scalar one) beside the vector route, tallied apart
        ("train_100m", lambda: train_100m.main(
            ["--smoke", "--steps", "20", "--select", "rows(block=16,k=4)",
             "--ckpt-dir", str(ckpt)]), ("zo_affine_threefry",),
         "frozen-row probe: 49200 unselected elements"))
    for name, run, kernels, line in runs:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        torch.cuda.synchronize()
        out = buf.getvalue()
        if line not in out:
            fail(f"(dr) example {name}: no line {line!r} in\n{out[-2000:]}")
        if name == "train_100m":
            x1 = {r: _build.route_counts.get(f"zo_affine_threefry/{r}", 0)
                  for r in ("vector", "scalar", "bands")}
            if x1["bands"] == 0 or sum(x1.values()) != \
                    _build.launch_counts["zo_affine_threefry"]:
                fail(f"(dr) example train_100m under rows(block=16,k=4): "
                     f"X1 launches by route {x1} — its sub-leaf rows take "
                     "the bands route")
            counts[X1_ROWS_EXAMPLE] = x1["scalar"] + x1["bands"]
        add_counts(counts, _build, kernels, f"(dr) example {name}")
        log(f"(dr) example {name} on the card: ran to its end in "
            f"{time.perf_counter() - t0:.1f} s; its last line: "
            f"{out.strip().splitlines()[-1]!r} — on {card}")
    shutil.rmtree(ckpt, ignore_errors=True)


def dryrun_paths(torch, np, _build, counts, step_ms, card) -> None:
    """(dr) ``launch.dryrun`` against the card: qwen2-0.5b's spsa step at
    full width and depth, 16 × 256 on one rank, for ``pallas`` with
    ``pallas_flash`` (K1, K2) and for ``xla`` (X1) — the charges equal the
    card's launches, the argument bytes equal θ's and the batch's, the
    measured step is not below the roofline; the CLI in a subprocess that
    sees no card (opt-66b ``train_4k`` on 1 × 2 and 1 × 1, qwen2-7b on the
    single-pod mesh); then the five examples on the card."""
    t0 = time.perf_counter()
    _dr_against_a_step(torch, np, _build, counts, step_ms, card, "pallas",
                       {"attention_impl": "pallas_flash"},
                       ("zo_affine", "flash_attention"))
    free_card(torch, "(dr) pallas's trees")
    _dr_against_a_step(torch, np, _build, counts, step_ms, card, "xla", {},
                       ("zo_affine_threefry",))
    free_card(torch, "(dr) xla's trees")
    t1 = time.perf_counter()
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    shapes = ("1,2", "1,1")
    *opt66b, recs = _dr_cli(torch, [
        ["--arch", "opt-66b", "--cell", "train_4k", "--mesh-shape", shape]
        for shape in shapes] + [["--arch", "qwen2-7b", "--mesh", "single"]])
    for shape, (r,) in zip(shapes, opt66b):
        mem = r["memory_analysis"]
        args = mem["argument_bytes"]
        text = (f"(dr) opt-66b train_4k, mesh {shape}: per-rank argument "
                f"bytes {mem['argument_size_in_bytes'] / 2**30:.2f} GiB (θ "
                f"{args['params'] / 2**30:.2f}, batch "
                f"{args['batch'] / 2**20:.2f} MiB) against the card's "
                f"{DR_CARD_GIB} GiB; trace {_dr_status(r)}")
        if r["status"] == "ok":
            text += (f", {r['compile_s']} s; peak above the arguments "
                     f"{mem['peak_bytes'] / 2**30:.2f} GiB; roofline step "
                     f"{r['step_s']:.3f} s ({r['bottleneck']}); "
                     f"{r['collectives']['total_count']} collectives "
                     f"({r['collectives']['total_bytes'] / 2**30:.2f} GiB)")
        log(text)
    log("(dr) qwen2-7b on the single-pod (16, 16) mesh: " + "; ".join(
        f"{r['cell']} {_dr_status(r)}" + (
            f", trace {r['compile_s']} s, roofline step {r['step_s']:.4f} s "
            f"({r['bottleneck']}), useful {r['useful_ratio']:.3f}, "
            f"{r['collectives']['total_count']} collectives"
            if r["status"] == "ok" else "") for r in recs))
    log(f"(dr) the dry-run CLI took {time.perf_counter() - t1:.1f} s (its "
        f"three runs at once)")
    t2 = time.perf_counter()
    _dr_examples(torch, _build, counts, card)
    log(f"(dr) the examples took {time.perf_counter() - t2:.1f} s; the "
        f"phase {time.perf_counter() - t0:.1f} s — on {card}")


# --------------------------------------------------------------------------- #
# (tp) tensor parallelism: the z kernels on shards, K2 on local heads, and
# the step over two processes on the one card
# --------------------------------------------------------------------------- #
#: (1, model) meshes whose shards phase (tp) holds the z kernels on
TP_MODEL_SIZES = (2, 4)
#: |ℓ_TP − ℓ_one| allowed for a bf16 qwen2-0.5b forward split over two
#: ranks: the row-parallel products sum their bf16 partial outputs across
#: ranks in another order than one matmul accumulates them.  About 5× the
#: largest reading on the card (0.00061, PERF.md PR 31), below the ℓ+ − ℓ−
#: difference (≈ 0.0035) that g is made of
TP_LOSS_TOL = 0.003
#: max |Δ logit| allowed between the TP forward at θ₀ (gathered) and the
#: one-process forward, for the same reason: about 4× the reading on the
#: card (0.133 of logits up to 6.1, PERF.md PR 31), which a row-parallel
#: sum dropped in one layer exceeds (a mutation check, PERF.md PR 31)
TP_LOGIT_TOL = 0.5
TP_RANKS = 2
#: the (tp) rows of the kernels line (their launches the TP path's): the
#: routes' suffixes of the launch counts
TP_ROUTES = ("/shard", "/local_heads", "/share", "/shard/stacked",
             "/norm_share")

_TP_RANK = r"""
import json, sys, time
import torch
import torch.distributed as dist
rank, store, seed, rows, seq = (int(sys.argv[1]), sys.argv[2],
                                int(sys.argv[3]), int(sys.argv[4]),
                                int(sys.argv[5]))
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)


def synchronous_collectives(key="CUDA"):
    # NCCL takes one rank a card, so the two ranks talk over gloo; gloo's
    # CUDA work crashes (SIGSEGV, measured on this card's machine) when the
    # functional collectives that DTensor issues wait on it, while the same
    # collectives called through torch.distributed run.  So the functional
    # ops get kernels for `key` that call those, each complete on return
    # (its wait a no-op).
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

    def all_reduce(x, op, name):
        y = x.clone()
        dist.all_reduce(y, ops[op], group=_resolve_process_group(name))
        return y

    def all_gather(x, n, name):
        y = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(y, x.contiguous(),
                                    group=_resolve_process_group(name))
        return y

    def reduce_scatter(x, op, n, name):
        y = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(y, x.contiguous(), ops[op],
                                   group=_resolve_process_group(name))
        return y

    def broadcast(x, src, name):
        y = x.clone()
        dist.broadcast(y, group_src=src, group=_resolve_process_group(name))
        return y

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for op, fn in (("all_reduce", all_reduce),
                   ("all_gather_into_tensor", all_gather),
                   ("reduce_scatter_tensor", reduce_scatter),
                   ("broadcast", broadcast), ("wait_tensor", lambda t: t)):
        lib.impl(op, fn, key)
    return lib


_funcol_lib = synchronous_collectives()
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import exec as zexec
from repro_torch import zo
from repro_torch.device import host_f32
from repro_torch.distributed.collectives import mesh_loss
from repro_torch.distributed.sharding import place
from repro_torch.kernels import _build
from repro_torch.models import all_archs, bundle
from repro_torch.perturb.stream import prng_key
from repro_torch.tree_utils import tree_clone, tree_leaves

cfg = all_archs()["qwen2-0.5b"].cfg.replace(attention_impl="pallas_flash")
b = bundle(cfg)
params0 = b.init(seed, device="cuda")
batch = b.make_batch(prng_key(seed), rows, seq, device="cuda")
loss_fn = b.loss_fn()
mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))


def opt_of(backend):
    return zo.mezo(lr=1e-6, eps=1e-3, backend=backend)


def fzoo_of(backend, dist):
    return zo.fzoo(lr=1e-6, eps=1e-3, batch_seeds=4, dist=dist,
                   backend=backend)


def sp2(mesh=None):
    return zexec.seed_parallel(2, mesh=mesh)


# name -> (optimizer, plan, batch rows): the fzoo(4) steps (five forwards
# each) on the batch's first FZOO_ROWS rows, so their gathered logits stay
# a quarter of the spsa steps'
FZOO_ROWS = 4
cases = {"spsa_pallas": (lambda: opt_of("pallas"), zexec.local, rows),
         "spsa_xla": (lambda: opt_of("xla"), zexec.local, rows),
         "sp2_pallas": (lambda: opt_of("pallas"), sp2, rows),
         "fzoo4_pallas": (lambda: fzoo_of("pallas", "gaussian"), zexec.local,
                          FZOO_ROWS),
         "fzoo4_sphere_pallas": (lambda: fzoo_of("pallas", "sphere"),
                                 zexec.local, FZOO_ROWS),
         "fzoo4_sphere_xla": (lambda: fzoo_of("xla", "sphere"), zexec.local,
                              FZOO_ROWS)}


def same(a, c):
    w = torch.int16 if a.element_size() == 2 else torch.int32
    return a.shape == c.shape and torch.equal(a.view(w), c.view(w))


def window(x):
    # the slices of the whole leaf that DTensor x's local shard holds
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return tuple(slice(o, o + n) for o, n in zip(off, shape))


def same_shards(tree, mine):
    # every leaf's local shard bitwise this rank's slice of the one-process
    # leaf (``mine``: those slices)
    return all(same(x.to_local(), w) for x, w in zip(tree_leaves(tree), mine))


def one_process(name):
    # the case's one-process step, on every rank: this rank's slices of θ
    # at each loss evaluation, ℓ, of θ after, and g
    make, plan, n = cases[name]
    snaps, losses = [], []

    def rec(p, bt):
        loss = loss_fn(p, bt)
        snaps.append([x[w].clone() for x, w in zip(tree_leaves(p), wins)])
        losses.append(float(host_f32(loss)))
        return loss

    prog = zexec.StepProgram(make(), plan())
    p, _, m = prog.step_fn(rec)(tree_clone(params0),
                                prog.init(params0, seed=0), rows_of(n))
    return (snaps, losses, [x[w].clone() for x, w in zip(tree_leaves(p),
                                                         wins)],
            float(torch.as_tensor(m["projected_grad"]).reshape(-1)[0]))


def rows_of(n):
    return {k: v[:n] for k, v in batch.items()}

# the TP forward's logits at θ₀, gathered, against the one-process forward's
logits_fn = b.train_logits_fn()
with torch.no_grad():
    one = logits_fn(params0, batch).float()
    prog = zexec.StepProgram(opt_of("pallas"), zexec.local(mesh))
    placed = place(tree_clone(params0), prog.shardings(params0)[0])
    # this rank's window of each leaf (the placements every case's plan
    # gives θ)
    wins = [window(x) for x in tree_leaves(placed)]
    tp = mesh_loss(logits_fn, mesh)(placed, batch).full_tensor().float()
class Bytes(TorchDispatchMode):
    # the local collectives beneath DTensor: kind -> [count, bytes]
    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = torch.utils._pytree.tree_flatten((args, kwargs))[0]
        if any(hasattr(t, "placements") for t in flat):
            return NotImplemented
        res = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        if func.namespace in ("_c10d_functional", "c10d_functional") and \
                name not in ("wait_tensor", "_wrap_tensor_autograd"):
            outs = [t for t in torch.utils._pytree.tree_flatten(res)[0]
                    if isinstance(t, torch.Tensor)]
            c = self.seen.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += sum(t.numel() * t.element_size() for t in outs)
        return res


out = {"cases": {}, "logits_err": float((tp - one).abs().max()),
       "logits_scale": float(one.abs().max())}
del one, tp, placed
torch.cuda.synchronize()

_build.reset_launch_counts()
torch.cuda.reset_peak_memory_stats()
t_path = time.perf_counter()
for name, (make, plan, n) in cases.items():
    t_case = time.perf_counter()
    snaps, losses, after_one, g_one = one_process(name)
    prog = zexec.StepProgram(make(), plan(mesh))
    psh, _, _ = prog.shardings(params0)
    placed = place(tree_clone(params0), psh)
    seen, tp_losses = [], []

    def rec(p, bt):
        # the TP forward runs; the step goes on with the one-process ℓ, so
        # its update is written with the one-process g
        tp_losses.append(float(host_f32(loss_fn(p, bt))))
        j = len(seen)
        seen.append(same_shards(p, snaps[j]))
        return torch.tensor(losses[j])

    state = prog.init(params0, seed=0)
    if name != "spsa_pallas":
        p, _, m = prog.step_fn(rec)(placed, state, rows_of(n))
    else:
        # this step timed, its collectives counted (the two counting
        # modes' dispatch and the θ checks in ``rec`` inside the time)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with CommDebugMode() as comm, Bytes() as nbytes:
            p, _, m = prog.step_fn(rec)(placed, state, batch)
        torch.cuda.synchronize()
        out["step_ms"] = 1e3 * (time.perf_counter() - t0)
        out["comm_counts"] = {str(k): int(v)
                              for k, v in comm.get_comm_counts().items()}
        out["comm_bytes"] = nbytes.seen
    g_tp = float((tp_losses[0] - tp_losses[1]) / 2e-3) if len(
        tp_losses) == 2 else None
    out["cases"][name] = {
        "theta_pm_bitwise": all(seen), "evaluations": len(seen),
        "update_bitwise": same_shards(p, after_one),
        "loss_tp": tp_losses, "loss_one": losses,
        "dg": None if g_tp is None else abs(g_tp - g_one), "g_one": g_one,
        "sharded_leaves": sum(any(pl.is_shard() for pl in x.placements)
                              for x in tree_leaves(placed))}
    del p, placed, snaps, after_one
    torch.cuda.synchronize()
    out["cases"][name]["seconds"] = time.perf_counter() - t_case
out["path_s"] = time.perf_counter() - t_path
out["launches"] = {k: v for k, v in _build.launch_counts.items() if v}
out["routes"] = dict(_build.route_counts)
out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30


dist.barrier()
dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
"""


def _tp_windows(params, n: int, _build):
    """Every rank's shard window of each floating leaf under the rule
    engine's specs on a (1, n) mesh: [(leaf, [(slices, ShardMap)])], the
    replicated leaves left out."""
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.tree_utils import is_floating, tree_leaves

    class Mesh:
        shape = {"data": 1, "model": n}
        axis_names = ("data", "model")

    out = []
    for p, spec in zip(tree_leaves(params),
                       _dict_leaves(param_specs(params, Mesh()))):
        dims = [d for d, e in enumerate(spec) if e is not None]
        if not is_floating(p) or not dims:
            continue
        out.append((p, [_build.shard_window(p.shape, dims[0], n, r)
                        for r in range(n)]))
    return out


def tp_kernel_rows(torch, np, _build, params0, card) -> list:
    """(tp) (a) K1, K3 (2 seeds) and X1 (both layouts) on every rank's
    shard of qwen2-0.5b's leaves under the rule engine's specs on (1, 2)
    and (1, 4) meshes, bitwise their plain versions' shard writes and the
    slice of the whole-leaf launch, timed in turns (all shards' passes
    against the whole pass); (b) K2 on each rank's heads against its plain
    version on them and the same heads of the whole launch.  The rows of
    the kernels line for the shard routes and the local-head launch, their
    ``max_abs_err`` against the plain versions."""
    from repro_torch.kernels.flash_attention import kernel as kf
    from repro_torch.kernels.threefry import kernel as x1
    from repro_torch.kernels.zo_fused import kernel as kz
    from repro_torch.kernels.zo_fused import multi as km
    from repro_torch.perturb.xla import in_dtype
    t0 = time.perf_counter()
    seeds = [7, 2**31 + 5]
    a2, b2 = [1.0, 0.5], [1e-3, -2e-3]
    bf = torch.bfloat16
    sc = [in_dtype(v, bf) for v in (0.5, 1e-3, 2e-3)]
    key = (3, 2**32 - 7)

    def k1(x, out, shard=None):
        return kz.zo_affine(x, 11, 0.5, 1e-3, out=out, shard=shard)

    def k3(x, out, shard=None):
        return km.zo_affine_chain(x, seeds, a2, b2, out=out, shard=shard)

    def x1p(x, out, shard=None, total=None):
        return x1.zo_affine_threefry(x, key, "restore", *sc, out=out,
                                     shard=shard, total=total,
                                     partitionable=True)

    def x1o(x, out, shard=None, total=None):
        return x1.zo_affine_threefry(x, key, "restore", *sc, out=out,
                                     shard=shard, total=total,
                                     partitionable=False)

    def k1_plain(y, shard, total):
        return kz.zo_affine_plain(y, 11, 0.5, 1e-3, out=y, shard=shard)

    def k3_plain(y, shard, total):
        return km.zo_affine_chain_plain(y, seeds, a2, b2, out=y, shard=shard)

    def x1_plain(partitionable):
        return lambda y, shard, total: x1.zo_affine_threefry_plain(
            y, key, "restore", *sc, out=y, shard=shard, total=total,
            partitionable=partitionable)

    kernels = {"zo_affine": (k1, k1_plain), "zo_affine_chain": (k3, k3_plain),
               "zo_affine_threefry": (x1p, x1_plain(True)),
               "zo_affine_threefry_original": (x1o, x1_plain(False))}
    checked = {k: 0 for k in kernels}
    err = {k: 0.0 for k in kernels}
    # the plain versions' pass over both ranks' shards of qwen2's sharded
    # leaves on the (1, 2) mesh, timed on the host while they are checked
    plain_ms = {k: 0.0 for k in kernels}
    # beside qwen2's leaves, f32 and bf16 leaves of (6, 13, 20) cut on each
    # dim: shard rows of 7 × 20 or 5 elements, no whole 16-byte vectors of
    # bf16, take the shard routes' element-a-step walks
    g0 = torch.Generator(device="cuda").manual_seed(31)
    odd = [torch.randn(6, 13, 20, generator=g0, device="cuda").to(dt)
           for dt in (torch.float32, bf)]
    for n in TP_MODEL_SIZES:
        for timed, leaf, wins in [
                (n == TP_RANKS, *w) for w in _tp_windows(params0, n, _build)
        ] + [(False, x, [_build.shard_window(x.shape, d, n, r)
                         for r in range(n)]) for x in odd for d in range(3)]:
            for name, (fn, plain) in kernels.items():
                whole = fn(leaf, torch.empty_like(leaf))
                for sl, smap in wins:
                    loc = leaf[sl].contiguous()
                    extra = {} if name in ("zo_affine", "zo_affine_chain") \
                        else {"total": leaf.numel()}
                    got = fn(loc, torch.empty_like(loc), shard=smap, **extra)
                    box = []
                    ms = host_ms(lambda: box.append(
                        plain(loc.clone(), smap, leaf.numel())))
                    want = box[0]
                    plain_ms[name] += ms if timed else 0.0
                    if got.numel():          # a short leaf's last shards
                        err[name] = max(err[name], float(
                            (got.float() - want.float()).abs().max()))
                    if not same_bits(got, want):
                        fail(f"(tp) {name} on shard {sl} of a "
                             f"{tuple(leaf.shape)} leaf (model {n}) is not "
                             "its plain version's shard write bitwise (max "
                             f"abs err {err[name]})")
                    if not same_bits(got, whole[sl].contiguous()):
                        fail(f"(tp) {name} on shard {sl} of a "
                             f"{tuple(leaf.shape)} leaf (model {n}) is not "
                             "the slice of the whole-leaf launch")
                    checked[name] += 1
                    del got, want
                del whole
    log(f"(tp) (a) K1, K3 (2 seeds), X1 and X1 original on every rank's "
        f"shard of qwen2-0.5b's sharded leaves and of (6, 13, 20) f32 / bf16 "
        f"leaves cut on each dim, on (1, 2) and (1, 4) meshes: "
        f"bitwise their plain versions' shard writes and the whole-leaf "
        f"launch's slices ({checked} shards)")

    # timed in turns on the (1, 2) mesh: both ranks' shards of every
    # sharded leaf (the whole leaf once) against the whole-leaf pass
    wins = _tp_windows(params0, TP_RANKS, _build)
    n_el = sum(leaf.numel() for leaf, _ in wins)
    locs = [[(leaf[sl].contiguous(), smap) for sl, smap in ws]
            for leaf, ws in wins]
    leaves = [leaf.clone() for leaf, _ in wins]
    rows = []
    zf = "src/repro_torch/kernels/zo_fused/csrc/"
    tf = "src/repro_torch/kernels/threefry/csrc/zo_threefry.cu"
    for name, src, rep, work in (
            ("zo_affine", zf + "zo_affine.cu",
             "src/repro/kernels/zo_fused/kernel.py:233",
             costs.zo_affine(n_el, 2)),
            ("zo_affine_chain", zf + "zo_multi.cu",
             "src/repro/kernels/zo_fused/multi.py:137",
             costs.zo_affine_chain(n_el, 2, len(seeds))),
            ("zo_affine_threefry", tf, "src/repro/perturb/xla.py:38-325",
             costs.zo_affine_threefry(n_el, 2, "restore")),
            ("zo_affine_threefry_original", tf,
             "src/repro/perturb/xla.py:38-325",
             costs.zo_affine_threefry(n_el, 2, "restore"))):
        fn = kernels[name][0]
        extra = name.startswith("zo_affine_threefry")

        def shards(fn=fn, extra=extra):
            for (leaf, _), ls in zip(wins, locs):
                for loc, smap in ls:
                    fn(loc, loc, shard=smap,
                       **({"total": leaf.numel()} if extra else {}))

        def whole(fn=fn):
            for p in leaves:
                fn(p, p)

        t = run_ms({"shards": shards, "whole": whole}, 1, rounds=6,
                   graph=False)
        pms = plain_ms[name]
        bms, by = costs.bound_ms([work])
        rows.append({"name": f"{name}/shard", "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0, "max_abs_err": err[name],
                     "ms": t["shards"], "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
        log(f"(tp) {name} shard route, both ranks' shards of the {len(wins)}"
            f" sharded leaves ({n_el} elements, bf16) on a (1, 2) mesh: "
            f"{t['shards']:.3f} ms against the whole-leaf route's "
            f"{t['whole']:.3f} ms over the same leaves, in turns (6 rounds);"
            f" plain {pms:.1f} ms; bound {bms:.3f} ms ({by}) — on {card}")
    del locs, leaves

    # (b) K2 on each rank's heads at the training shape
    cfg_h, cfg_kv, hd = 14, 2, 64
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg_h, hd, generator=g,
                    device="cuda").to(bf)
    k = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg_kv, hd, generator=g,
                    device="cuda").to(bf)
    v = torch.randn_like(k)
    whole = kf.flash_attention(q, k, v)
    per_q, per_kv = cfg_h // TP_RANKS, cfg_kv // TP_RANKS
    parts = [tuple(t[:, :, r * w:(r + 1) * w].contiguous()
                   for t, w in ((q, per_q), (k, per_kv), (v, per_kv)))
             for r in range(TP_RANKS)]
    k2_err = 0.0
    for r, (ql, kl, vl) in enumerate(parts):
        # against the plain version on the same local heads, at K2's
        # tolerances (the kernel's bf16 P and exp2 are not the plain
        # version's), and bitwise against the whole launch's same heads
        k2_err = max(k2_err, _hold_k2(torch, kf, ql, kl, vl, 0,
                                      f"(tp) on rank {r}'s heads"))
        got = kf.flash_attention(ql, kl, vl)
        ref = whole[:, :, r * per_q:(r + 1) * per_q]
        if not same_bits(got, ref.contiguous()):
            fail(f"(tp) (b) K2 on rank {r}'s {per_q} q / {per_kv} KV heads "
                 f"differs from the whole launch's same heads by "
                 f"{float((got.float() - ref.float()).abs().max())}: each "
                 "(b, h) tile is computed alone, so the heads must agree "
                 "bitwise")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tparts = [tuple(t.transpose(1, 2) for t in pr) for pr in parts]

    def local():
        for ql, kl, vl in parts:
            kf.flash_attention(ql, kl, vl)

    def library():
        for ql, kl, vl in tparts:
            sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)

    t = run_ms({"kernel": local, "library": library}, RUN_N // 10)
    pms = run_ms({"plain": lambda: [kf.flash_attention_plain(*pr)
                                    for pr in parts]}, 2,
                 graph=False)["plain"]
    bms, by = costs.bound_ms([costs.flash_attention(
        TRAIN_BATCH, TRAIN_SEQ, per_q, per_kv, hd, 2)] * TP_RANKS)
    rows.append({"name": "flash_attention/local_heads", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
                 "launches": 0, "max_abs_err": k2_err, "ms": t["kernel"],
                 "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                 "library_ms": t["library"]})
    log(f"(tp) (b) K2 on each rank's heads ({TRAIN_BATCH}, {TRAIN_SEQ}, "
        f"{per_q} / {per_kv}, {hd}) bf16: within K2's tolerances of the "
        f"plain version on the same heads (max abs err {k2_err:.2e}), "
        f"bitwise the whole launch's same heads; both ranks' launches "
        f"{t['kernel']:.4f} ms, SDPA on the same local heads {t['library']:.4f} ms (in turns, CUDA graphs), plain "
        f"{pms:.2f} ms, bound {bms:.4f} ms ({by}); (a)+(b) "
        f"{time.perf_counter() - t0:.1f} s — on {card}")
    return rows


def tp_fanout_norm_rows(torch, np, _build, params0, card) -> list:
    """(tp) (a) continued: the fan-out K5 and K4 (2 streams) and X1's
    stacked streams (``perturb_many``'s writes) on every rank's shard of
    qwen2-0.5b's sharded leaves and of the (6, 13, 20) leaves on (1, 2)
    and (1, 4) meshes, bitwise their plain versions' ``shard=`` writes and
    the whole fan-out's slices, timed in turns against the whole pass on
    (1, 2); then the sphere's ‖z‖² over qwen2-0.5b's leaves split over
    P = 2 and 4 ranks — K6's ``share`` route and X1's chunk shares — every
    rank's fold bitwise the whole norm, K6's shares bitwise their plain
    version's, timed (rank 0's share on P = 2) in turns against the whole
    pass.  The kernels line's rows for the five routes."""
    from repro_torch.kernels.threefry import kernel as x1
    from repro_torch.kernels.zo_fused import kernel as kz
    from repro_torch.kernels.zo_fused import multi as km
    from repro_torch.perturb import xla as pxla
    from repro_torch.perturb.base import NormShare
    from repro_torch.perturb.stream import fold_in, leaf_seed
    from repro_torch.perturb.xla import in_dtype
    from repro_torch.tree_utils import is_floating, tree_leaves
    t0 = time.perf_counter()
    seeds = [7, 2**31 + 5]
    a2, b2 = [1.0, 0.5], [1e-3, -2e-3]
    keys = [(3, 2**32 - 7), (11, 5)]

    def x1s_into(x, out, shard, total, plain):
        for j, key in enumerate(keys):
            (x1.zo_affine_threefry_plain if plain else x1.zo_affine_threefry)(
                x, key, "xpbz", 0.0, in_dtype(b2[j], x.dtype), 0.0, None,
                "gaussian", out=out[j], shard=shard, total=total)
        return out

    kernels = {
        "zo_affine_batched/shard": (
            lambda x, shard=None, total=None: kz.zo_affine_batched(
                x, seeds, 1.0, 1e-3, shard=shard),
            lambda x, shard, total: kz.zo_affine_batched_plain(
                x, seeds, 1.0, 1e-3, shard=shard),
            "src/repro_torch/kernels/zo_fused/csrc/zo_multi.cu",
            "src/repro/kernels/zo_fused/kernel.py:283"),
        "zo_affine_multi/shard": (
            lambda x, shard=None, total=None: km.zo_affine_multi(
                x, seeds, a2, b2, shard=shard),
            lambda x, shard, total: km.zo_affine_multi_plain(
                x, seeds, a2, b2, shard=shard),
            "src/repro_torch/kernels/zo_fused/csrc/zo_multi.cu",
            "src/repro/kernels/zo_fused/multi.py:80"),
        "zo_affine_threefry/shard/stacked": (
            lambda x, shard=None, total=None: x1s_into(
                x, _build.empty_streams(x, 2), shard, total, False),
            lambda x, shard, total: x1s_into(
                x, _build.empty_streams(x, 2), shard, total, True),
            "src/repro_torch/kernels/threefry/csrc/zo_threefry.cu",
            "src/repro/perturb/xla.py:38-325")}
    checked = {k: 0 for k in kernels}
    err = {k: 0.0 for k in kernels}
    plain_ms = {k: 0.0 for k in kernels}
    g0 = torch.Generator(device="cuda").manual_seed(33)
    odd = [torch.randn(6, 13, 20, generator=g0, device="cuda").to(dt)
           for dt in (torch.float32, torch.bfloat16)]
    for n in TP_MODEL_SIZES:
        for timed, leaf, wins in [
                (n == TP_RANKS, *w) for w in _tp_windows(params0, n, _build)
        ] + [(False, x, [_build.shard_window(x.shape, d, n, r)
                         for r in range(n)]) for x in odd for d in range(3)]:
            for name, (fn, plain, _, _) in kernels.items():
                whole = fn(leaf)
                for sl, smap in wins:
                    loc = leaf[sl].contiguous()
                    got = fn(loc, shard=smap, total=leaf.numel())
                    box = []
                    ms = host_ms(lambda: box.append(
                        plain(loc, smap, leaf.numel())))
                    want = box[0]
                    plain_ms[name] += ms if timed else 0.0
                    if got.numel():
                        err[name] = max(err[name], float(
                            (got.float() - want.float()).abs().max()))
                    if not same_bits(got, want):
                        fail(f"(tp) {name} on shard {sl} of a "
                             f"{tuple(leaf.shape)} leaf (model {n}) is not "
                             "its plain version's shard write bitwise (max "
                             f"abs err {err[name]})")
                    if not same_bits(got, whole[(slice(None),) + sl]
                                     .contiguous()):
                        fail(f"(tp) {name} on shard {sl} of a "
                             f"{tuple(leaf.shape)} leaf (model {n}) is not "
                             "the slice of the whole fan-out")
                    checked[name] += 1
                    del got, want
                del whole
    log(f"(tp) (a) K5, K4 (2 streams) and X1's stacked streams on every "
        f"rank's shard of qwen2-0.5b's sharded leaves and of (6, 13, 20) "
        f"f32 / bf16 leaves cut on each dim, on (1, 2) and (1, 4) meshes: "
        f"bitwise their plain versions' shard writes and the whole "
        f"fan-out's slices ({checked} shards)")

    wins = _tp_windows(params0, TP_RANKS, _build)
    n_el = sum(leaf.numel() for leaf, _ in wins)
    locs = [[(leaf[sl].contiguous(), smap) for sl, smap in ws]
            for leaf, ws in wins]
    rows = []
    for name, (fn, _, src, rep) in kernels.items():
        def shards(fn=fn):
            for (leaf, _), ls in zip(wins, locs):
                for loc, smap in ls:
                    fn(loc, shard=smap, total=leaf.numel())

        def whole(fn=fn):
            for leaf, _ in wins:
                fn(leaf)

        t = run_ms({"shards": shards, "whole": whole}, 1, rounds=6,
                   graph=False)
        work = (costs.zo_affine_threefry(n_el, 2, "xpbz") if "threefry" in
                name else costs.zo_affine_fanout(n_el, 2, len(seeds)))
        bms, by = costs.bound_ms([work] * (len(keys) if "threefry" in name
                                           else 1))
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0, "max_abs_err": err[name],
                     "ms": t["shards"], "plain_ms": plain_ms[name],
                     "bound_ms": bms, "bound_by": by, "library_ms": None})
        log(f"(tp) {name}, both ranks' shards of the {len(wins)} sharded "
            f"leaves ({n_el} elements, bf16, 2 streams) on a (1, 2) mesh: "
            f"{t['shards']:.3f} ms against the whole fan-out's "
            f"{t['whole']:.3f} ms over the same leaves, in turns (6 rounds); "
            f"plain {plain_ms[name]:.1f} ms; bound {bms:.3f} ms ({by}) — on "
            f"{card}")
    del locs

    # the sphere's ‖z‖² split over P ranks: every rank's fold bitwise the
    # whole norm, on both streams
    leaves = [p for p in tree_leaves(params0) if is_floating(p)]
    ns = [p.numel() for p in leaves]
    kseeds = [leaf_seed(12345, i) for i in range(len(leaves))]
    xl = [(p, fold_in((9, 2**32 - 9), i), None) for i, p in enumerate(leaves)]
    whole_k6 = km.zo_sqnorm_many(ns, kseeds, "gaussian", "cuda")
    whole_x1 = [pxla.leaf_sqnorm(*leaf) for leaf in xl]
    tiles = sum(-(-n // km.TILE_ELEMS) for n in ns)
    chunks = [(k, c0, c1) for k, p in enumerate(leaves)
              for c0, c1 in pxla._chunks([(0, p.numel())])]

    def x1_plain_sums(c_lo, c_hi):
        # X1's plain z over chunks [c_lo, c_hi), each summed as the share
        # route sums it: the plain version of that rank's share
        sums = torch.zeros(c_hi - c_lo, dtype=torch.float64, device="cuda")
        for slot, (k, c0, c1) in enumerate(chunks[c_lo:c_hi]):
            p, key, _ = xl[k]
            sums[slot] = pxla._chunk_sum(x1.zo_affine_threefry_plain(
                None, key, "z", out=torch.empty(c1 - c0, dtype=p.dtype,
                                                device="cuda"),
                offset=c0, total=p.numel()))
        return sums

    k6_err, k6_plain_ms, shared = 0.0, 0.0, {}
    x1_err, x1_plain_ms = 0.0, 0.0
    for parts in TP_MODEL_SIZES:
        mine_k6, mine_x1 = [], []
        for r in range(parts):
            # first pass: keep each rank's share; the stand-in gather's
            # fold is thrown away
            km.zo_sqnorm_many(ns, kseeds, "gaussian", "cuda", (
                r, parts, lambda t: mine_k6.append(t.clone()) or t.repeat(
                    parts)))
            pxla._shared_sqnorms(xl, NormShare(r, parts, lambda t: (
                mine_x1.append(t.clone()) or t.repeat(parts))))
            lo, hi = _build.share_range(tiles, r, parts)
            box = []
            ms = host_ms(lambda: box.append(km.share_sums_plain(
                ns, kseeds, "gaussian", "cuda", lo, hi)))
            k6_plain_ms += ms if (parts == TP_RANKS and r == 0) else 0.0
            k6_err = max(k6_err, float((mine_k6[r][:hi - lo] - box[0])
                                       .abs().max()) if hi > lo else 0.0)
            if not same_bits(mine_k6[r][:hi - lo], box[0]):
                fail(f"(tp) K6's share {r} of {parts} is not its plain "
                     f"version's tile sums bitwise (max abs err {k6_err})")
            c_lo, c_hi = _build.share_range(len(chunks), r, parts)
            box = []
            ms = host_ms(lambda: box.append(x1_plain_sums(c_lo, c_hi)))
            x1_plain_ms += ms if (parts == TP_RANKS and r == 0) else 0.0
            x1_err = max(x1_err, float((mine_x1[r][:c_hi - c_lo] - box[0])
                                       .abs().max()) if c_hi > c_lo else 0.0)
            if not same_bits(mine_x1[r][:c_hi - c_lo], box[0]):
                fail(f"(tp) X1's chunk share {r} of {parts} is not its plain "
                     f"version's chunk sums bitwise (max abs err {x1_err})")
        every_k6, every_x1 = torch.cat(mine_k6), torch.cat(mine_x1)
        shared[parts] = (every_k6, every_x1)
        for r in range(parts):
            got = km.zo_sqnorm_many(ns, kseeds, "gaussian", "cuda",
                                    (r, parts, lambda t: every_k6))
            if not same_bits(got, whole_k6):
                fail(f"(tp) K6's shares folded on rank {r} of {parts} differ "
                     f"from the whole norm: {got.tolist()} against "
                     f"{whole_k6.tolist()}")
            got_x1 = pxla._shared_sqnorms(xl, NormShare(r, parts,
                                                        lambda t: every_x1))
            if [v.tobytes() for v in got_x1] != [v.tobytes()
                                                 for v in whole_x1]:
                fail(f"(tp) X1's chunk shares folded on rank {r} of {parts} "
                     f"differ from the whole norm: {got_x1} against "
                     f"{whole_x1}")
    log(f"(tp) (a) the sphere's ‖z‖² over qwen2-0.5b's {len(leaves)} leaves "
        f"({tiles} K6 tiles) split over P = {TP_MODEL_SIZES} ranks: every "
        "rank's fold bitwise the whole norm on both streams, K6's shares "
        "bitwise their plain version's tile sums, X1's bitwise their plain "
        "version's chunk sums")

    # rank 0's share on P = 2 against the whole pass, in turns
    every_k6, every_x1 = shared[TP_RANKS]
    lo, hi = _build.share_range(tiles, 0, TP_RANKS)
    n_share = km._share_elems(ns, lo, hi)
    c_lo, c_hi = _build.share_range(len(chunks), 0, TP_RANKS)
    x1_share = sum(c1 - c0 for _, c0, c1 in chunks[c_lo:c_hi])
    t = run_ms({
        "k6_share": lambda: km.zo_sqnorm_many(
            ns, kseeds, "gaussian", "cuda", (0, TP_RANKS, lambda t: every_k6)),
        "k6_whole": lambda: km.zo_sqnorm_many(ns, kseeds, "gaussian",
                                              "cuda"),
        "x1_share": lambda: pxla._shared_sqnorms(xl, NormShare(
            0, TP_RANKS, lambda t: every_x1)),
        "x1_whole": lambda: [pxla.leaf_sqnorm(*leaf) for leaf in xl]},
        1, rounds=6, graph=False)
    for name, ms, pms, err, work, src, rep in (
            ("zo_sqnorm/share", t["k6_share"], k6_plain_ms, k6_err,
             costs.zo_sqnorm(n_share),
             "src/repro_torch/kernels/zo_fused/csrc/zo_sqnorm.cu",
             "src/repro/kernels/zo_fused/multi.py:200"),
            ("zo_affine_threefry/norm_share", t["x1_share"], x1_plain_ms,
             x1_err, costs.zo_affine_threefry(x1_share, 2, "z"),
             "src/repro_torch/kernels/threefry/csrc/zo_threefry.cu",
             "src/repro/perturb/xla.py:38-325")):
        bms, by = costs.bound_ms(work)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0,
                     "max_abs_err": err,
                     "ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None})
    log(f"(tp) K6 share route, rank 0's share ({hi - lo} of {tiles} tiles, "
        f"{n_share} elements) of qwen2-0.5b's norm on P = {TP_RANKS}: "
        f"{t['k6_share']:.3f} ms against the whole norm's "
        f"{t['k6_whole']:.3f} ms, in turns; plain {k6_plain_ms:.1f} ms; X1's "
        f"chunk share ({c_hi - c_lo} of {len(chunks)} chunks, {x1_share} "
        f"elements) {t['x1_share']:.3f} ms against the whole "
        f"{t['x1_whole']:.3f} ms, plain {x1_plain_ms:.1f} ms; (a) fan-outs "
        f"and norms {time.perf_counter() - t0:.1f} s — on {card}")
    return rows


def hold_grouped_products(torch, card) -> None:
    """(tp) attention's grouped products (``models.attention``'s bmm form,
    which a DTensor's (b, k) batch needs) bitwise the einsums they replace,
    on plain tensors at every registry arch's heads: training (16, 256),
    decode (Q 1 over 512 keys) and (2, 64 over 1 024), f32 / bf16 / f16."""
    from repro_torch.models import all_archs
    from repro_torch.models.attention import (_grouped_scores,
                                              _grouped_values)
    g = torch.Generator(device="cuda").manual_seed(32)
    heads = sorted({(a.cfg.n_heads, a.cfg.kv_heads, a.cfg.hd)
                    for a in all_archs().values() if a.cfg.n_heads})
    n = 0
    for H, KV, hd in heads:
        for B, Q, S in ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ), (8, 1, 512),
                        (2, 64, 1024)):
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                q = torch.randn(B, Q, KV, H // KV, hd, generator=g,
                                device="cuda").to(dt)
                k, v = (torch.randn(B, S, KV, hd, generator=g,
                                    device="cuda").to(dt) for _ in range(2))
                s = torch.einsum("bqkgh,bskh->bkgqs", q, k)
                w = torch.softmax(s.float(), -1).to(dt)
                o = torch.einsum("bkgqs,bskh->bqkgh", w, v)
                if not (same_bits(_grouped_scores(q, k), s)
                        and same_bits(_grouped_values(w, v), o)):
                    fail(f"(tp) attention's bmm form differs from the einsum "
                         f"at ({B}, {Q}, {S}) heads {H} / {KV} × {hd} {dt}")
                n += 1
    log(f"(tp) attention's grouped products bitwise the einsums in {n} cases "
        f"({len(heads)} head configs of the registry) — on {card}")


def tensor_parallel_paths(torch, np, _build, counts, step_ms, card) -> list:
    """(tp) Tensor parallelism at qwen2-0.5b's full width and depth (bf16,
    random weights from seed 0, ``pallas_flash``): (a) and (b) of
    ``tp_kernel_rows``; (c) two processes on the one card over gloo on a
    (1, 2) ``data × model`` mesh, θ as DTensors under ``param_shardings``,
    one spsa step on ``pallas`` (K1 on shards, K2 on local heads), one on
    ``xla`` (X1 on shards) and one ``seed_parallel(2)`` step on ``pallas``
    (K3 on shards), each against the one-process step from the same θ₀:
    θ at every loss evaluation gathered and held bitwise, the update
    written with the one-process ℓ (so its g) held bitwise, ℓ± within
    ``TP_LOSS_TOL``, |Δg| recorded, the logits at θ₀ within
    ``TP_LOGIT_TOL``; the ``pallas`` spsa step timed and its collectives
    counted by kind and bytes; each rank's peak.
    Returns the kernels line's rows for the shard routes and K2's local
    heads, their launches the main path's (both ranks')."""
    from repro_torch.models import all_archs, bundle
    t_phase = time.perf_counter()
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(attention_impl="pallas_flash")
    params0 = bundle(cfg).init(SEED, device="cuda")
    rows = tp_kernel_rows(torch, np, _build, params0, card)
    rows += tp_fanout_norm_rows(torch, np, _build, params0, card)
    hold_grouped_products(torch, card)
    del params0
    free_card(torch, "(tp) the kernel checks' trees")

    RUN_DIR.mkdir(parents=True, exist_ok=True)
    store = RUN_DIR / "tp_filestore"
    store.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-X", "faulthandler", "-c", _TP_RANK, str(r),
         str(store), str(SEED), str(TRAIN_BATCH), str(TRAIN_SEQ)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(TP_RANKS)]
    outs, texts = [], []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=600)
            texts.append((p.returncode, text))
        for r, (code, text) in enumerate(texts):
            if code != 0 or "RESULT " not in text:
                fail(f"(tp) rank {r} exited {code}:\n" + "\n".join(
                    f"--- rank {i} (exit {c}):\n{t[-3000:]}"
                    for i, (c, t) in enumerate(texts)))
            outs.append(json.loads(text.split("RESULT ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        store.unlink(missing_ok=True)
    for r, res in enumerate(outs):
        for name, c in res["cases"].items():
            if not (c["theta_pm_bitwise"] and c["update_bitwise"]):
                fail(f"(tp) rank {r} {name}: θ at the loss evaluations "
                     f"bitwise {c['theta_pm_bitwise']}, the update written "
                     f"with the one-process g bitwise {c['update_bitwise']}")
            if not c["evaluations"] == len(c["loss_one"]) == len(
                    c["loss_tp"]) > 0:
                fail(f"(tp) rank {r} {name}: {c['evaluations']} θ checks and "
                     f"{len(c['loss_tp'])} TP losses against the one-process "
                     f"step's {len(c['loss_one'])} loss evaluations")
            dl = max(abs(a - b) for a, b in zip(c["loss_tp"], c["loss_one"]))
            if dl > TP_LOSS_TOL or c["sharded_leaves"] == 0:
                fail(f"(tp) rank {r} {name}: |Δℓ| {dl} past {TP_LOSS_TOL} "
                     f"({c['sharded_leaves']} sharded leaves)")
        if not res["logits_err"] <= TP_LOGIT_TOL:
            fail(f"(tp) rank {r}: the TP forward's logits at θ₀ differ from "
                 f"the one-process forward's by {res['logits_err']}, past "
                 f"{TP_LOGIT_TOL} (their scale {res['logits_scale']})")
    launches: dict = {}
    for res in outs:
        for k, v in list(res["launches"].items()) + list(
                res["routes"].items()):
            launches[k] = launches.get(k, 0) + v
    need = {"zo_affine/shard": "K1", "zo_affine_chain/shard": "K3",
            "zo_affine_threefry/shard": "X1",
            "flash_attention/local_heads": "K2",
            "zo_affine_batched/shard": "K5", "zo_affine_multi/shard": "K4",
            "zo_sqnorm/share": "K6's share",
            "zo_affine_threefry/shard/stacked": "X1's stacked streams",
            "zo_affine_threefry/norm_share": "X1's norm share"}
    for k, what in need.items():
        if launches.get(k, 0) <= 0:
            fail(f"(tp) {what} ({k}) never launched on the TP path")
    for k, v in launches.items():
        counts[k] = counts.get(k, 0) + v
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
    step_ms["tp_pallas"] = outs[0]["step_ms"]
    c0 = outs[0]["cases"]
    log("(tp) (c) two ranks over gloo on the one card, (1, 2) mesh, "
        f"qwen2-0.5b bf16 {TRAIN_BATCH} × {TRAIN_SEQ}: " + "; ".join(
            f"{name}: θ± and the update bitwise, ℓ TP {c['loss_tp']} vs one "
            f"process {c['loss_one']}, |Δg| "
            + ("n/a" if c["dg"] is None else f"{c['dg']:.4g}")
            + f" (g {c['g_one']:.4g}), {c['sharded_leaves']} sharded leaves, "
            f"{c['seconds']:.1f} s with its one-process step"
            for name, c in c0.items()))
    log("(tp) (c) the TP forward's logits at θ₀ (gathered) against the "
        "one-process forward's: max |Δ| "
        f"{[o['logits_err'] for o in outs]} by rank, bound {TP_LOGIT_TOL}; "
        f"their scale {outs[0]['logits_scale']}")
    log(f"(tp) (c) the TP spsa step on pallas: "
        f"{[round(o['step_ms'], 2) for o in outs]} ms by rank (its "
        "collectives counted and its θ checked meanwhile; two processes "
        "share the card's SMs, gloo moves every collective through the "
        "host); collectives of the step: "
        f"{outs[0]['comm_counts']}, bytes by kind {outs[0]['comm_bytes']}; "
        f"peaks {[round(o['peak_gib'], 3) for o in outs]} GiB; launches "
        f"{ {k: v for k, v in launches.items() if '/' in k} }; the ranks "
        f"took {time.perf_counter() - t1:.1f} s — on {card}")
    log(f"(tp) the phase took {time.perf_counter() - t_phase:.1f} s — on "
        f"{card}")
    return rows


def run_family_phases(torch, np, kf, _build, counts, step_ms, card,
                      which, rows: list) -> None:
    """The phases named in ``which`` (u: hymba-1.5b, t: mixtral-8x7b, w:
    whisper-large-v3, x: multi-tenant LoRA serving on qwen2-0.5b, y: the
    deprecated shims and the functional primitives on qwen2-0.5b, z:
    distribution on qwen2-0.5b, dr: the dry run and the examples, tp:
    tensor parallelism on qwen2-0.5b, its kernel rows added to ``rows``;
    for iterating alone, j: qwen2-0.5b's spsa step under the original
    threefry layout, q: the card ≡ CPU Adam steps), each after the trees
    before it are freed, K2 held to its plain version at every shape they
    gave it."""
    t0 = time.perf_counter()

    def qwen2_original_step():
        from repro_torch.models import all_archs, bundle
        cfg = all_archs()["qwen2-0.5b"].cfg.replace(
            attention_impl="pallas_flash")
        x1_original_step(torch, np, cfg, bundle(cfg).init(0, device="cuda"),
                         _build, counts, step_ms, card)

    phases = {"j": ("qwen2-0.5b", qwen2_original_step),
              "q": ("the backprop checks",
                    lambda: backprop_card_vs_cpu(torch, np, _build)),
              "u": ("hymba-1.5b", lambda: hymba_paths(
                  torch, np, kf, _build, counts, step_ms, card)),
              "t": ("mixtral-8x7b", lambda: mixtral_paths(
                  torch, np, _build, counts, step_ms, card)),
              "w": ("whisper-large-v3", lambda: whisper_paths(
                  torch, np, _build, counts, step_ms, card)),
              "x": ("qwen2-0.5b's tenants", lambda: tenants_paths(
                  torch, np, _build, counts, step_ms, card)),
              "y": ("qwen2-0.5b's shims", lambda: shims_paths(
                  torch, np, _build, counts, step_ms, card)),
              "z": ("qwen2-0.5b's distribution", lambda: distribution_paths(
                  torch, np, _build, counts, step_ms, card)),
              "dr": ("dry run", lambda: dryrun_paths(
                  torch, np, _build, counts, step_ms, card)),
              "tp": ("tensor parallelism", lambda: rows.extend(
                  tensor_parallel_paths(torch, np, _build, counts, step_ms,
                                        card)))}
    for ph in which:
        arch, run = phases[ph]
        shapes: set = set()
        stop = record_k2_shapes(shapes)
        t1 = time.perf_counter()
        try:
            run()
        finally:
            stop()
        free_card(torch, f"{arch}'s trees")
        if ph != "tp":
            # (tp)'s K2 calls run in its ranks: its (b) holds K2 on the
            # local heads bitwise against the whole launch's
            hold_k2_shapes(torch, kf, shapes, f"the {arch} paths")
        if ph == "u" and not any(sh[2:] == (25, 64) and kv == 5
                                 and w == 2048
                                 for sh, kv, _, _, w in shapes):
            fail("K2 never ran at hymba's heads (25 × 64 over 5) with its "
                 "window 2048")
        if ph == "w" and any(sh[2:] != (20, 64) or sh[1] != TRAIN_SEQ
                             for sh, *_ in shapes):
            fail(f"K2 ran at a shape other than whisper's decoder's: "
                 f"{sorted(shapes, key=str)}")
        log(f"phase ({ph}) {arch} took {time.perf_counter() - t1:.1f} s — "
            f"on {card}")
    log(f"the family phases {', '.join(which)} took "
        f"{time.perf_counter() - t0:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels against their plain "
                         "versions and the JAX fixtures, time K1, K3-K7, "
                         "K9-K11 (in turns with --parent) and K2 at hd "
                         "128, then stop")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone after the "
                         "build (j: qwen2-0.5b's spsa step under the "
                         "original threefry layout, q: the card ≡ CPU Adam "
                         "steps, u: hymba-1.5b, t: mixtral-8x7b, w: "
                         "whisper-large-v3, x: multi-tenant LoRA serving on "
                         "qwen2-0.5b, y: the deprecated shims and the "
                         "functional primitives on qwen2-0.5b, z: "
                         "distribution on qwen2-0.5b, dr: the dry run "
                         "against qwen2-0.5b's step and the five "
                         "examples, tp: tensor parallelism on qwen2-0.5b "
                         "over two processes), then stop "
                         "without the kernels "
                         "line: for iterating on one phase")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit (git archive): "
                         "its K1, K3-K7, K9-K11 and X1 are built and timed "
                         "in turns with this tree's")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on the card")
    if not (SRC / "repro_torch").is_dir() or not all(
            f.exists() for f in (GOLDEN, MULTI_GOLDEN, ROWS_GOLDEN,
                                 WKV6_GOLDEN, X1_GOLDEN, X1_ORIG_GOLDEN)):
        fail(f"run from the root of a checkout ({SRC / 'repro_torch'} or a "
             f"fixture under {GOLDEN.parent} missing)")
    sys.path.insert(0, str(SRC))
    global costs
    from repro_torch.analysis import costs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card, flush=True)
    t_start = time.perf_counter()

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as kf
    from repro_torch.kernels.paged import gather as kp
    from repro_torch.kernels.rwkv6 import kernel as kw
    from repro_torch.kernels.rwkv6 import ops as ko
    from repro_torch.kernels.zo_fused import kernel as kz
    from repro_torch.kernels.zo_fused import multi as km
    from repro_torch.kernels.zo_fused import rows as kr
    build_s = _build.build_all()
    log(f"built {len(_build.SOURCES)} CUDA sources "
        f"({len(_build.launch_counts)} kernels) in {build_s:.1f} s")
    build_facts(_build)
    if args.phases:
        rows = []
        run_family_phases(torch, np, kf, _build, {}, {}, card,
                          args.phases.split(","), rows)
        for row in rows:
            log("kernels line row: " + json.dumps(row))
        log(f"phases {args.phases}: passed in "
            f"{time.perf_counter() - t_start:.1f} s on {card}")
        return

    check_z_selftest(kz)
    k1_err = check_k1(torch, np, kz)
    k2_err = check_k2(torch, kf)
    check_k2_sweep(torch, kf, _build)
    check_k3_k4_k5(torch, np, kz, km)
    check_k6(torch, np, km)
    check_k7_k10(torch, np, kr)
    k11_err = check_k11(torch, np, kw, ko)
    check_k11_sweep(torch, ko)
    x1_err = check_x1(torch, np)
    x1o_err = check_x1_original(torch, np)
    check_pipes(_build, card)

    # ---- full width ---------------------------------------------------- #
    from repro_torch.models import all_archs, bundle
    from repro_torch.tree_utils import is_floating, tree_leaves
    cfg = all_archs()["qwen2-0.5b"].cfg.replace(attention_impl="pallas_flash")
    t0 = time.perf_counter()
    params0 = bundle(cfg).init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params0))
    log(f"qwen2-0.5b: {n_params} params bf16, {cfg.n_layers} layers, "
        f"init {time.perf_counter() - t0:.1f} s")
    rows_split = rows_route_split(params0)
    scratch = _clone_tree(params0)
    z_turns(torch, _build, [p for p in tree_leaves(scratch)
                            if is_floating(p)], args.parent, card)
    del scratch
    k2_hd128 = time_k2_hd128(torch, kf, card)
    x1o_row = x1_original_row(
        torch, np, _build, params0, card, x1o_err,
        None if args.parent is None
        else ROOT / "build" / "parent_kernels" / "zo_threefry.so")
    if args.kernels_only:
        log(f"kernels only: all checks passed in "
            f"{time.perf_counter() - t_start:.1f} s on {card}")
        return
    check_k12(torch, kp, cfg.n_layers, 1 + 2 * SLOTS * (MAX_LEN // BLOCK),
              cfg.kv_heads * cfg.hd)
    counts: dict = {}

    # ---- path 1: serve ------------------------------------------------ #
    params = _clone_tree(params0)
    twin = _clone_tree(params0)
    eng, prompts = serving_path(torch, np, cfg, params, twin, card, _build,
                                counts)
    with torch.no_grad():
        probe = bundle(cfg).prefill_fn()(
            params, {"tokens": torch.tensor([prompts[0][:64]], device="cuda")})
    if probe[0].shape != (1, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(probe[0]).all()):
        fail("prefill logits not finite or of the wrong shape")
    pool_k = eng.pool.k
    nblk_slot = eng._nblk_slot
    del params, twin, eng, probe

    # ---- memory and device-busy share of the spsa and fzoo steps ------- #
    memory_and_busy(torch, cfg, params0)
    fzoo_busy(torch, cfg, params0)
    fzoo_busy(torch, cfg, params0, "sphere")

    # ---- paths 2-5 and 7-10: train (a)-(d), then (e)-(h) under a ------- #
    # ---- selection; path 6: serve the fzoo fine-tune ------------------- #
    from repro_torch.models.peft import init_lora, peft_params
    opts = make_opts()
    trained, ledgers, step_ms = {}, {}, {}
    for name in STEPS:
        make_opt, make_plan = opts[name]
        p0 = params0
        if name == "e_rows_spsa":
            memory_and_busy(torch, cfg, params0, selection=ROWS)
        if name == "h_lora":
            lora = init_lora(cfg, torch.Generator(device="cuda").manual_seed(
                1), rank=LORA_RANK, alpha=LORA_ALPHA)
            p0 = peft_params(params0, lora, "lora")
        p, led, _, ms = train_phase(torch, cfg, p0, name, make_opt,
                                    make_plan, _build, counts)
        check_replays(torch, name, p0, p, led, make_opt)
        step_ms[name] = ms
        if name == "h_lora":
            for a, b in zip(tree_leaves(p["base"]), tree_leaves(params0)):
                if not same_bits(a, b):
                    fail("h_lora: a base leaf moved under peft(lora)")
            log(f"h_lora: every base leaf is θ₀'s bitwise after "
                f"{STEPS[name]} steps ({len(tree_leaves(lora))} LoRA leaves "
                "trained, _scale included)")
            del lora
        if name in ("b_fzoo", "f_rows_fzoo"):
            trained[name], ledgers[name] = p, led
        del p, p0
        if name == "d_sp2":
            serve_finetune(torch, np, cfg, params0, trained["b_fzoo"],
                           ledgers["b_fzoo"], prompts, _build, counts)
            del trained["b_fzoo"]

    # ---- path 11: serve the rows fine-tune ----------------------------- #
    serve_finetune(torch, np, cfg, params0, trained["f_rows_fzoo"],
                   ledgers["f_rows_fzoo"], prompts, _build, counts,
                   kernels=("zo_affine_chain_rows",), what="rows fzoo")
    del trained

    # ---- paths 12-13: the default stream (xla, X1): train spsa, serve --- #
    # ---- its fine-tune; mezo-adam, trace and rescaled SPSA ------------- #
    x1_row = xla_paths(torch, np, cfg, params0, prompts, _build, counts,
                       step_ms, card, x1_err)
    x1_original_step(torch, np, cfg, params0, _build, counts, step_ms, card)

    # ---- kernel times at the qwen2-0.5b paths' shapes ----------------- #
    rows = qwen2_kernel_rows(torch, np, cfg, params0, pool_k, nblk_slot,
                             k1_err, k2_err, card, kz, km, kr, kf, kp)
    rows.append(x1_row)
    rows.append(x1o_row)
    del params0, pool_k

    # ---- the ssm family: rwkv6-3b at full width and depth -------------- #
    free_card(torch, "qwen2-0.5b's trees")
    rows.append(ssm_paths(torch, np, kw, ko, _build, counts, step_ms, card,
                          k11_err))

    # ---- the paper's models at full width: roberta-large (accuracy), --- #
    # ---- opt-13b (CE, serving, F1) and opt-30b (CE), on the xla stream - #
    free_card(torch, "rwkv6-3b's trees")
    k2_shapes: set = set()
    stop = record_k2_shapes(k2_shapes)
    try:
        roberta_paths(torch, np, _build, counts, step_ms, card)
        free_card(torch, "roberta-large's trees")
        opt13b_paths(torch, np, _build, counts, step_ms, card)
        free_card(torch, "opt-13b's trees")
        opt30b_paths(torch, np, _build, counts, step_ms, card)
    finally:
        stop()
    free_card(torch, "opt-30b's trees")
    hold_k2_shapes(torch, kf, k2_shapes, "the roberta / opt paths")

    # ---- the backprop baseline against MeZO: (o) roberta-large and (p) - #
    # ---- qwen2-0.5b at full width; (q) card ≡ CPU and K2's / K11's ----- #
    # ---- refusals of autograd; (r) the memory reckoning ---------------- #
    backprop_paths(torch, np, _build, counts, step_ms, card)
    backprop_card_vs_cpu(torch, np, _build)
    reckon_adam_vs_mezo(torch, card)

    # ---- the moe family: (s) granite-moe-3b-a800m at full width and ---- #
    # ---- depth, (t) mixtral-8x7b at full width, depth cut -------------- #
    free_card(torch, "the backprop phases' trees")
    t_moe = time.perf_counter()
    moe_shapes: set = set()
    stop = record_k2_shapes(moe_shapes)
    try:
        granite_paths(torch, np, _build, counts, step_ms, card)
        free_card(torch, "granite-moe-3b-a800m's trees")
        mixtral_paths(torch, np, _build, counts, step_ms, card)
    finally:
        stop()
    free_card(torch, "mixtral-8x7b's trees")
    if not any(sh[3] == 128 and w == 4096 for sh, _, _, _, w in moe_shapes):
        fail("K2 never ran at hd 128 with mixtral's window 4096")
    hold_k2_shapes(torch, kf, moe_shapes, "the moe paths")
    log(f"the moe phases (s) and (t) took {time.perf_counter() - t_moe:.1f} "
        f"s — on {card}")

    # ---- the hybrid and encdec families: (u) hymba-1.5b, (w) ----------- #
    # ---- whisper-large-v3, each at full width and depth; (x) ----------- #
    # ---- multi-tenant LoRA serving on qwen2-0.5b ----------------------- #
    run_family_phases(torch, np, kf, _build, counts, step_ms, card,
                      ["u", "w", "x", "y", "z", "dr", "tp"], rows)
    rows.append(k2_hd128)
    for row in rows:
        if not row["name"].endswith(TP_ROUTES):
            row["launches"] = counts.get(row["name"], 0)
    # K2's two rows: its launches at hd 64 (qwen2) and at hd 128 (opt)
    k2_hd = {hd: counts.get(f"flash_attention/hd{hd}", 0) for hd in (64, 128)}
    if sum(k2_hd.values()) != counts.get("flash_attention", 0):
        fail(f"K2 on the counted paths: {counts.get('flash_attention', 0)} "
             f"launches, {k2_hd} at hd 64 / 128")
    for row in rows:
        if row["name"] == "flash_attention":
            row["launches"] = k2_hd[64]
        elif row["name"] == "flash_attention_hd128":
            row["launches"] = k2_hd[128]
    x1_vec = counts.get("zo_affine_threefry/vector", 0)
    x1_rows = counts.get(X1_ROWS_EXAMPLE, 0)
    x1_shard = counts.get("zo_affine_threefry/shard", 0)
    if x1_vec == 0 or x1_vec + x1_rows + x1_shard != counts.get(
            "zo_affine_threefry", 0):
        fail(f"X1 on the counted paths: {x1_vec} vector-route launches of "
             f"{counts.get('zo_affine_threefry', 0)}, {x1_rows} off it in "
             "the train_100m example's rows selection, "
             f"{x1_shard} on shards in (tp)")
    orig = {r: counts.get(f"zo_affine_threefry_original/{r}", 0)
            for r in ("pairs/vector", "pairs/scalar", "bands")}
    if orig["pairs/vector"] == 0 or orig["pairs/vector"] != counts.get(
            "zo_affine_threefry_original/pairs", 0):
        fail(f"X1's original route on the counted paths: {orig} — every "
             "pairs launch of a whole leaf takes the vector route")
    log(f"X1 over the counted paths: {x1_vec} launches on the vector "
        f"route, all but the {x1_rows} of the train_100m example's sub-leaf "
        f"rows selection (bands / scalar) and the {x1_shard} on (tp)'s "
        "shards; its original-layout route "
        f"{counts.get('zo_affine_threefry_original', 0)} launches (pairs "
        f"{counts.get('zo_affine_threefry_original/pairs', 0)}: "
        + ", ".join(f"{k} {v}" for k, v in orig.items()) + ")")
    k11_tile = counts.get("wkv6_chunked/tile", 0)
    if k11_tile == 0 or k11_tile != counts.get("wkv6_chunked", 0):
        fail(f"K11 on the counted paths: {k11_tile} tiled launches of "
             f"{counts.get('wkv6_chunked', 0)}")
    log(f"K11 over the counted paths: all {k11_tile} launches on the tiled "
        "route (training and the served prefills)")
    fan = {k: counts.get(f"{k}/vector", 0)
           for k in ("zo_affine_multi", "zo_affine_batched")}
    fan_shard = {k: counts.get(f"{k}/shard", 0) for k in fan}
    fan_all = {k: counts.get(k, 0) for k in fan}
    if min(fan.values()) == 0 or any(fan[k] + fan_shard[k] != fan_all[k]
                                     for k in fan):
        fail(f"K4/K5 on the counted paths: vector-route launches {fan} and "
             f"shard-route launches {fan_shard} of {fan_all}")
    log("K4/K5 over the counted paths: all " + " and ".join(
        f"{v} {k}" for k, v in fan.items()) + " launches of whole leaves on "
        "the vector route, " + " and ".join(
            f"{v} {k}" for k, v in fan_shard.items()) + " on (tp)'s shards")
    check_rows_routes_on_paths(counts, rows_split)
    k2_mma = counts.get("flash_attention/bf16_mma", 0)
    copied = {k: v for k, v in counts.items() if k.endswith("+copy")}
    if k2_mma == 0 or k2_mma != counts.get("flash_attention", 0) or copied:
        fail(f"K2 on the counted paths: {k2_mma} bf16 mma.sync launches of "
             f"{counts.get('flash_attention', 0)}; copies {copied}")
    log(f"K2 over the counted paths: all {k2_mma} launches on the bf16 "
        f"mma.sync route, none on a +copy route: {k2_hd[64]} at hd 64 (the "
        f"qwen2, granite, hymba and whisper paths), {k2_hd[128]} at hd 128 "
        f"(the opt-13b / opt-30b / mixtral paths); K2 hd 128 (OPT-13b's shape): {k2_hd128['ms']:.4f} ms, SDPA "
        f"{k2_hd128['library_ms']:.4f} ms, bound {k2_hd128['bound_ms']:.4f}")
    log("training step ms: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in step_ms.items())
        + f" — on {card}; smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def tokens_of(ids) -> int:
    return sum(len(x) for x in ids)


if __name__ == "__main__":
    main()
