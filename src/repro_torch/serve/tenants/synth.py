"""Synthetic many-tenant fixtures: train N LoRA tenants, generate load — the
port of ``repro.serve.tenants.synth``.

* ``make_lora_tenants`` trains N small LoRA runs (one composition and one
  step function for all; only the seed and the LoRA init differ) and
  registers each ledger in an ``AdapterStore``.  The ledger's ``base_seed``
  is also the tenant's LoRA-init seed (``init_lora`` from a threefry key:
  JAX's A bit for bit), so the ledger alone determines the adapter — a JAX-
  or port-trained ledger rebuilds the same LoRA tree in either package.
* ``lora_runtime`` builds the matching ``TenantRuntime`` (params0 from the
  ledger seed, ``merge_lora`` as the serve map).
* ``synthetic_requests`` / ``template_requests`` draw JAX's request streams
  (numpy, bit for bit), and ``serve_load`` drives one engine through them,
  returning per-request timing rows.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import zo
from repro_torch.core.trajectory import TrajectoryLedger
from repro_torch.data.synthetic import PromptClassification
from repro_torch.models.config import ModelConfig
from repro_torch.models.peft import init_lora, merge_lora, peft_loss_fn
from repro_torch.perturb.stream import prng_key
from repro_torch.select import peft as peft_select
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.tenants.cache import DeltaCache
from repro_torch.serve.tenants.runtime import TenantRuntime
from repro_torch.serve.tenants.store import AdapterStore
from repro_torch.tree_utils import tree_leaves

LORA_RANK = 2          # one convention shared by trainer and serving host
LORA_ALPHA = 16.0
LORA_TARGETS = ("wq", "wv")


def tenant_name(i: int) -> str:
    return f"tenant-{i:03d}"


def lora_params0(cfg: ModelConfig, base_params, ledger: TrajectoryLedger):
    """The tenant's training start tree, rebuilt from the ledger alone:
    merged ``{"base", "lora"}`` with the LoRA init seeded by ``base_seed``,
    on the base's device."""
    dev = tree_leaves(base_params)[0].device
    lora = init_lora(cfg, prng_key(ledger.base_seed), rank=LORA_RANK,
                     alpha=LORA_ALPHA, targets=LORA_TARGETS, device=dev)
    return {"base": base_params, "lora": lora}


def lora_runtime(cfg: ModelConfig, base_params, store: AdapterStore,
                 cache_bytes: int = 0) -> TenantRuntime:
    """A ``TenantRuntime`` for LoRA tenants over ``base_params``: the serving
    delta is ``merge_lora(base, tuned_lora)`` diffed against the base — the
    targeted attention leaves only, ~r/d of the parameter bytes."""
    return TenantRuntime(
        base_params, store,
        cache=DeltaCache(cache_bytes) if cache_bytes > 0 else None,
        params0_fn=lambda led: lora_params0(cfg, base_params, led),
        serve_map=lambda merged: merge_lora(merged["base"], merged["lora"]))


def make_lora_tenants(cfg: ModelConfig, base_params, n_tenants: int,
                      steps: int = 10, batch: int = 8, lr: float = 2e-4,
                      eps: float = 1e-3, backend=None,
                      seed0: int = 100) -> AdapterStore:
    """Train ``n_tenants`` LoRA fine-tunes of the shared frozen base, each on
    its own synthetic task, recording only the scalar ledger (grad_dtype
    float32 → bitwise replay).  The step writes the LoRA leaves in place;
    the base's are never written (the ``peft("lora")`` selection)."""
    opt = zo.mezo(lr=lr, eps=eps, backend=backend,
                  selection=peft_select("lora"))
    step = opt.step_fn(peft_loss_fn(cfg, "lora"))
    store = AdapterStore()
    dev = tree_leaves(base_params)[0].device

    def clamp(batch):
        # the task's class-band token ids reach ~210 regardless of its vocab
        # arg; fold them into this model's vocab (an out-of-range id would
        # gather garbage embeddings and poison every projected grad)
        return {**batch, "tokens": batch["tokens"] % cfg.vocab_size,
                "labels": batch["labels"] % cfg.vocab_size}

    for i in range(n_tenants):
        bseed = seed0 + i
        task = PromptClassification(vocab=cfg.vocab_size, seed=bseed)
        led = TrajectoryLedger(
            base_seed=bseed, grad_dtype="float32",
            backend=opt.backend_name, batch_seeds=opt.batch_seeds,
            selection=opt.selection_spec, sel_phase=opt.selection_phase)
        p = lora_params0(cfg, base_params, led)
        state = opt.init(p, seed=bseed)
        for s in range(steps):
            p, state, m = step(p, state, clamp(task.batch_for_step(
                s, batch, device=dev)))
            led.append(s, float(m["projected_grad"]), float(m["lr"]))
        store.put(tenant_name(i), led)
    return store


# --------------------------------------------------------------------------- #
# Load generation + the shared serving loop
# --------------------------------------------------------------------------- #
def synthetic_requests(n_requests: int, vocab_size: int, tenants: list,
                       seed: int = 0, max_new_tokens: int = 8,
                       skew: float = 2.0) -> list:
    """``[(tenant, Request), ...]`` with a skewed tenant popularity (low
    indices hot — ``skew > 1`` concentrates traffic, which gives a
    byte-budgeted cache something to exploit; ``skew=1`` is uniform)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        t = tenants[int(len(tenants) * rng.random() ** skew)]
        plen = int(rng.integers(2, 9))
        prompt = [int(x) for x in rng.integers(1, vocab_size - 1, plen)]
        out.append((t, Request(i, prompt, max_new_tokens=max_new_tokens)))
    return out


def template_requests(n_requests: int, vocab_size: int, tenants: list,
                      n_templates: int = 4, template_len: int = 48,
                      suffix_len: tuple = (2, 8), seed: int = 0,
                      max_new_tokens: int = 8, skew: float = 1.2,
                      rid0: int = 0, template_seed=None) -> list:
    """``[(tenant, Request), ...]`` with the shared-template shape of
    prompt-heavy ZO workloads (paper §3: one task template + a short
    per-example suffix).

    Each tenant owns ``n_templates`` fixed ``template_len``-token templates;
    every request draws a template Zipf-style (``skew`` > 0 concentrates
    traffic on low template indices — where a radix prefix cache pays) and
    appends a fresh random suffix of ``suffix_len=(lo, hi)`` tokens.
    Template tokens are deterministic in (template_seed, tenant index,
    template); ``template_seed`` defaults to ``seed`` — pass it to draw
    successive waves with fresh suffixes over the same templates."""
    rng = np.random.default_rng(seed)
    if template_seed is None:
        template_seed = seed
    templates: dict = {}
    for ti, t in enumerate(tenants):
        trng = np.random.default_rng((template_seed, ti))
        templates[t] = [
            [int(x) for x in trng.integers(1, vocab_size - 1, template_len)]
            for _ in range(n_templates)]
    ranks = np.arange(1, n_templates + 1, dtype=np.float64)
    pz = ranks ** -(1.0 + skew)
    pz /= pz.sum()
    out = []
    for i in range(n_requests):
        t = tenants[int(rng.integers(0, len(tenants)))]
        k = int(rng.choice(n_templates, p=pz))
        slen = int(rng.integers(suffix_len[0], suffix_len[1] + 1))
        suffix = [int(x) for x in rng.integers(1, vocab_size - 1, slen)]
        out.append((t, Request(rid0 + i, templates[t][k] + suffix,
                               max_new_tokens=max_new_tokens)))
    return out


def serve_load(engine: ServeEngine, runtime: TenantRuntime,
               tagged_requests: list) -> list:
    """Drive ``engine`` through ``(tenant, Request)`` pairs: materialize (or
    cache-hit) each tenant's delta, register it, submit, and drain.  The
    queued stamp is taken before materialization, so a cold adapter's
    replay lands in its requests' time-to-first-token.  Returns
    per-request timing rows."""
    for tenant, req in tagged_requests:
        req.times.setdefault("queued", time.perf_counter())
        if tenant is not None:
            engine.register_adapter(tenant, runtime.delta(tenant))
            req.adapter = tenant
        engine.submit(req)
    engine.run()
    rows = []
    for tenant, req in tagged_requests:
        q = req.times["queued"]
        rows.append({
            "rid": req.rid, "tenant": tenant,
            "n_out": len(req.out_ids),
            "ttft_s": req.times.get("prefill", q) - q,
            "total_s": req.times.get("done", q) - q,
        })
    return rows
