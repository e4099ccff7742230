"""Port parity of the backprop baselines' arithmetic
(``repro_torch.train.adam`` against ``repro.train.adam``) and of
``value_and_grad`` through the models.

* The update on identical gradients: a linear loss Σ p.f32 · c, c passed as
  the batch (so no graph folds it) with small dyadic values, so both
  frameworks get the gradient c and an exact squared norm.  Against JAX's
  step run op by op (each jnp op its own XLA computation): θ, m, v, η and
  the gradient norm bitwise, and the state dtypes after steps 0 and 1
  equal.  Against the jitted step that ``train.loop`` runs: m and v within
  2 f32 ulps and θ within one ulp of its leaf's largest |θ| per step.  That
  graph differs in two places, both measured: XLA:CPU contracts each
  multiply-add into an FMA (m = fma(m, β₁, (1−β₁)·g), likewise v and the θ
  write), and its simplifier rewrites (m/bc₁)/den as m/(bc₁·den).  The port
  rounds each operation on its own, as the reference's source writes them.
* η and the bias corrections against the jitted JAX for t = 1 … 1000,
  bitwise: the schedule's division by its constant step count is a product
  with the f32 reciprocal there, and β^t is libm's ``powf``.
* ``value_and_grad`` through the smoke models in f32 (qwen2-0.5b under the
  ``xla`` and ``chunked`` attention, opt, roberta, rwkv6 in both scan
  modes) against ``jax.value_and_grad`` on the weights ``convert`` carries
  across: the loss within 1e-5 and every gradient leaf within 1e-5 of its
  largest |g| (f32 forwards and backwards summed in each framework's order).
* ``attention_impl="pallas_flash"`` refuses autograd in both packages.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import schedules as jax_schedules
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.train.adam import Adam as JaxAdam
from repro.train.adam import AdamConfig as JaxAdamConfig
from repro_torch import convert
from repro_torch.core import schedules
from repro_torch.models import all_archs, bundle
from repro_torch.train.adam import Adam, AdamConfig, bias_correction, \
    value_and_grad
from repro_torch.tree_utils import tree_leaves

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

STEPS = 5
# every case's schedule has power-of-two step counts, so JAX's jitted
# (reciprocal product) and op-by-op (division) η agree and the op-by-op
# comparison is bitwise
CASES = {
    "adam": dict(lr=1e-2),
    "adam_noclip": dict(lr=1e-2, grad_clip=0.0),
    "adam_wd": dict(lr=1e-2, weight_decay=0.01),
    "adam_warmup": dict(lr=1e-2, warmup_steps=4, total_steps=16),
    "sgd": dict(lr=1e-2, sgd=True),
    "sgd_noclip_wd": dict(lr=1e-2, sgd=True, grad_clip=0.0,
                          weight_decay=0.01),
    "sgd_momentum": dict(lr=1e-2, sgd=True, momentum=0.9, weight_decay=0.01,
                         warmup_steps=4, total_steps=16),
}
DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
GRAD_LOSS_ATOL = 1e-5
GRAD_REL = 1e-5


def _linear_problem(dtype):
    """θ₀ (standard normal, in ``dtype``) and c (multiples of 1/16 in
    [−½, ½]) over a nested tree."""
    rng = np.random.default_rng(0)
    shapes = {"a": (37,), "b": {"w": (5, 9), "z": (3, 4, 6)}}

    def each(fn, tree):
        return {k: each(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    theta = each(lambda s: rng.standard_normal(s).astype(np.float32)
                 .astype(DTYPES[dtype]), shapes)
    c = each(lambda s: (rng.integers(-8, 9, s) / 16).astype(np.float32),
             shapes)
    return theta, c


def _jax_loss(params, batch):
    return sum(jnp.sum(x.astype(jnp.float32) * y) for x, y in
               zip(jax.tree_util.tree_leaves(params),
                   jax.tree_util.tree_leaves(batch)))


def _torch_loss(params, batch):
    return sum(torch.sum(x.float() * y) for x, y in
               zip(tree_leaves(params), tree_leaves(batch)))


def _np(t) -> np.ndarray:
    return convert._to_numpy(t) if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _runs(case: str, dtype: str, jit: bool):
    """Both packages' steps on the linear problem; yields (step index, JAX
    params / state / metrics, the port's)."""
    kw = CASES[case]
    theta, c = _linear_problem(dtype)
    jo, to = JaxAdam(JaxAdamConfig(**kw)), Adam(AdamConfig(**kw))
    jp = jax.tree.map(jnp.asarray, theta)
    tp = convert.params_from_jax(theta)
    jc, tc = jax.tree.map(jnp.asarray, c), convert.params_from_jax(c)
    js, ts = jo.init(jp), to.init(tp)
    yield -1, (jp, js, None), (tp, ts, None)
    jstep = jo.step_fn(_jax_loss)
    jstep = jax.jit(jstep) if jit else jstep
    tstep = to.step_fn(_torch_loss)
    for k in range(STEPS):
        jp, js, jm = jstep(jp, js, jc)
        tp, ts, tm = tstep(tp, ts, tc)
        yield k, (jp, js, jm), (tp, ts, tm)


def _trees(j, t):
    """(name, JAX leaves, port leaves) of θ, m and v."""
    (jp, js, _), (tp, ts, _) = j, t
    return [("theta", jax.tree_util.tree_leaves(jp), tree_leaves(tp)),
            ("m", jax.tree_util.tree_leaves(js.m), tree_leaves(ts.m)),
            ("v", jax.tree_util.tree_leaves(js.v), tree_leaves(ts.v))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_is_bitwise_jax_op_by_op(case, dtype):
    for k, j, t in _runs(case, dtype, jit=False):
        for name, jl, tl in _trees(j, t):
            assert len(jl) == len(tl), name
            for a, b in zip(jl, tl):
                a, b = np.asarray(a), _np(b)
                assert a.dtype == b.dtype, (k, name, a.dtype, b.dtype)
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), \
                    (k, name)
        if k < 0:
            continue
        jm, tm = j[2], t[2]
        assert np.float32(jm["lr"]) == np.float32(tm["lr"]), k
        assert np.float32(jm["grad_norm"]) == np.float32(
            _np(tm["grad_norm"])), k
        # the loss is a sum in each framework's order
        assert abs(float(jm["loss"]) - float(_np(tm["loss"]))) <= 1e-5 * max(
            1.0, abs(float(jm["loss"]))), k
        assert int(j[1].step) == int(t[1].step) == k + 1


def _ulp(x: np.ndarray, dtype) -> np.ndarray:
    """One ulp of ``dtype`` at |x| (x held in f32)."""
    sp = np.spacing(np.abs(x.astype(np.float32)))
    return sp * (2.0 ** 16 if dtype == ml_dtypes.bfloat16 else 1.0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_within_ulps_of_jax_jitted(case, dtype):
    for k, j, t in _runs(case, dtype, jit=True):
        for name, jl, tl in _trees(j, t):
            for a, b in zip(jl, tl):
                a, b = np.asarray(a), _np(b)
                assert a.dtype == b.dtype, (k, name, a.dtype, b.dtype)
                a32, b32 = a.astype(np.float32), b.astype(np.float32)
                if name == "theta":
                    # one contracted rounding per step at the leaf's scale
                    bound = (k + 1) * _ulp(np.abs(a32).max(), a.dtype)
                    assert np.abs(a32 - b32).max() <= bound, (k, name)
                else:
                    ulps = np.abs(a32 - b32) / _ulp(np.maximum(
                        np.abs(a32), np.abs(b32)), np.float32)
                    assert ulps.max() <= 2, (k, name, ulps.max())
        if k >= 0:
            assert np.float32(j[2]["lr"]) == np.float32(t[2]["lr"]), k


@pytest.mark.parametrize("schedule,total,warmup", [
    ("constant", 0, 0), ("linear", 1000, 0), ("linear", 100, 10),
    ("linear", 7, 3), ("cosine", 1000, 0), ("cosine", 300, 30)])
def test_lr_matches_jitted_jax_over_1000_steps(schedule, total, warmup):
    f = jax.jit(lambda s: jax_schedules.lr_at(schedule, 1e-4, s, total,
                                              warmup))
    steps = np.arange(1001, dtype=np.int32)
    want = np.array([np.float32(f(jnp.int32(s))) for s in steps])
    got = np.array([schedules.lr_at(schedule, 1e-4, s, total, warmup)
                    for s in steps])
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("beta", [0.9, 0.999, 0.95, 0.5])
def test_bias_corrections_match_jitted_jax_over_1000_steps(beta):
    f = jax.jit(lambda s: 1.0 - beta ** (s + 1).astype(jnp.float32))
    want = np.array([np.float32(f(jnp.int32(s))) for s in range(1000)])
    got = np.array([bias_correction(beta, np.float32(s + 1))
                    for s in range(1000)])
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


# --------------------------------------------------------------------------- #
# value_and_grad through the models
# --------------------------------------------------------------------------- #
MODELS = {
    "qwen2-xla": ("qwen2-0.5b", dict(attention_impl="xla")),
    "qwen2-chunked": ("qwen2-0.5b", dict(attention_impl="chunked",
                                         attention_chunk=8)),
    "opt": ("opt-13b", {}),
    "roberta": ("roberta-large", {}),
    "rwkv6-chunk": ("rwkv6-3b", dict(scan_mode="chunk")),
    "rwkv6-fused": ("rwkv6-3b", dict(scan_mode="fused_recurrent")),
}


def _weights(arch, jcfg):
    w = jax.tree.map(np.asarray, jax_bundle(jcfg).init(jax.random.PRNGKey(0)))
    if arch == "rwkv6-3b":
        # a nonzero decay LoRA, logit and bonus: a data-dependent recurrence
        rng = np.random.default_rng(3)
        tm = w["layers"]["tm"]
        for name, scale in (("w_lora_b", 0.5), ("w0", 1.0), ("u", 1.0)):
            tm[name] = (rng.standard_normal(tm[name].shape)
                        * scale).astype(np.float32)
    return w


@pytest.mark.parametrize("model", sorted(MODELS))
def test_value_and_grad_matches_jax(model):
    arch, over = MODELS[model]
    jcfg = jax_archs()[arch].smoke_cfg.replace(**over)
    tcfg = all_archs()[arch].smoke_cfg.replace(**over)
    w = _weights(arch, jcfg)
    rng = np.random.default_rng(1)
    S = 32 if arch == "rwkv6-3b" else 24
    batch = {"tokens": rng.integers(0, 256, (2, S)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, S)).astype(np.int32),
             "loss_mask": (rng.random((2, S)) > 0.2).astype(np.float32)}
    jl, jg = jax.value_and_grad(jax_bundle(jcfg).loss_fn())(
        jax.tree.map(jnp.asarray, w), {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    tl, tg = value_and_grad(bundle(tcfg).loss_fn(),
                            convert.params_from_jax(w),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) < GRAD_LOSS_ATOL
    jpaths = jax.tree_util.tree_flatten_with_path(jg)[0]
    tleaves = tree_leaves(tg)
    assert len(jpaths) == len(tleaves)
    for (path, a), b in zip(jpaths, tleaves):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, path
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= GRAD_REL * scale, \
            (jax.tree_util.keystr(path), float(np.abs(a - b).max()), scale)


def test_stacked_leaves_are_unbound_once():
    """The layer loop takes each stacked leaf apart with one ``unbind``: its
    backward stacks the layers' gradients once, where indexing it per layer
    would build a zero-filled leaf-sized gradient for every layer."""
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    params = bundle(cfg).init(0, device="cpu")
    live = {k: v for k, v in params.items()}
    wq = params["layers"]["attn"]["wq"].detach().requires_grad_()
    live["layers"] = {**params["layers"],
                      "attn": {**params["layers"]["attn"], "wq": wq}}
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    loss = bundle(cfg).loss_fn()(live, {"tokens": tokens, "labels": tokens})
    seen, stack, users = set(), [loss.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if getattr(nxt, "variable", None) is wq:
                users.append(type(fn).__name__)
            stack.append(nxt)
    # the stacked leaf feeds one node, its unbind (a per-layer index would
    # give one SelectBackward per layer)
    assert users == ["UnbindBackward0"]


# --------------------------------------------------------------------------- #
# pallas_flash under autograd: refused in both packages
# --------------------------------------------------------------------------- #
def test_pallas_flash_refuses_autograd_in_both_packages():
    jcfg = jax_archs()["qwen2-0.5b"].smoke_cfg.replace(
        attention_impl="pallas_flash")
    tcfg = all_archs()["qwen2-0.5b"].smoke_cfg.replace(
        attention_impl="pallas_flash")
    w = jax.tree.map(np.asarray, jax_bundle(jcfg).init(jax.random.PRNGKey(0)))
    toks = np.zeros((2, 16), np.int32)
    # JAX's Pallas kernel has no backward: its grad fails (an AssertionError
    # inside pallas_call on jax 0.9.0)
    with pytest.raises(Exception):
        jax.value_and_grad(jax_bundle(jcfg).loss_fn())(
            jax.tree.map(jnp.asarray, w),
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    with pytest.raises(RuntimeError, match="flash_attention .* no backward"):
        value_and_grad(bundle(tcfg).loss_fn(), convert.params_from_jax(w),
                       batch)
    # the forward alone still runs, and equals the xla impl's loss
    with torch.no_grad():
        fwd = bundle(tcfg).loss_fn()(convert.params_from_jax(w), batch)
    ref = bundle(tcfg.replace(attention_impl="xla")).loss_fn()(
        convert.params_from_jax(w), batch)
    assert abs(float(fwd) - float(ref)) < GRAD_LOSS_ATOL
