"""K11 under autograd: ``ops.ChunkedWKV``, what ``ops.wkv6`` runs on the
card, keeps the forward on K11 and takes the gradient of the plain chunk
form, recomputed.  Here ``kernel.launch`` is replaced, inside each test
only, by the plain version on the model's layout (the CPU has no card), so
the Function's own code runs: its forward, the saved inputs, the recompute
and ``torch.autograd.grad`` with dy and ds_final, either of which may be
absent.

Its dr, dk, dv, dlw, du and ds0 are held to

* ``torch.autograd`` through ``wkv6_plain``: bitwise (the same graph), and
* ``jax.vjp`` of JAX's chunk-mode ``time_mix`` (its jnp chunk graph, with
  the chunk states composed by ``associative_scan``) with the layer's
  projections and output replaced by the inputs themselves: within
  ``VJP_REL`` of each gradient's largest |value| in f32 — the two compose
  the chunk states in another order (a sequential loop against a log-depth
  scan), and the gradients pass the k̃ = k·e^{−lc} factors of up to e^{43}
  (measured ≤ 2.2e-6 on these cases)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.models.rwkv6 as JR
from repro.models import all_archs as jax_archs
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import kernel as K
from repro_torch.kernels.rwkv6 import ops

torch.set_num_threads(1)

VJP_REL = 2e-5
NAMES = ("r", "k", "v", "lw", "u", "s0")


def _inputs(B, S, H, hd, seed):
    rng = np.random.default_rng(seed)
    sh = (B, S, H, hd)
    r, k, v = (rng.standard_normal(sh).astype(np.float32) for _ in range(3))
    lw = (-np.exp(np.clip(rng.standard_normal(sh), -8, 1))).astype(
        np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    dy = rng.standard_normal(sh).astype(np.float32)
    ds = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return (r, k, v, lw, u, s0), dy, ds


@pytest.fixture
def plain_launch(monkeypatch):
    """``kernel.launch`` as its plain version, counted as a launch."""
    def launch(r, k, v, lw, u, u_strides, s0, chunk):
        assert not torch.is_grad_enabled()      # the Function's forward
        _build.count("wkv6_chunked", "plain")
        return ops.wkv6_plain(r, k, v, lw, u, s0, chunk=chunk)

    monkeypatch.setattr(K, "launch", launch)
    _build.reset_launch_counts()
    yield
    _build.reset_launch_counts()


def _torch_grads(fn, args, dy, ds):
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = fn(*ins)
    outs, cots = [], []
    if dy is not None:
        outs.append(y)
        cots.append(torch.from_numpy(dy))
    if ds is not None:
        outs.append(s)
        cots.append(torch.from_numpy(ds))
    return [g.numpy() for g in torch.autograd.grad(
        outs, ins, cots, allow_unused=True, materialize_grads=True)]


def _jax_grads(args, dy, ds, chunk):
    """jax.vjp of JAX's chunk-mode time_mix with its projections and output
    replaced by (r, k, v, lw, u, s0) and y itself."""
    B, S, H, hd = args[0].shape
    cfg = jax_archs()["rwkv6-3b"].smoke_cfg.replace(
        n_heads=H, head_dim=hd, scan_chunk=chunk, scan_mode="chunk")

    def f(r, k, v, lw, u, s0):
        orig = JR._tm_projections, JR._tm_output
        JR._tm_projections = lambda *a: (None, r, k, v, None, lw, u, s0)
        JR._tm_output = lambda cfg, p, x, xn, y, g: (y, None)
        try:
            y, (_, s_final) = JR.time_mix(cfg, {}, jnp.zeros((B, S, 1)),
                                          None)
        finally:
            JR._tm_projections, JR._tm_output = orig
        return y, s_final

    cot = (dy if dy is not None else np.zeros(args[0].shape, np.float32),
           ds if ds is not None else np.zeros(args[5].shape, np.float32))
    grads = jax.jit(lambda a, c: jax.vjp(f, *a)[1](c))(
        tuple(map(jnp.asarray, args)), tuple(map(jnp.asarray, cot)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("cot", ["dy", "ds_final", "both"])
@pytest.mark.parametrize("B,S,H,hd,chunk", [(2, 48, 2, 16, 16),
                                            (1, 36, 3, 8, 9)])
def test_chunked_wkv_vjp_is_the_plain_chunk_forms(plain_launch, cot, B, S,
                                                  H, hd, chunk):
    args, dy, ds = _inputs(B, S, H, hd, seed=S + hd)
    dy = dy if cot in ("dy", "both") else None
    ds = ds if cot in ("ds_final", "both") else None
    got = _torch_grads(functools.partial(ops.wkv6_on_card, chunk=chunk),
                       args, dy, ds)
    assert _build.launch_counts["wkv6_chunked"] == 1
    assert _build.record_counts["wkv6_chunked_backward"] == 1
    want = _torch_grads(functools.partial(ops.wkv6_plain, chunk=chunk),
                        args, dy, ds)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.array_equal(g, w), name
    ref = _jax_grads(args, dy, ds, chunk)
    for name, g, w in zip(NAMES, got, ref):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= VJP_REL * scale, (
            name, np.abs(g - w).max() / scale)


def test_chunked_wkv_forward_is_the_launch_and_grads_keep_dtypes(
        plain_launch):
    """The forward's outputs are the launch's; a bf16 input gets a bf16
    gradient; u's gradient sums over the batch (u is shared); under
    no_grad nothing is recorded."""
    args, dy, _ = _inputs(2, 32, 2, 8, seed=3)
    t = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        y, s = ops.wkv6_on_card(*t, chunk=16)
    yp, sp = ops.wkv6_plain(*t, chunk=16)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    assert _build.record_counts["wkv6_chunked_backward"] == 0
    r = t[0].to(torch.bfloat16).requires_grad_()
    u = t[4].clone().requires_grad_()
    y, _ = ops.wkv6_on_card(r, t[1], t[2], t[3], u, t[5], chunk=16)
    (y * torch.from_numpy(dy)).sum().backward()
    assert r.grad.dtype == torch.bfloat16 and u.grad.shape == u.shape
    u1 = t[4].clone().requires_grad_()
    y1, _ = ops.wkv6_plain(r.detach(), t[1], t[2], t[3], u1, t[5], chunk=16)
    (y1 * torch.from_numpy(dy)).sum().backward()
    assert torch.equal(u.grad, u1.grad)
    assert _build.record_counts["wkv6_chunked_backward"] == 1


def test_k11_no_longer_refuses_autograd_and_k2_still_does():
    """The refusal stays with K2 (JAX's Pallas flash has no backward
    either); K11's wrapper no longer calls it."""
    import inspect

    from repro_torch.kernels.flash_attention import kernel as KF
    assert "refuse_autograd" not in inspect.getsource(K)
    assert "refuse_autograd" in inspect.getsource(KF)
