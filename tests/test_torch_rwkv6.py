"""Port parity of the ssm family: K11 ``wkv6_chunked`` (its plain version,
the route a CPU tensor takes), ``time_mix`` in both scan modes, the decode
step, and the rwkv6 forward and loss, against the JAX package on the
rwkv6-3b smoke config in f32.

* The plain K11 against JAX's ``ops.wkv6`` (the Pallas kernel in interpret
  mode) and ``wkv6_ref`` over ``test_kernels.py``'s sweep, at C ∈ {1, 9}
  and at the logit clamp's extremes (log w = −e and −e⁻⁸), at JAX's own
  tolerances (atol 5e-4, rtol 1e-3).  Against the interpret kernel — the
  same factorization, another rounding order — the gap is far tighter:
  max |Δ| ≤ ``INTERP_REL`` · max |y| (measured ≤ 2.6e-6 on this sweep).
* ``time_mix`` (chunk: K11; fused_recurrent: ``wkv6_ref``) and
  ``time_mix_decode`` against JAX's at ``test_rwkv_ssm.py``'s tolerances
  (2e-5 / 1e-4; 1e-5 / 1e-4 for the decode chain), with no state, a carried
  state (the port's ``RWKVLayerState`` through ``convert``), a sequence that
  C does not divide, and a 16-step decode chain equal to one full pass.
* The forward's logits and final state, and the loss, at 1e-4.

``tests/data/wkv6_golden.npz`` holds JAX's ``wkv6_chunked(interpret=True)``
and ``wkv6_ref`` on two hd = 64 cases (C = 16 and C = 9); the machine with
the card has no JAX, so ``chip_smoke.py`` and ``test_torch_cuda.py`` hold
the CUDA K11 to it.  Regenerate with
``PYTHONPATH=src python tests/test_torch_rwkv6.py``.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.models.rwkv6 as JR
from repro.kernels.rwkv6 import kernel as jkernel
from repro.kernels.rwkv6 import ops as jops
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.models.common import KeyGen
from repro_torch import convert
from repro_torch.kernels.rwkv6 import ops as tops
from repro_torch.kernels.rwkv6.kernel import wkv6_chunked, wkv6_chunked_plain
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models import all_archs, bundle
import repro_torch.models.rwkv6 as TR

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" / "wkv6_golden.npz"
K_ATOL, K_RTOL = 5e-4, 1e-3          # test_kernels.py's kernel tolerance
INTERP_REL = 1e-5                    # port vs interpret, relative to max|y|
TM_ATOL, TM_RTOL = 2e-5, 1e-4        # test_rwkv_ssm.py's time_mix tolerance
FWD_ATOL = 1e-4
# (BH, S, hd, chunk): C = 16, the envelope, and C = 9, a ragged prompt's
GOLDEN_CASES = ((2, 48, 64, 16), (1, 36, 64, 9))


def _inputs(B, S, H, hd, seed=0, lw=None):
    """r/k/v (B,S,H,hd), the log decay (random in the clamp's range, or
    constant ``lw``), u (H,hd), s0 (B,H,hd,hd), f32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    sh = (B, S, H, hd)
    r, k, v = (rng.standard_normal(sh).astype(np.float32) for _ in range(3))
    if lw is None:
        logw = -np.exp(np.clip(rng.standard_normal(sh), -8, 1))
    else:
        logw = np.full(sh, lw)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw.astype(np.float32), u, s0


def _fold(x):
    B, S, H, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


def _check_k11(args, chunk):
    B, S, H, hd = args[0].shape
    yj, sj = (np.asarray(a) for a in jops.wkv6(*map(jnp.asarray, args),
                                                 chunk=chunk))
    r, k, v, lw, u, s0 = args
    yr, sr = jax_wkv6_ref(*(jnp.asarray(_fold(a)) for a in (r, k, v, lw)),
                          jnp.asarray(np.broadcast_to(u[None], (B, H, hd))
                                      .reshape(B * H, 1, hd)),
                          jnp.asarray(s0.reshape(B * H, hd, hd)))
    yr = np.asarray(yr).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    sr = np.asarray(sr).reshape(B, H, hd, hd)
    yt, st = tops.wkv6(*map(torch.from_numpy, args), chunk=chunk)
    yt, st = yt.numpy(), st.numpy()
    for got, kern, ref in ((yt, yj, yr), (st, sj, sr)):
        np.testing.assert_allclose(got, ref, atol=K_ATOL, rtol=K_RTOL)
        np.testing.assert_allclose(got, kern, atol=K_ATOL, rtol=K_RTOL)
        assert np.abs(got - kern).max() <= INTERP_REL * np.abs(kern).max()


@pytest.mark.parametrize("S,H,hd,chunk", [
    (64, 2, 32, 16), (128, 3, 64, 16), (48, 1, 16, 16), (64, 2, 32, 8),
])
def test_plain_k11_matches_jax_sweep(S, H, hd, chunk):
    _check_k11(_inputs(2, S, H, hd), chunk)


@pytest.mark.parametrize("hd", [32, 96, 128])
def test_plain_k11_matches_jax_at_head_dims(hd):
    """Head dims beside rwkv6's 64: 96, which the CUDA kernel runs at its
    128 instance with zero channels, and the instances 32 and 128."""
    _check_k11(_inputs(1, 32, 2, hd, seed=4), 16)


@pytest.mark.parametrize("S,hd,chunk", [(18, 16, 1), (36, 64, 9)],
                         ids=["C1", "C9"])
def test_plain_k11_matches_jax_at_runtime_chunks(S, hd, chunk):
    _check_k11(_inputs(2, S, 2, hd, seed=1), chunk)


@pytest.mark.parametrize("lw", [-np.e, -np.exp(-8.0)],
                         ids=["rate-e", "rate-e^-8"])
def test_plain_k11_matches_jax_at_the_clamp(lw):
    """The clamp's extremes at C = 16: exponents up to 16·e ≈ 43.5."""
    _check_k11(_inputs(2, 64, 2, 32, seed=2, lw=lw), 16)


def test_plain_k11_kernel_layout_equals_model_layout():
    """``wkv6_chunked`` on JAX's (BH, S, hd) layout equals ``ops.wkv6`` on
    the model's, and the chunked form equals the exact recurrence."""
    r, k, v, lw, u, s0 = map(torch.from_numpy, _inputs(2, 32, 3, 16, seed=3))
    B, S, H, hd = r.shape
    fold = lambda x: x.transpose(1, 2).reshape(B * H, S, hd)  # noqa: E731
    ub = u[None].expand(B, H, hd).reshape(B * H, 1, hd)
    y, s = wkv6_chunked(fold(r), fold(k), fold(v), fold(lw), ub,
                        s0.reshape(B * H, hd, hd), chunk=16)
    ym, sm = tops.wkv6(r, k, v, lw, u, s0, chunk=16)
    assert torch.equal(fold(ym), y) and torch.equal(sm.reshape(-1, hd, hd), s)
    yr, sr = wkv6_ref(fold(r), fold(k), fold(v), fold(lw), ub,
                      s0.reshape(B * H, hd, hd))
    torch.testing.assert_close(y, yr, atol=K_ATOL, rtol=K_RTOL)
    torch.testing.assert_close(s, sr, atol=K_ATOL, rtol=K_RTOL)
    with pytest.raises(ValueError, match="not a multiple"):
        wkv6_chunked_plain(fold(r), fold(k), fold(v), fold(lw), ub,
                           s0.reshape(B * H, hd, hd), chunk=5)


# --------------------------------------------------------------------------- #
# The golden fixture (what the card is held to)
# --------------------------------------------------------------------------- #
def make_golden() -> dict:
    out = {}
    for i, (BH, S, hd, chunk) in enumerate(GOLDEN_CASES):
        r, k, v, lw, u, s0 = _inputs(BH, S, 1, hd, seed=10 + i)
        fold = [jnp.asarray(_fold(a)) for a in (r, k, v, lw)]
        uj = jnp.asarray(u.reshape(1, 1, hd).repeat(BH, 0))
        sj = jnp.asarray(s0.reshape(BH, hd, hd))
        yk, sk = jkernel.wkv6_chunked(*fold, uj, sj, chunk=chunk,
                                      interpret=True)
        yr, sr = jax_wkv6_ref(*fold, uj, sj)
        for name, a in (("r", fold[0]), ("k", fold[1]), ("v", fold[2]),
                        ("lw", fold[3]), ("u", uj), ("s0", sj), ("y", yk),
                        ("s", sk), ("y_ref", yr), ("s_ref", sr)):
            out[f"{name}_{i}"] = np.asarray(a, np.float32)
        out[f"chunk_{i}"] = np.asarray(chunk, np.int64)
    return out


def test_golden_fixture_is_what_jax_computes():
    stored = np.load(GOLDEN)
    fresh = make_golden()
    assert sorted(stored.files) == sorted(fresh)
    for name, a in fresh.items():
        if name[0] in "rkvlu" or name.startswith(("s0", "chunk")):
            assert np.array_equal(stored[name], a), name     # the inputs
        else:   # XLA:CPU's float bits may vary by host (ROADMAP Queue 3)
            np.testing.assert_allclose(stored[name], a, atol=1e-6, rtol=1e-6)
    assert GOLDEN.stat().st_size < 512 * 1024


def test_plain_k11_matches_golden_fixture():
    g = np.load(GOLDEN)
    for i in range(len(GOLDEN_CASES)):
        ins = [torch.from_numpy(g[f"{n}_{i}"]) for n in
               ("r", "k", "v", "lw", "u", "s0")]
        y, s = wkv6_chunked(*ins, chunk=int(g[f"chunk_{i}"]))
        for got, key in ((y, "y"), (s, "s")):
            np.testing.assert_allclose(got.numpy(), g[f"{key}_{i}"],
                                       atol=K_ATOL, rtol=K_RTOL)
            np.testing.assert_allclose(got.numpy(), g[f"{key}_ref_{i}"],
                                       atol=K_ATOL, rtol=K_RTOL)


# --------------------------------------------------------------------------- #
# time_mix, decode, forward, loss
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tm_setup():
    """JAX's smoke TimeMix layer with a nonzero decay LoRA and logit, as in
    test_rwkv_ssm.py, plus a nonzero bonus; x (2, 48, d)."""
    cfg = jax_archs()["rwkv6-3b"].smoke_cfg
    p = dict(JR.rwkv_layer_params(cfg, KeyGen(jax.random.PRNGKey(0)),
                                  jnp.float32)["tm"])
    rng = np.random.default_rng(7)
    p["w_lora_b"] = rng.standard_normal(p["w_lora_b"].shape) * 0.5
    p["w0"] = rng.standard_normal(p["w0"].shape)
    p["u"] = rng.standard_normal(p["u"].shape)
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    return cfg, all_archs()["rwkv6-3b"].smoke_cfg, p, x


def _state(cfg, seed):
    rng = np.random.default_rng(seed)
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return JR.RWKVLayerState(
        rng.standard_normal((2, d)).astype(np.float32),
        np.zeros((2, d), np.float32),
        rng.standard_normal((2, H, hd, hd)).astype(np.float32))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tm_close(t_out, j_out, atol=TM_ATOL, rtol=TM_RTOL):
    ty, (tsh, tw) = t_out
    jy, (jsh, jw) = j_out
    for a, b in ((ty, jy), (tsh, jsh), (tw, jw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("mode", ["chunk", "fused_recurrent"])
@pytest.mark.parametrize("case", ["no_state", "carried_state", "S37"])
def test_time_mix_matches_jax(tm_setup, mode, case):
    jcfg, tcfg, p, x = tm_setup
    st = _state(jcfg, 4) if case == "carried_state" else None
    if case == "S37":                      # 37 = 2·16 + 5: identity padding
        x = x[:, :37]
    jfn = JR.time_mix if mode == "chunk" else JR.time_mix_ref
    tfn = TR.time_mix if mode == "chunk" else TR.time_mix_ref
    want = jfn(jcfg, _jax(p), jnp.asarray(x), None if st is None else _jax(st))
    got = tfn(tcfg, convert.params_from_jax(p), torch.from_numpy(x),
              None if st is None else convert.params_from_jax(st))
    _tm_close(got, want)


def test_decode_chain_matches_full_pass_and_jax(tm_setup):
    jcfg, tcfg, p, x = tm_setup
    tp = convert.params_from_jax(p)
    xt = torch.from_numpy(x[:, :16])
    full = TR.time_mix(tcfg, tp, xt, None)
    zeros = np.zeros((2, tcfg.d_model), np.float32)
    cur = convert.params_from_jax(JR.RWKVLayerState(
        zeros, zeros, np.zeros((2, tcfg.n_heads, tcfg.hd, tcfg.hd),
                               np.float32)))
    jcur = JR.RWKVLayerState(*_jax(convert.params_to_jax(cur)))
    ys = []
    for t in range(16):
        y, (sh, wkv) = TR.time_mix_decode(tcfg, tp, xt[:, t:t + 1], cur)
        jy, (jsh, jwkv) = JR.time_mix_decode(jcfg, _jax(p),
                                             jnp.asarray(x[:, t:t + 1]), jcur)
        _tm_close((y, (sh, wkv)), (jy, (jsh, jwkv)))
        cur = TR.RWKVLayerState(sh, cur.shift_cm, wkv)
        jcur = JR.RWKVLayerState(jsh, jcur.shift_cm, jwkv)
        ys.append(y)
    _tm_close((torch.cat(ys, 1), (cur.shift_tm, cur.wkv)), full,
              atol=1e-5, rtol=1e-4)
    # one step with a state goes to the decode path in both modes
    one = TR.time_mix(tcfg, tp, xt[:, :1], cur, mode="chunk")
    _tm_close(one, TR.time_mix_decode(tcfg, tp, xt[:, :1], cur), 0, 0)
    with pytest.raises(ValueError, match="unknown scan mode"):
        TR.time_mix(tcfg, tp, xt, None, mode="scan")


@pytest.fixture(scope="module")
def weights():
    """The smoke model with a nonzero decay LoRA, logit and bonus."""
    cfg = jax_archs()["rwkv6-3b"].smoke_cfg
    w = jax.tree.map(np.asarray, jax_bundle(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    tm = w["layers"]["tm"]
    for name, scale in (("w_lora_b", 0.5), ("w0", 1.0), ("u", 1.0)):
        tm[name] = (rng.standard_normal(tm[name].shape)
                    * scale).astype(np.float32)
    return w


@pytest.mark.parametrize("mode", ["chunk", "fused_recurrent"])
def test_forward_and_loss_match_jax(weights, mode):
    jcfg = jax_archs()["rwkv6-3b"].smoke_cfg.replace(scan_mode=mode)
    tcfg = all_archs()["rwkv6-3b"].smoke_cfg.replace(scan_mode=mode)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, 256, (2, 40)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 40)).astype(np.int32),
             "loss_mask": (rng.random((2, 40)) > 0.2).astype(np.float32)}
    tw = convert.params_from_jax(weights)
    jl, js = JR.forward(jcfg, _jax(weights), tokens=jnp.asarray(batch["tokens"]))
    tl, ts = TR.forward(tcfg, tw, tokens=torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_ATOL,
                               rtol=0)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL,
                                   rtol=0)
    jloss = jax_bundle(jcfg).loss_fn()(_jax(weights), _jax(batch))
    tloss = bundle(tcfg).loss_fn()(tw, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) < FWD_ATOL
    logits = bundle(tcfg).train_logits_fn()(tw, {"tokens": torch.from_numpy(
        batch["tokens"])})
    assert torch.equal(logits, tl)


def test_prefill_and_decode_match_jax(weights):
    """The registry's serving surface: prefill from the zero state (the
    chunk scan), then one lockstep decode carrying the state."""
    jcfg = jax_archs()["rwkv6-3b"].smoke_cfg
    tcfg = all_archs()["rwkv6-3b"].smoke_cfg
    jb, tb = jax_bundle(jcfg), bundle(tcfg)
    tw = convert.params_from_jax(weights)
    toks = np.random.default_rng(10).integers(0, 256, (2, 21)).astype(np.int32)
    jl, jst = jb.prefill_fn()(_jax(weights), {"tokens": jnp.asarray(toks)})
    tl, tst = tb.prefill_fn()(tw, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_ATOL)
    nxt = toks[:, -1:]
    jl2, jst2 = jb.decode_fn()(_jax(weights), {
        "token": jnp.asarray(nxt), "state": jst,
        "cache_pos": jnp.asarray([21, 21], jnp.int32)})
    tl2, tst2 = tb.decode_fn()(tw, {"token": torch.from_numpy(nxt),
                                    "state": tst,
                                    "cache_pos": torch.tensor([21, 21])})
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=FWD_ATOL)
    for a, b in zip(tst2, jst2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL)
    with pytest.raises(NotImplementedError, match="legacy whole-prompt"):
        tb.chunk_prefill_fn()
    assert tb.default_selection() == jb.default_selection() == "full"


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **make_golden())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
