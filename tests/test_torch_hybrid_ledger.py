"""A hymba-1.5b ledger that JAX trains replays in the port: 3 MeZO steps
of the smoke config in f32 on the CPU, on ``xla`` and on
``pallas-interpret`` (``pallas+z2``), replayed through
``composition_for_ledger`` against JAX's ``replay`` leaf by leaf.  Every
leaf is bitwise JAX's but one on the ``xla`` stream (see
``XLA_OTHER_CONTRACTION``); ``mix`` and ``a_log``, hymba's tiny leaves, are
among those written.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import zo as jzo
from repro.core import TrajectoryLedger as JaxLedger
from repro.core import replay as jax_replay
from repro.data.pipeline import DataSpec as JaxSpec
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.models import all_archs as jax_archs
from repro.models import bundle as jax_bundle
from repro.train.loop import train as jax_train
from repro_torch import convert
from repro_torch.core import TrajectoryLedger, replay
from repro_torch.models import all_archs, bundle
from repro_torch.serve.tenants import composition_for_ledger

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def weights():
    """The port's seeded smoke θ, as numpy for both sides."""
    return convert.params_to_jax(bundle(all_archs()[ARCH].smoke_cfg).init(
        0, device="cpu"))


#: f32 leaves whose replay write XLA:CPU contracts as fma(z, b, θ) where
#: every other shape gets θ + rn(z·b) (a minor dim of 3–5 under a
#: second-minor dim of 8 or more, under jax 0.9.0; ROADMAP Queue 3): the
#: port writes one rule, so these are held within one f32 ulp a record (at
#: the magnitude each write rounds at)
XLA_OTHER_CONTRACTION = {"['layers']['ssm']['dt_proj']"}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_jax_trained_hybrid_ledger_replays_bitwise(weights, backend):
    """JAX trains hymba-smoke 3 MeZO steps on ``xla`` or
    ``pallas-interpret``; the port replays the ledger to JAX's replay bit
    for bit (``mix`` and ``a_log`` among the leaves written), but for the
    ``xla`` stream's ``dt_proj`` (2, 64, 4), whose write XLA:CPU contracts
    otherwise: within one f32 ulp a record there, not bitwise (the
    difference is XLA's shape-dependent contraction, recorded)."""
    jcfg = jax_archs()[ARCH].smoke_cfg
    jback = "pallas-interpret" if backend == "pallas" else "xla"
    opt = jzo.mezo(lr=1e-3, eps=1e-3, backend=jback)
    led = JaxLedger(base_seed=5, grad_dtype="float32",
                    backend=opt.backend_name)
    jax_train(jax_bundle(jcfg).loss_fn(), jax.tree.map(jnp.asarray, weights),
              opt, JaxPipeline(JaxSpec("lm", batch=2, seq=24, vocab=256,
                                       seed=6)),
              total_steps=3, ledger=led, seed=5, log_every=10)
    raw = led.to_bytes()
    want = jax_replay(jax.tree.map(jnp.asarray, weights),
                      JaxLedger.from_bytes(raw), jzo.mezo(backend=jback))
    tled = TrajectoryLedger.from_bytes(raw)
    got = replay(convert.params_from_jax(weights), tled,
                 composition_for_ledger(tled))
    wl = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    gl = jax.tree_util.tree_leaves(convert.params_to_jax(got))
    moved, other = set(), set()
    for (path, a), b, c in zip(wl, gl, jax.tree_util.tree_leaves(weights)):
        name = jax.tree_util.keystr(path)
        if not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
            assert backend == "xla" and name in XLA_OTHER_CONTRACTION
            # one rounding per record, three records, each at most one ulp
            # of the magnitude it rounds at: at most |θ₀| plus every
            # record's |η·g|·|z| (|z| < 6)
            mag = np.abs(c) + 6 * sum(abs(lr * g) for lr, g in
                                      zip(tled.lrs, tled.grads))
            assert np.all(np.abs(b - a) <= 3 * np.spacing(
                mag.astype(np.float32)))
            other.add(name)
        if not np.array_equal(a, c):
            moved.add(name)
    assert {"['layers']['mix']", "['layers']['ssm']['a_log']"} <= moved
    assert other <= XLA_OTHER_CONTRACTION
