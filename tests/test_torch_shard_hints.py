"""The activation-sharding hook of ``repro_torch.models.common``
(``set_shard_resolver`` / ``shard_resolver`` / ``shard_hint``) against
JAX's ``repro.models.common``:

* a recording resolver captures the ``(logical, shape)`` sequence of one
  forward per family (dense, moe, ssm, hybrid, encdec, a LoRA tree and a
  prefix tree) at smoke width, and it equals JAX's sequence for the same
  config — JAX with ``scan_layers=False`` (a scanned body is traced once,
  so its per-layer sites are consulted once; the port runs layer by layer);
  JAX's prefix forward always scans, so it is compared at one layer;
* the per-layer sites scale with depth (the count ``chip_smoke.py``'s phase
  (z) checks at qwen2-0.5b's 24 layers);
* no resolver is the identity, and a resolver on plain tensors changes no
  bit of the logits;
* under a resolver a ``DTensor`` activation is redistributed to the
  resolver's spec (a one-rank ``gloo`` mesh);
* no module of ``repro_torch.models`` imports the distributed layer.
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import bundle as jax_bundle
from repro.models import common as jcommon
from repro.models import family_arch as jax_family_arch
from repro.models import peft as jpeft
from repro_torch import convert
from repro_torch.distributed import make_activation_resolver
from repro_torch.distributed.sharding import P
from repro_torch.models import bundle, common, family_arch
from repro_torch.models import peft
from repro_torch.perturb.stream import prng_key

torch.set_num_threads(1)   # tiny tensors: no oversubscription under xdist

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape.keys())


def _recorder(seen):
    def fn(logical, shape):
        seen.append((logical, tuple(int(s) for s in shape)))
        return None
    return fn


def _jax_sequence(loss_fn, *args):
    """JAX consults the resolver while it traces: ``make_jaxpr`` records
    the sequence without compiling or running the forward."""
    seen: list = []
    with jcommon.shard_resolver(_recorder(seen)):
        jax.make_jaxpr(loss_fn)(*args)
    return seen


def _port_sequence(loss_of):
    seen: list = []
    with common.shard_resolver(_recorder(seen)):
        with torch.no_grad():
            loss_of()
    return seen


def _family(fam, layers=None):
    jcfg = jax_family_arch(fam).replace(scan_layers=False)
    tcfg = family_arch(fam)
    if layers is not None:
        jcfg, tcfg = jcfg.replace(n_layers=layers), tcfg.replace(
            n_layers=layers)
    return jcfg, tcfg


@pytest.mark.parametrize("fam", FAMILIES)
def test_recorded_sequence_equals_jax(fam):
    jcfg, tcfg = _family(fam)
    jb, tb = jax_bundle(jcfg), bundle(tcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    jbatch = jb.make_batch(jax.random.PRNGKey(1), 2, 16)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    tbatch = tb.make_batch(prng_key(1), 2, 16, device="cpu")
    want = _jax_sequence(jb.loss_fn(), jp, jbatch)
    got = _port_sequence(lambda: tb.loss_fn()(tp, tbatch))
    assert got == want
    assert len(got) >= 2 + jcfg.n_layers


@pytest.mark.parametrize("mode", ["lora", "prefix"])
def test_recorded_sequence_peft_equals_jax(mode):
    jcfg, tcfg = _family("dense", layers=2 if mode == "lora" else 1)
    jb, tb = jax_bundle(jcfg), bundle(tcfg)
    jbase = jb.init(jax.random.PRNGKey(0))
    jbatch = jb.make_batch(jax.random.PRNGKey(1), 2, 16)
    if mode == "lora":
        jtree = jpeft.init_lora(jcfg, jax.random.PRNGKey(2), rank=2)
    else:
        jtree = jpeft.init_prefix(jcfg, jax.random.PRNGKey(2), m=3)
    jmerged = jpeft.peft_params(jbase, jtree, mode)
    tmerged = convert.params_from_jax(jax.tree.map(np.asarray, jmerged))
    tbatch = tb.make_batch(prng_key(1), 2, 16, device="cpu")
    want = _jax_sequence(jpeft.peft_loss_fn(jcfg, mode), jmerged, jbatch)
    got = _port_sequence(lambda: peft.peft_loss_fn(tcfg, mode)(
        tmerged, tbatch))
    assert got == want and got


def test_per_layer_sites_scale_with_depth():
    """dense: act_btd after the embedding, then per layer act_heads,
    act_kv_heads, act_ff, act_btd, then act_vocab — 2 + 4·L."""
    for layers in (1, 3):
        _, tcfg = _family("dense", layers=layers)
        tb = bundle(tcfg)
        params = tb.init(0, device="cpu")
        batch = tb.make_batch(prng_key(1), 2, 8, device="cpu")
        seq = _port_sequence(lambda: tb.loss_fn()(params, batch))
        names = [s[0] for s in seq]
        assert names == (["act_btd"] + ["act_heads", "act_kv_heads",
                                        "act_ff", "act_btd"] * layers
                         + ["act_vocab"])


@pytest.mark.parametrize("fam", ["dense", "moe", "hybrid"])
def test_resolver_is_identity_on_plain_tensors(fam):
    _, tcfg = _family(fam)
    tb = bundle(tcfg)
    params = tb.init(0, device="cpu")
    batch = tb.make_batch(prng_key(1), 2, 16, device="cpu")
    logits = tb.train_logits_fn()
    with torch.no_grad():
        plain = logits(params, batch)
        resolver = make_activation_resolver(
            FakeMesh({"data": 2, "model": 2}), tcfg)
        with common.shard_resolver(resolver):
            hinted = logits(params, batch)
        common.set_shard_resolver(resolver)
        try:
            hinted2 = logits(params, batch)
        finally:
            common.set_shard_resolver(None)
        again = logits(params, batch)
    assert torch.equal(plain, hinted) and torch.equal(plain, hinted2)
    assert torch.equal(plain, again)
    x = torch.randn(2, 3, 4)
    assert common.shard_hint(x, "act_btd") is x


def test_shard_hint_redistributes_a_dtensor(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_elastic_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_elastic_mesh(device="cpu")
        x = torch.randn(4, 6, 8)
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        calls = []

        def resolver(logical, shape):
            calls.append((logical, shape))
            return make_activation_resolver(mesh)(logical, shape)

        with common.shard_resolver(resolver):
            y = common.shard_hint(dx, "act_ff")
            z = common.shard_hint(dx, "act_heads")     # 3-d: no spec
        assert calls == [("act_ff", (4, 6, 8)), ("act_heads", (4, 6, 8))]
        assert make_activation_resolver(mesh)("act_ff", (4, 6, 8)) == \
            P("data", None, "model")
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert torch.equal(y.full_tensor(), x)
        assert z is dx
    finally:
        dist.destroy_process_group()


def test_models_do_not_import_the_distributed_layer():
    # the hook calls the resolver and the spec's own ``placements``: the
    # models' layer sits below ``repro_torch.distributed`` and never
    # imports it
    import ast
    import pathlib
    found = []
    for f in sorted(pathlib.Path(common.__file__).parent.glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            found += [(f.name, n) for n in names
                      if n.startswith("repro_torch.distributed")]
    assert found == []
