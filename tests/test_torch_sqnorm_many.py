"""Port parity: K6 over many leaves in one call (``zo_sqnorm_many``) and the
sphere rescale built on it.

``zo_sqnorm_many`` measures every whole leaf of a sphere pass in one launch
on the card; each leaf's norm must keep the bits ``zo_sqnorm`` gives it
alone (the fixed per-tile order of ``zo_sqnorm_plain``), and stay within
``SQNORM_RTOL`` of JAX's ``zo_sqnorm_ref``.  ``CounterBackend._sphere_scale``
makes one such call for its whole leaves and one K10 call per partial rows
plan, and folds the norms in leaf order exactly as a per-leaf fold would.
On the CPU every call runs the plain versions; the kernels are held to
them on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.zo_fused.multi import zo_sqnorm_ref
from repro_torch.kernels.zo_fused.multi import (SQNORM_RTOL, TILE_ELEMS,
                                                zo_sqnorm, zo_sqnorm_many,
                                                zo_sqnorm_many_plain,
                                                zo_sqnorm_plain)
from repro_torch.kernels.zo_fused.rows import zo_sqnorm_rows_plain
from repro_torch.models import all_archs, bundle
from repro_torch.perturb import CounterBackend, StreamRef, prng_key
from repro_torch.perturb.counter import _active, _leaf_blocks
from repro_torch.perturb.stream import leaf_seed
from repro_torch.select import parse_selection
from repro_torch.tree_utils import tree_leaves

torch.set_num_threads(1)   # small tensors: no oversubscription under xdist

SIZES = [1, TILE_ELEMS - 1, TILE_ELEMS, TILE_ELEMS + 1, 3 * TILE_ELEMS + 5]
SEEDS = [11, -5, 2**31 - 1, 977, 3, 123456789, -2**31, 42]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _leaves(n: int, count: int) -> tuple:
    """``count`` leaves around ``n`` elements (n, n + 7, n + 2·7, … on the
    odd positions; n on the even ones) with distinct seeds."""
    ns = [n + 7 * (i % 2) * (i // 2 + 1) for i in range(count)]
    seeds = [SEEDS[i % len(SEEDS)] + 1000 * (i // len(SEEDS))
             for i in range(count)]
    return ns, seeds


@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("count", [1, 3, 15])
@pytest.mark.parametrize("n", SIZES)
def test_many_plain_is_the_per_leaf_plain_bitwise(n, count, dist):
    ns, seeds = _leaves(n, count)
    got = zo_sqnorm_many_plain(ns, seeds, dist)
    assert got.shape == (count,) and got.dtype == torch.float32
    want = torch.stack([zo_sqnorm_plain(m, s, dist)
                        for m, s in zip(ns, seeds)])
    assert np.array_equal(_bits(got), _bits(want))
    # the wrapper on a CPU device is the plain version
    assert np.array_equal(_bits(zo_sqnorm_many(ns, seeds, dist)), _bits(want))


@pytest.mark.parametrize("n", SIZES)
def test_many_within_tolerance_of_jax_per_leaf(n):
    ns, seeds = _leaves(n, 3)
    got = zo_sqnorm_many(ns, seeds, "gaussian")
    for m, s, norm in zip(ns, seeds, got):
        want = float(zo_sqnorm_ref(m, s))
        assert abs(float(norm) - want) <= SQNORM_RTOL * want


def test_single_leaf_entry_is_the_many_call():
    """``zo_sqnorm`` is ``zo_sqnorm_many`` on one leaf: a 0-d f32 tensor
    with the same bits."""
    one = zo_sqnorm(TILE_ELEMS + 1, 5)
    assert one.dim() == 0 and one.dtype == torch.float32
    assert np.array_equal(_bits(one.reshape(1)),
                          _bits(zo_sqnorm_many([TILE_ELEMS + 1], [5])))


@pytest.mark.parametrize("ns,seeds", [([], []), ([5, 0], [1, 2]),
                                      ([3, -1], [1, 2]), ([3], [1, 2])],
                         ids=["empty", "zero", "negative", "seed-count"])
def test_bad_leaf_lists_are_refused(ns, seeds):
    with pytest.raises(ValueError):
        zo_sqnorm_many(ns, seeds)
    with pytest.raises(ValueError):
        zo_sqnorm_many_plain(ns, seeds)


def test_unknown_dist_is_refused():
    with pytest.raises(NotImplementedError):
        zo_sqnorm_many([3], [1], "sphere")


# --------------------------------------------------------------------------- #
# The sphere rescale: one K6 call for the whole leaves, folded in leaf order
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def smoke_params():
    cfg = all_archs()["qwen2-0.5b"].smoke_cfg
    return bundle(cfg).init(0, device="cpu")


def _per_leaf_scale(params, ref) -> np.float32:
    """sqrt(d)/‖z‖ with one plain K6 (whole leaf) or K10 (partial rows
    plan) per selected leaf, folded in leaf order in f32."""
    seed = ref.counter_seed()
    mask, blocks = ref.selection_mask(params), ref.selection_blocks(params)
    d, sq = 0, None
    for i, p in enumerate(tree_leaves(params)):
        if not _active(p, mask, i):
            continue
        rb = _leaf_blocks(blocks, i)
        if rb is None:
            d += p.numel()
            part = zo_sqnorm_plain(p.numel(), leaf_seed(seed, i))
        else:
            d += rb.selected_elems()
            part = zo_sqnorm_rows_plain(p.numel(), leaf_seed(seed, i),
                                        rb.block_elems, rb.k, rb.phase)
        part = np.float32(part.item())
        sq = part if sq is None else np.float32(sq + part)
    return np.float32(np.sqrt(np.float32(np.float32(d) / sq)))


@pytest.mark.parametrize("spec,step,whole", [
    (None, 0, {True}), (None, 3, {True}),
    ("rows(block=1,k=4)", 0, {False}), ("rows(block=1,k=4)", 3, {False}),
    ("rows(block=2,k=4)", 0, {True, False}),
    ("rows(block=2,k=4)", 3, {False})],
    ids=["whole-0", "whole-3", "rows-0", "rows-3", "mixed-0", "rows2-3"])
def test_sphere_scale_is_the_per_leaf_fold_bitwise(smoke_params, spec, step,
                                                   whole):
    """Unselected (every leaf whole: one K6 call), under rows(1,4) (every
    leaf a partial plan on the smoke tree: K10 only) and under rows(2,4) at
    phase 0 (the two-row stacked leaves whole, the embeddings partial: one
    K6 call and K10 calls interleaved in leaf order)."""
    ref = StreamRef.derive(prng_key(4), step, 1)
    if spec is not None:
        ref = ref.with_selection(parse_selection(spec), step)
    blocks = ref.selection_blocks(smoke_params)
    assert {_leaf_blocks(blocks, i) is None
            for i in range(len(tree_leaves(smoke_params)))} == whole
    got = CounterBackend()._sphere_scale(smoke_params, ref)
    want = _per_leaf_scale(smoke_params, ref)
    assert np.float32(got).view(np.uint32) == want.view(np.uint32)
