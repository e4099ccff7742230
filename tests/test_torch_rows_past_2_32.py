"""Rows plans on leaves of 2³² elements or more: what JAX's rows kernels do
there, and the port's matching refusal.

Evaluated on the CPU without a leaf — JAX's ``tile_plan`` is Python over
exact ints, and its in-kernel mask ``_tile_sel_mask`` / sqnorm tile
``_sqnorm_rows_tile`` are jnp functions of a tile index:

* a **pure** plan (every launched tile inside one row-block, no mask) —
  rows(block=1, k=4) on opt-30b's ``w1`` (48, 7168, 28672), whose
  row-block is one layer of 1 568 whole tiles — writes exactly its plan's
  elements, its z counter wrapping at 2³² as K1's does;
* a **masked** plan (tiles straddling row-blocks) forms the flat index in
  uint32 inside the tile, so past 2³² the mask selects by the wrapped index
  and disagrees with the plan: on a (344064, 28672) leaf (the same
  elements, one row of 28 672 per block) tile 32 768 masks 45 056
  elements where the plan selects 40 960;
* the sqnorm kernel (K10's reference) raises: ``jnp.uint32(n)`` overflows.

JAX's mask and its own plan disagree, so the port keeps refusing rows plans
on such leaves (``kernels/zo_fused/rows._plan``): a reference fault,
recorded in ROADMAP Queue 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.zo_fused import rows as jrows
from repro.select.base import leaf_row_blocks
from repro_torch.kernels.zo_fused import rows as trows

W1 = (48, 7168, 28672)                     # opt-30b's w1, 9.87e9 elements
N = int(np.prod(W1))
MASKED = (344064, 28672)                   # the same elements, 1-row blocks
FIRST_PAST = (1 << 32) // jrows.TILE_ELEMS  # the first tile past 2^32


def _plan(shape, phase):
    rb = leaf_row_blocks(jax.ShapeDtypeStruct(shape, jnp.bfloat16), 1, 4,
                         phase)
    sel, pure = jrows.tile_plan(N, rb.block_elems, 4, phase)
    return rb, sel, pure


def _mask_disagreements(t, rb) -> int:
    mask = np.asarray(jrows._tile_sel_mask(
        jnp.int32(t), jrows.BLOCK_COLS, rb.block_elems, rb.k,
        rb.phase)).reshape(-1)
    e = t * jrows.TILE_ELEMS + np.arange(jrows.TILE_ELEMS, dtype=np.int64)
    return int(np.sum(mask != (e // rb.block_elems % rb.k == rb.phase)))


@pytest.mark.parametrize("phase", [0, 1])
def test_pure_plan_writes_its_plan(phase):
    """opt-30b's w1 under rows(1, 4): pure, so no mask runs; the launched
    tiles are exactly the selected layers' tiles."""
    rb, sel, pure = _plan(W1, phase)
    assert pure and rb.block_elems % jrows.TILE_ELEMS == 0
    assert len(sel) * jrows.TILE_ELEMS == rb.selected_elems()
    assert max(sel) * jrows.TILE_ELEMS >= 1 << 32


@pytest.mark.parametrize("phase", [0, 1])
def test_masked_plan_disagrees_past_2_32(phase):
    """Below 2³² the in-kernel mask is the plan; from the first tile past
    2³² it selects by the wrapped index."""
    rb, sel, pure = _plan(MASKED, phase)
    assert not pure
    below = [t for t in sel if t < FIRST_PAST][-3:]
    past = [t for t in sel if t >= FIRST_PAST][:4]
    assert all(_mask_disagreements(t, rb) == 0 for t in below)
    assert all(_mask_disagreements(t, rb) > 0 for t in past)


def test_jax_sqnorm_tile_raises_past_2_32():
    rb, _, _ = _plan(W1, 0)
    with pytest.raises(OverflowError):
        jrows._sqnorm_rows_tile(jnp.int32(FIRST_PAST), jrows.BLOCK_COLS,
                                jnp.int32(3), N, rb.block_elems, 4, 0,
                                "gaussian", False)


@pytest.mark.parametrize("n", [1 << 32, N])
def test_port_refuses_rows_plans_past_2_32(n):
    """The port's K7–K10 plans refuse such a leaf, naming the reference
    fault; one element fewer is planned."""
    with pytest.raises(ValueError, match="wrapped index"):
        trows.selected_count(n, 205520896, 4, 1)
    assert trows.selected_count((1 << 32) - 1, 1 << 20, 4, 1) > 0
