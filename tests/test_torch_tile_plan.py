"""The host-side tile plan of the int8-weight GEMMs #7 and #6 (bf16 x).

``ops/kernels/quant_matmul.py::tile_plan`` chooses, from (M, N, K), the
activation rows of a tile, the K split over a thread-block cluster and
whether TMA loads each operand; the CUDA kernel (``csrc/quant_matmul.cu``,
``qm_kernel``) takes the plan as it is. These tests pin the plan at the
shapes ``chip_smoke.py`` runs and the rules it keeps at every shape. They
need no card: the plan is plain Python.
"""

import itertools

import pytest

from apertis_llm_torch.ops.kernels.quant_matmul import (
    CHUNK_BYTES, MAX_SPLIT, ROW_TILES, SPLIT_CHUNKS, SPLIT_ROWS, TILE_COLS, TilePlan,
    tile_plan)

H100_SMS = 132


@pytest.mark.parametrize("m,k,n,x_bytes,plan", [
    # prefill at 2048 rows: 256-row tiles, 8 x 76 tiles, no split
    (2048, 2432, 9728, 1, TilePlan(256, 1, True, True)),
    (2048, 9728, 2432, 1, TilePlan(256, 1, True, True)),
    (2048, 2432, 9728, 2, TilePlan(256, 1, True, True)),
    # the int8 head (N = 32000: 250 column tiles) needs no split
    (64, 2432, 32000, 1, TilePlan(64, 1, True, True)),
    (4, 2432, 32000, 1, TilePlan(16, 1, True, True)),
    # the MHA model's fused QKV (57 tiles): 19 K chunks of int8 x are too
    # few to split, 38 of bf16 x split in two; w2 (19 tiles, 76 chunks) in
    # four; the o-projection (19 tiles, 19 chunks) not at all
    (64, 2432, 7296, 1, TilePlan(64, 1, True, True)),
    (64, 2432, 7296, 2, TilePlan(64, 2, True, True)),
    (64, 9728, 2432, 1, TilePlan(64, 4, True, True)),
    (64, 9728, 2432, 2, TilePlan(64, 4, True, True)),
    (1, 2432, 2432, 1, TilePlan(16, 1, True, True)),
    # #6 on w1 at 64 rows: 76 tiles fill more than half the SMs
    (64, 2432, 9728, 2, TilePlan(64, 1, True, True)),
    (100, 2432, 2432, 1, TilePlan(128, 1, True, True)),
    (300, 704, 704, 1, TilePlan(256, 1, True, True)),
    # N = 44 (the MoE mixer's x_param_proj): weight rows of 44 bytes
    (37, 608, 44, 1, TilePlan(64, 1, True, False)),
    (2048, 608, 44, 1, TilePlan(256, 1, True, False)),
    # K = 597: x rows of 597 bytes (int8) or 1194 bytes (bf16)
    (17, 597, 44, 1, TilePlan(64, 1, False, False)),
    (17, 597, 44, 2, TilePlan(64, 1, False, False)),
    (33, 597, 64, 1, TilePlan(64, 1, False, True)),
    # a split with both operands staged by hand: 32 chunks (int8), 63 (bf16)
    (17, 4001, 44, 1, TilePlan(64, 2, False, False)),
    (17, 4001, 44, 2, TilePlan(64, 3, False, False)),
])
def test_plan_at_the_smoke_shapes(m, k, n, x_bytes, plan):
    assert tile_plan(m, n, k, x_bytes, H100_SMS) == plan


@pytest.mark.parametrize("k,x_bytes,tma_x", [
    (2432, 1, True), (597, 1, False), (600, 1, False), (608, 1, True),
    (597, 2, False), (600, 2, True), (604, 2, False), (16, 1, True), (8, 2, True)])
def test_tma_needs_16_byte_rows(k, x_bytes, tma_x):
    """TMA takes a row stride that is a multiple of 16 bytes: K values of
    x_bytes each for x, N bytes for the int8 weight."""
    assert tile_plan(64, 128, k, x_bytes, H100_SMS).tma_x is tma_x
    for n, tma_w in ((44, False), (48, True), (7296, True), (100, False)):
        assert tile_plan(64, n, k, x_bytes, H100_SMS).tma_w is tma_w


def test_unaligned_bases_take_the_loads_of_their_own():
    """A base that is not 16-byte aligned cannot be a TMA source, whatever
    its shape."""
    assert tile_plan(64, 7296, 2432, 2, H100_SMS, x_aligned=False) == TilePlan(64, 2, False, True)
    assert tile_plan(64, 7296, 2432, 2, H100_SMS, w_aligned=False) == TilePlan(64, 2, True, False)


def test_plan_rules_at_every_shape():
    """At every shape: the row tile is the smallest that holds M (256
    above); a split only at 64 rows or fewer, at most MAX_SPLIT blocks,
    never more blocks than SMs nor fewer than SPLIT_CHUNKS chunks a block;
    a split wherever the tiles fill at most half the SMs and each block
    keeps SPLIT_CHUNKS chunks."""
    for m, n, k, x_bytes, sms in itertools.product(
            (1, 4, 16, 17, 37, 64, 65, 100, 128, 129, 256, 300, 2048),
            (8, 44, 128, 704, 2432, 7296, 9728, 32000),
            (16, 61, 597, 608, 2432, 9728), (1, 2), (8, 132)):
        plan = tile_plan(m, n, k, x_bytes, sms)
        assert plan.rows in ROW_TILES
        assert m <= plan.rows or plan.rows == ROW_TILES[-1]
        smaller = [r for r in ROW_TILES if r < plan.rows]
        assert not smaller or m > smaller[-1]
        tiles = -(-m // plan.rows) * -(-n // TILE_COLS)
        chunks = -(-k * x_bytes // CHUNK_BYTES)
        assert 1 <= plan.split <= MAX_SPLIT
        if plan.split > 1:
            assert plan.rows <= SPLIT_ROWS
            assert tiles * plan.split <= sms and plan.split * SPLIT_CHUNKS <= chunks
        elif plan.rows <= SPLIT_ROWS and 2 * tiles <= sms:
            assert min(MAX_SPLIT, sms // tiles, chunks // SPLIT_CHUNKS) <= 1
