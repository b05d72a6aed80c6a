"""Launch plans of the int8 decode kernels (``csrc/decode_gemm.cuh``).

The int8 layout of the decode mixer step (``csrc/ssm_step.cu``, kernel #3)
and the int8 and int4 layouts of the decode FFN (``csrc/ffn_fused.cu``, #4)
run swapped-operand int8 ``wgmma`` products: a block computes 128 weight
columns (``TILE_COLS``) for a row tile of 16 or 64 batch rows
(``ROW_TILES``), over 128-row K chunks (``CHUNK``) whose weight and row
tiles a ring of ``stages`` stages holds. A K split over a thread-block
cluster of ``split`` blocks spreads a product with few column tiles over
more SMs.

The plan of each launch is plain Python, so that the CPU tests can pin it;
the wrappers pass it to the C entry points, which compute the same shared
memory (``decode_gemm.cuh::dg_smem_bytes``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
ALIGN_SLACK = 1024            # the swizzle atoms' alignment
CHUNK = 128                   # K rows a chunk (one int4 group)
TILE_COLS = 128               # weight columns a block (two warpgroups of 64)
ROW_TILES = (16, 64)          # batch rows a block: wgmma's N
W8_BYTES = CHUNK * 128        # an int8 weight tile
W4_BYTES = CHUNK // 2 * 128 + 1024   # a packed int4 tile and its shift row
CONSUMER_THREADS = 256
MAX_STAGES = 8
# A K split takes at most MAX_SPLIT blocks where the SMs allow it: a GPC of
# the H100 (16 or 18 SMs) holds four clusters of four one-SM blocks
# (ops/kernels/quant_matmul.py).
MAX_SPLIT = 4
# GEMM1's cluster is the blocks of one hidden tile (pick_block_n's width up to
# 1152: 9 blocks, a non-portable cluster size).
MAX_UP_CLUSTER = 16


class GemmPlan(NamedTuple):
    """One launch: ``rows`` batch rows a block, K split over ``split``
    blocks of a cluster, ``stages`` ring stages, ``smem`` bytes of dynamic
    shared memory a block, and the ``grid`` (x, y) of blocks."""
    rows: int
    split: int
    stages: int
    smem: int
    grid: Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_tile(rows: int) -> int:
    """The row tile: 16 rows up to 16, else 64 (more rows take more tiles,
    each reading the weights again, from L2)."""
    return ROW_TILES[0] if rows <= ROW_TILES[0] else ROW_TILES[1]


def smem_bytes(rows: int, stages: int, stage_bytes: int, split: int, extra: int) -> int:
    """``decode_gemm.cuh::dg_smem_bytes``: alignment slack, the ring, the
    split's slots (``dg_part_bytes``: each owner's slots for every rank's
    sums of the accumulator column blocks it owns), the kernel's ``extra``
    bytes and two mbarriers a stage."""
    partial = split * _cdiv(rows // 8, split) * 4 * CONSUMER_THREADS * 4 if split > 1 else 0
    return ALIGN_SLACK + stages * stage_bytes + partial + extra + 16 * stages


def _stages(rows: int, stage_bytes: int, split: int, extra: int, chunks: int) -> int:
    """As many stages as fit, at most MAX_STAGES and no more than the
    block's chunks."""
    fixed = smem_bytes(rows, 0, stage_bytes, split, extra)
    return max(1, min(MAX_STAGES, chunks, (SMEM_LIMIT - fixed) // (stage_bytes + 16)))


def _step_gemm(k: int, col_tiles: int, row_tiles: int, rows: int, sms: int) -> GemmPlan:
    """One product of the int8 mixer step, its rows streamed beside the
    weight: K split over as many blocks as the SMs allow (at most MAX_SPLIT,
    at most one a chunk)."""
    chunks = _cdiv(k, CHUNK)
    split = max(1, min(MAX_SPLIT, chunks, sms // (col_tiles * row_tiles)))
    stage = rows * 128 + W8_BYTES
    stages = _stages(rows, stage, split, 0, _cdiv(chunks, split))
    return GemmPlan(rows, split, stages, smem_bytes(rows, stages, stage, split, 0),
                    (col_tiles * split, row_tiles))


class StepPlan(NamedTuple):
    """The int8 mixer step's three products (``csrc/ssm_step.cu``): in_proj
    x and z, x_param, out_proj."""
    inp: GemmPlan
    mix: GemmPlan
    out: GemmPlan


@functools.lru_cache(maxsize=None)
def ssm_step_plan(batch: int, d_model: int, channels: int, rank: int, sms: int) -> StepPlan:
    """The plan of ``apertis_ssm_decode_step_int8`` for B rows, D, C and R on
    a card of ``sms`` SMs."""
    rows = row_tile(batch)
    row_tiles = _cdiv(batch, rows)
    return StepPlan(
        _step_gemm(d_model, 2 * _cdiv(channels, TILE_COLS), row_tiles, rows, sms),
        _step_gemm(channels, _cdiv(rank + 2 * channels, TILE_COLS), row_tiles, rows, sms),
        _step_gemm(channels, _cdiv(d_model, TILE_COLS), row_tiles, rows, sms))


class FfnPlan(NamedTuple):
    """The int8 or int4 decode FFN's two launches (``csrc/ffn_fused.cu``):
    GEMM1 with the per-tile requantization (``split`` is its cluster, the
    blocks of one hidden tile) and GEMM2 over the hidden tiles (``split``
    its K split)."""
    up: GemmPlan
    down: GemmPlan


@functools.lru_cache(maxsize=None)
def ffn_plan(rows: int, d_model: int, inter: int, bn: int, bits: int, sms: int) -> FfnPlan:
    """The plan of ``apertis_ffn_decode_int8`` (bits 8) or ``_int4`` (bits
    4) for S rows, D, I and hidden tiles of ``bn`` columns. GEMM2 splits its
    bn-wide hidden tiles over as many blocks as the SMs allow (at most
    MAX_SPLIT, at most one a tile)."""
    br = row_tile(rows)
    row_tiles = _cdiv(rows, br)
    stage = br * 128 + (W4_BYTES if bits == 4 else W8_BYTES)
    up_extra = (CONSUMER_THREADS // 32 + 1 + MAX_UP_CLUSTER) * br * 4
    chunks = _cdiv(d_model, CHUNK)
    st_up = _stages(br, stage, 1, up_extra, chunks)
    up = GemmPlan(br, bn // TILE_COLS, st_up, smem_bytes(br, st_up, stage, 1, up_extra),
                  (inter // TILE_COLS, row_tiles))
    tiles = inter // bn
    col_tiles = _cdiv(d_model, TILE_COLS)
    split = max(1, min(MAX_SPLIT, tiles, sms // (col_tiles * row_tiles)))
    mine = _cdiv(tiles, split) * (bn // CHUNK)
    st_down = _stages(br, stage, split, 0, mine)
    down = GemmPlan(br, split, st_down, smem_bytes(br, st_down, stage, split, 0),
                    (col_tiles * split, row_tiles))
    return FfnPlan(up, down)
