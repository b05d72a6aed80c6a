"""Launch plans of the decode kernels on ``csrc/decode_gemm.cuh``.

The int8 layout of the decode mixer step (``csrc/ssm_step.cu``, kernel #3),
the int8 and int4 layouts of the decode FFN (``csrc/ffn_fused.cu``, #4), of
the fat MoE expert FFN (``csrc/moe_ffn.cu``, #10), the per-expert MoE FFN
(``csrc/moe_dense.cu``, #11) and the grouped MoE FFN (``csrc/moe_grouped.cu``,
#12) run swapped-operand int8 ``wgmma`` products: a block computes 128 weight
columns (``TILE_COLS``) for a row tile of 16 or 64 batch rows (``ROW_TILES``;
#12: 64 or 128), over
128-row K chunks (``CHUNK``) whose weight and row tiles a ring of
``stages`` stages holds; the bf16 layouts of the decode FFN and of the
mixer step the same over 64-row K chunks of a bf16 weight (``BW_CHUNK``,
``BW_BYTES``). A K split over a thread-block cluster of ``split`` blocks
spreads a product with few column tiles over more SMs.

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
BW_CHUNK = 64                 # K rows a chunk of a bf16 weight (128 bytes of a bf16 row)
BW_BYTES = BW_CHUNK * 256     # a bf16 weight tile: two 64-column blocks of 64 K rows
CONSUMER_THREADS = 256
MAX_STAGES = 8
# A K split takes at most MAX_SPLIT blocks where the SMs allow it: a GPC of
# the H100 (16 or 18 SMs) holds four clusters of four one-SM blocks
# (ops/kernels/quant_matmul.py).
MAX_SPLIT = 4
# GEMM1's cluster is the blocks of one hidden tile (pick_block_n's width up to
# 1152: 9 blocks, a non-portable cluster size).
MAX_UP_CLUSTER = 16
# The fat MoE FFN's GEMM2 splits its hidden tiles over a cluster of up to 16
# blocks (non-portable above 8; one a GPC of the H100): H (704, 768) gives it
# only six column tiles.
MAX_FAT_SPLIT = 16
# GEMM2 (ffn_down_kernel) takes up to MAX_GROUP consecutive hidden tiles a
# block in each round of its cluster's exchange, with at least MIN_STAGES
# ring stages left.
MAX_GROUP = 8
MIN_STAGES = 4


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


def xset_bytes(rows: int, split: int) -> int:
    """``decode_gemm.cuh::xset_bytes``: one tile's slots of the exchange in
    which each rank owns a run of the (thread, column block) pairs (about
    rows x 512 bytes at any split; none without a split)."""
    return split * _cdiv(rows // 8 * CONSUMER_THREADS, split) * 16 if split > 1 else 0


def _split_gemm(k: int, col_tiles: int, row_tiles: int, rows: int, sms: int,
                chunk: int = CHUNK, w_bytes: int = W8_BYTES, sliced: bool = False) -> GemmPlan:
    """One product whose rows are streamed beside the weight, K (chunks of
    ``chunk`` rows, weight tiles of ``w_bytes``) split in contiguous ranges
    over as many blocks as the SMs allow (at most MAX_SPLIT, at most one a
    chunk): the int8 mixer step's products (``decode_gemm.cuh``'s exchange)
    and the bf16 FFN's (``sliced``: ``quant_ffn.cuh``'s)."""
    chunks = _cdiv(k, chunk)
    split = max(1, min(MAX_SPLIT, chunks, sms // (col_tiles * row_tiles)))
    stage = rows * 128 + w_bytes
    # The split's slots: decode_gemm.cuh's (smem_bytes) or the sliced ones.
    xsplit, extra = (1, xset_bytes(rows, split)) if sliced else (split, 0)
    stages = _stages(rows, stage, xsplit, extra, _cdiv(chunks, split))
    return GemmPlan(rows, split, stages, smem_bytes(rows, stages, stage, xsplit, extra),
                    (col_tiles * split, row_tiles))


class StepPlan(NamedTuple):
    """The mixer step's three products (``csrc/ssm_step.cu``): in_proj x
    and z, x_param, out_proj."""
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
        _split_gemm(d_model, 2 * _cdiv(channels, TILE_COLS), row_tiles, rows, sms),
        _split_gemm(channels, _cdiv(rank + 2 * channels, TILE_COLS), row_tiles, rows, sms),
        _split_gemm(channels, _cdiv(d_model, TILE_COLS), row_tiles, rows, sms))


@functools.lru_cache(maxsize=None)
def bf16_step_plan(batch: int, d_model: int, channels: int, rank: int, sms: int) -> StepPlan:
    """The plan of ``apertis_ssm_decode_step`` (the bf16 layout) for B rows,
    D, C and R: the int8 step's products over 64-row chunks of the bf16
    weights, each split over K as far as its column tiles leave SMs idle,
    with the sliced exchange's slots (the bf16 FFN's)."""
    rows = row_tile(batch)
    row_tiles = _cdiv(batch, rows)

    def gemm(k, col_tiles):
        return _split_gemm(k, col_tiles, row_tiles, rows, sms, BW_CHUNK, BW_BYTES, sliced=True)
    return StepPlan(gemm(d_model, 2 * _cdiv(channels, TILE_COLS)),
                    gemm(channels, _cdiv(rank + 2 * channels, TILE_COLS)),
                    gemm(channels, _cdiv(d_model, TILE_COLS)))


def down_extra(rows: int, split: int, group: int, experts: int) -> int:
    """``quant_ffn.cuh::ffn_down_extra``: GEMM2's shared memory beyond its
    ring (``smem_bytes`` with no split): the exchange's slots of the group's
    tiles, two buffers of the round's per-(tile, row) scales, and a byte a
    live expert (MoE)."""
    return group * xset_bytes(rows, split) + 2 * group * rows * 4 + _cdiv(experts, 16) * 16


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
    extra = down_extra(br, split, 1, 0)
    st_down = _stages(br, stage, 1, extra, mine)
    down = GemmPlan(br, split, st_down, smem_bytes(br, st_down, stage, 1, extra),
                    (col_tiles * split, row_tiles))
    return FfnPlan(up, down)


@functools.lru_cache(maxsize=None)
def bf16_ffn_plan(rows: int, d_model: int, inter: int, sms: int) -> FfnPlan:
    """The plan of ``apertis_ffn_decode`` (the bf16 layout) for S rows, D and
    I: GEMM1 (K = D, I / 128 column tiles) and GEMM2 (K = I, D / 128), each
    split over K as far as its column tiles leave SMs idle."""
    br = row_tile(rows)
    row_tiles = _cdiv(rows, br)
    return FfnPlan(
        _split_gemm(d_model, _cdiv(inter, TILE_COLS), row_tiles, br, sms, BW_CHUNK, BW_BYTES,
                    sliced=True),
        _split_gemm(inter, _cdiv(d_model, TILE_COLS), row_tiles, br, sms, BW_CHUNK, BW_BYTES,
                    sliced=True))


class FatPlan(NamedTuple):
    """The fat MoE FFN's launches (``csrc/moe_ffn.cu``): GEMM1, whose
    ``split`` is its cluster, the bn / 128 blocks of one hidden tile, or 0
    for the wide form (a tile of more than MAX_UP_CLUSTER blocks, or not of
    whole blocks: the f32 hidden and a requantization pass); GEMM2, whose
    ``split`` spreads the hidden tiles over a cluster, ``group`` tiles a
    block in each round of its exchange."""
    up: GemmPlan
    down: GemmPlan
    group: int


def fat_wide(bn: int) -> bool:
    """Whether a hidden tile of ``bn`` columns is too wide for GEMM1's
    cluster: the 1.5B MoE preset's 2816 (22 blocks)."""
    return bn % TILE_COLS != 0 or bn // TILE_COLS > MAX_UP_CLUSTER


@functools.lru_cache(maxsize=None)
def fat_plan(rows: int, d_model: int, inter: int, experts: int, bn: int, bits: int,
             sms: int) -> FatPlan:
    """The plan of ``apertis_expert_ffn_fat`` (bits 8) or ``_int4`` (bits 4)
    for S rows, H = ``d_model``, E experts of I columns and hidden tiles of
    ``bn`` columns (each padded to whole chunks in hq). GEMM1 runs the whole
    K = H a block. GEMM2 splits the tiles over as many blocks as the SMs
    allow (at most MAX_FAT_SPLIT, at most one a tile), each taking in a
    round the largest group of consecutive tiles (at most MAX_GROUP, no more
    than its share) whose exchange slots leave room for MIN_STAGES stages:
    the 3B preset's 192 tiles of 128 columns would otherwise take 24 rounds
    of cluster barriers."""
    br = row_tile(rows)
    row_tiles = _cdiv(rows, br)
    stage = br * 128 + (W4_BYTES if bits == 4 else W8_BYTES)
    ei = experts * inter
    up_extra = (CONSUMER_THREADS // 32 + 1 + MAX_UP_CLUSTER) * br * 4
    st_up = _stages(br, stage, 1, up_extra, _cdiv(d_model, CHUNK))
    up = GemmPlan(br, 0 if fat_wide(bn) else bn // TILE_COLS, st_up,
                  smem_bytes(br, st_up, stage, 1, up_extra), (_cdiv(ei, TILE_COLS), row_tiles))
    tiles = ei // bn
    col_tiles = _cdiv(d_model, TILE_COLS)
    split = max(1, min(MAX_FAT_SPLIT, tiles, sms // (col_tiles * row_tiles)))
    group = max([1] + [g for g in range(1, min(MAX_GROUP, _cdiv(tiles, split)) + 1)
                       if smem_bytes(br, MIN_STAGES, stage, 1,
                                     down_extra(br, split, g, experts)) <= SMEM_LIMIT])
    extra = down_extra(br, split, group, experts)
    per_block = _cdiv(tiles, split * group) * group * _cdiv(bn, CHUNK)
    st_down = _stages(br, stage, 1, extra, per_block)
    down = GemmPlan(br, split, st_down, smem_bytes(br, st_down, stage, 1, extra),
                    (col_tiles * split, row_tiles))
    return FatPlan(up, down, group)


class DensePlan(NamedTuple):
    """The per-expert (``csrc/moe_dense.cu``) and grouped
    (``csrc/moe_grouped.cu``) MoE FFN's launches: GEMM1 in the wide form
    (``split`` 0: the f32 hidden and a requantization pass over each
    expert's whole I) and GEMM2, whose ``split`` spreads an expert's K chunks
    over a cluster that adds the int32 parts in distributed shared
    memory."""
    up: GemmPlan
    down: GemmPlan


def _expert_plan(rows: int, br: int, d_model: int, inter: int, slices: int,
                 sms: int) -> DensePlan:
    """``quant_ffn.cuh::expert_ffn_run``'s plan at a row tile of ``br`` rows
    over ``slices`` grid slices: GEMM1 the whole K = H a block, ceil(I / 128)
    column blocks a slice; GEMM2 splits the ceil(I / 128) chunks over as many
    blocks as the SMs allow beside its H / 128 column tiles, row tiles and
    slices (at most MAX_FAT_SPLIT, at most one a chunk). The int32 parts
    are exact in any order, so the split does not change the result."""
    row_tiles = _cdiv(rows, br)
    stage = br * 128 + W8_BYTES
    up_extra = (CONSUMER_THREADS // 32 + 1 + MAX_UP_CLUSTER) * br * 4
    st_up = _stages(br, stage, 1, up_extra, _cdiv(d_model, CHUNK))
    up = GemmPlan(br, 0, st_up, smem_bytes(br, st_up, stage, 1, up_extra),
                  (_cdiv(inter, TILE_COLS), row_tiles))
    chunks = _cdiv(inter, CHUNK)
    col_tiles = _cdiv(d_model, TILE_COLS)
    split = max(1, min(MAX_FAT_SPLIT, chunks, sms // (col_tiles * row_tiles * slices)))
    st_down = _stages(br, stage, split, 0, _cdiv(chunks, split))
    down = GemmPlan(br, split, st_down, smem_bytes(br, st_down, stage, split, 0),
                    (col_tiles * split, row_tiles))
    return DensePlan(up, down)


@functools.lru_cache(maxsize=None)
def dense_plan(rows: int, d_model: int, inter: int, experts: int, sms: int) -> DensePlan:
    """The plan of ``apertis_expert_ffn_dense`` for S rows, H = ``d_model``
    and E experts of I = ``inter`` columns on a card of ``sms`` SMs: the row
    tile of :func:`row_tile`, one grid slice an expert."""
    return _expert_plan(rows, row_tile(rows), d_model, inter, experts, sms)


@functools.lru_cache(maxsize=None)
def grouped_plan(rows: int, d_model: int, inter: int, sms: int) -> DensePlan:
    """The plan of ``apertis_expert_ffn_grouped`` for P expert-sorted rows
    (whole tiles of 128), H = ``d_model`` and experts of I = ``inter``
    columns on a card of ``sms`` SMs: one grid slice, each row tile the
    expert of its grouped tile (so the number of experts does not enter).
    The row tile is the grouped tile, 128 rows, where GEMM2's 128-row tiles
    fill the SMs (P in the thousands, no K split), else 64 (on the H100,
    ``chip_smoke.py --grouped-times``: 128 took 0.143 ms against 64's 0.167
    at request B's P = 5120, 64 took 0.048 against 128's 0.069 at the
    ragged P = 1024)."""
    br = 128 if _cdiv(rows, 128) * _cdiv(d_model, TILE_COLS) >= sms else 64
    return _expert_plan(rows, br, d_model, inter, 1, sms)


@functools.lru_cache(maxsize=None)
def ffn_scratch(s: int, ei: int, bn: int, wide: bool) -> Tuple[int, int, int, int, int]:
    """Byte offsets, each 256-byte aligned, of the scratch of
    ``quant_ffn.cuh``'s MoE FFNs in one buffer (one allocation a call) for
    S rows, E*I = ``ei`` hidden columns in tiles of ``bn``: hq (S, tiles *
    bnp) int8 (bnp: bn rounded up to CHUNK), hs (S, tiles) f32 and, in the
    wide form, hidden (S, E*I) f32 and absmax (S, tiles) f32; and the
    buffer's size. -1: not used. The fat MoE FFN (#10) passes its hidden
    tiles; the per-expert (#11) one tile an expert over its E experts; the
    grouped (#12) one tile of one expert's I (ei = bn = I)."""
    tiles, bnp = ei // bn, _cdiv(bn, CHUNK) * CHUNK
    sizes = [s * tiles * bnp, s * tiles * 4, s * ei * 4 if wide else 0,
             s * tiles * 4 if wide else 0]
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at if size else -1)
        at += -(-size // 256) * 256
    return (*offsets, at)
