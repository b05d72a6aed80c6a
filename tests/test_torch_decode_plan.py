"""The host side and the arithmetic of the decode kernels, on the CPU.

``csrc/ssm_step.cu`` (the int8 layout of the decode mixer step, #3),
``csrc/ffn_fused.cu`` (the bf16, int8 and int4 decode FFN, #4) and
``csrc/moe_ffn.cu`` (the int8 and int4 fat MoE FFN, #10) run swapped-operand
``wgmma`` products (``csrc/decode_gemm.cuh``, ``csrc/quant_ffn.cuh``) on the
plans of ``ops/kernels/decode_plan.py``. The kernels build and run only on
the card, where ``chip_smoke.py`` holds them against their plain versions.
Here: the plans at the shapes the smoke runs and their rules at every shape;
the int8 and int4 A-fragment build (swizzled tile, ``ldmatrix.trans`` row
choice, byte permutes, nibble unpacking) emulated lane by lane against the
PTX fragment layout and ``unpack_int4``; the decode FFN's K split over a
cluster, whose tile-ordered f32 accumulation must equal
``ffn_decode_int8_reference`` bit for bit; the fat MoE FFN's (per-tile
maxima over 128-column blocks, hq padded to whole chunks, rounds of tile
groups, skipped experts), which must equal ``expert_ffn_fat_reference`` bit
for bit; the bf16 FFN's K split ranges and rank-ordered sums against
``ffn_decode_reference``; the split's exchange slots inside the plans'
shared memory; and the per-expert (#11) and grouped (#12) MoE FFN's
launches (``csrc/quant_ffn.cuh::expert_ffn_run``), which must equal
``expert_ffn_dense_reference`` and ``expert_ffn_grouped_reference`` bit for
bit.
"""

import collections
import itertools
import re

import numpy as np
import pytest
import torch

from apertis_llm_torch.models.quantize import quantize_weight, quantize_weight_int4, unpack_int4
from apertis_llm_torch.ops.activations import get_activation
from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.kernels.decode_plan import (
    BW_BYTES, BW_CHUNK, CHUNK, MAX_FAT_SPLIT, MAX_GROUP, MAX_SPLIT, MAX_UP_CLUSTER, MIN_STAGES,
    ROW_TILES, SMEM_LIMIT, TILE_COLS, W4_BYTES, W8_BYTES, DensePlan, FatPlan, FfnPlan, GemmPlan,
    StepPlan, _expert_plan, bf16_ffn_plan, bf16_step_plan, dense_plan, down_extra, fat_plan,
    fat_wide, ffn_plan, grouped_plan, smem_bytes, ssm_step_plan, xset_bytes)
from apertis_llm_torch.ops.kernels.ffn_fused import (
    ffn_decode_int8_reference, ffn_decode_reference, pick_block_n)
from apertis_llm_torch.ops.kernels.moe_ffn import (
    expert_ffn_dense_reference, expert_ffn_fat_reference, fat_block_n)
from apertis_llm_torch.ops.kernels.moe_grouped import TILE, expert_ffn_grouped_reference
from apertis_llm_torch.ops.moe import grouped_dispatch
from apertis_llm_torch.ops.quant import int_mm

H100_SMS = 132


def cdiv(a, b):
    return -(-a // b)


# ---- the plans --------------------------------------------------------------

@pytest.mark.parametrize("batch,dims,plan", [
    # the 1.5B mixer (D 2432, C 608, R 152) at 64 rows: in_proj x and z are
    # 10 column tiles, x_param 11, out_proj 19; each splits K in four
    (64, (2432, 608, 152), StepPlan(GemmPlan(64, 4, 5, 156752, (40, 1)),
                                    GemmPlan(64, 4, 2, 82976, (44, 1)),
                                    GemmPlan(64, 4, 2, 82976, (76, 1)))),
    (4, (2432, 608, 152), StepPlan(GemmPlan(16, 4, 5, 109648, (40, 1)),
                                   GemmPlan(16, 4, 2, 54304, (44, 1)),
                                   GemmPlan(16, 4, 2, 54304, (76, 1)))),
    (5, (2432, 608, 152), StepPlan(GemmPlan(16, 4, 5, 109648, (40, 1)),
                                   GemmPlan(16, 4, 2, 54304, (44, 1)),
                                   GemmPlan(16, 4, 2, 54304, (76, 1)))),
    # 256 rows: four row tiles fill more of the card, so less split
    (256, (2432, 608, 152), StepPlan(GemmPlan(64, 3, 7, 210032, (30, 4)),
                                     GemmPlan(64, 3, 2, 87072, (33, 4)),
                                     GemmPlan(64, 1, 5, 123984, (19, 4)))),
    # the MoE mixer (D 704, C 176, R 44): two K chunks of x_param and out_proj
    (64, (704, 176, 44), StepPlan(GemmPlan(64, 4, 2, 82976, (16, 1)),
                                  GemmPlan(64, 2, 1, 58384, (8, 1)),
                                  GemmPlan(64, 2, 1, 58384, (12, 1)))),
])
def test_step_plan_at_the_smoke_shapes(batch, dims, plan):
    assert ssm_step_plan(batch, *dims, H100_SMS) == plan


@pytest.mark.parametrize("batch,dims,plan", [
    # the bf16 layout at the 1.5B widths (D 2432, C 608, R 152): in_proj x
    # and z are 10 column tiles of 38 chunks of 64, x_param 11 of 10 chunks,
    # out_proj 19 of 10; each splits K in four
    (64, (2432, 608, 152), StepPlan(GemmPlan(64, 4, 8, 230528, (40, 1)),
                                    GemmPlan(64, 4, 3, 107568, (44, 1)),
                                    GemmPlan(64, 4, 3, 107568, (76, 1)))),
    (4, (2432, 608, 152), StepPlan(GemmPlan(16, 4, 8, 156800, (40, 1)),
                                   GemmPlan(16, 4, 3, 64560, (44, 1)),
                                   GemmPlan(16, 4, 3, 64560, (76, 1)))),
    (5, (2432, 608, 152), StepPlan(GemmPlan(16, 4, 8, 156800, (40, 1)),
                                   GemmPlan(16, 4, 3, 64560, (44, 1)),
                                   GemmPlan(16, 4, 3, 64560, (76, 1)))),
    (256, (2432, 608, 152), StepPlan(GemmPlan(64, 3, 8, 230544, (30, 4)),
                                     GemmPlan(64, 3, 4, 132176, (33, 4)),
                                     GemmPlan(64, 1, 8, 197760, (19, 4)))),
    # the MoE widths (D 704, C 176, R 44): x_param's and out_proj's three
    # chunks of 64 split in three, one a block
    (64, (704, 176, 44), StepPlan(GemmPlan(64, 4, 3, 107568, (16, 1)),
                                  GemmPlan(64, 3, 1, 58400, (12, 1)),
                                  GemmPlan(64, 3, 1, 58400, (18, 1)))),
    (4, (704, 176, 44), StepPlan(GemmPlan(16, 4, 3, 64560, (16, 1)),
                                 GemmPlan(16, 3, 1, 27680, (12, 1)),
                                 GemmPlan(16, 3, 1, 27680, (18, 1)))),
    (5, (704, 176, 44), StepPlan(GemmPlan(16, 4, 3, 64560, (16, 1)),
                                 GemmPlan(16, 3, 1, 27680, (12, 1)),
                                 GemmPlan(16, 3, 1, 27680, (18, 1)))),
    (256, (704, 176, 44), StepPlan(GemmPlan(64, 4, 3, 107568, (16, 4)),
                                   GemmPlan(64, 3, 1, 58400, (12, 4)),
                                   GemmPlan(64, 3, 1, 58400, (18, 4)))),
])
def test_bf16_step_plan_at_the_smoke_shapes(batch, dims, plan):
    assert bf16_step_plan(batch, *dims, H100_SMS) == plan


def test_bf16_step_plan_rules_at_every_shape():
    """Rows 1-256 at many widths: each product streams 64-row chunks of its
    bf16 weight (BW_CHUNK, BW_BYTES) beside its rows; in_proj has two column
    tiles a 128 channels (x and z); K splits over the largest split up to
    MAX_SPLIT and its chunks whose blocks fit on the SMs; stages 1 to 8 and
    no more than a block's chunks; shared memory the ring plus the sliced
    exchange's slots (no owner slots), within the limit."""
    for batch in (1, 4, 5, 16, 17, 37, 64, 65, 200, 256):
        for d, c, r in ((2432, 608, 152), (704, 176, 44), (768, 192, 48), (192, 64, 12),
                        (1216, 304, 76)):
            plan = bf16_step_plan(batch, d, c, r, H100_SMS)
            rows = 16 if batch <= 16 else 64
            row_tiles = cdiv(batch, rows)
            stage = rows * 128 + BW_BYTES
            for gemm, k, col_tiles in ((plan.inp, d, 2 * cdiv(c, TILE_COLS)),
                                       (plan.mix, c, cdiv(r + 2 * c, TILE_COLS)),
                                       (plan.out, c, cdiv(d, TILE_COLS))):
                chunks = cdiv(k, BW_CHUNK)
                assert gemm.rows == rows
                assert gemm.split == max(1, min(MAX_SPLIT, chunks,
                                                H100_SMS // (col_tiles * row_tiles)))
                assert 1 <= gemm.stages <= min(8, cdiv(chunks, gemm.split))
                assert gemm.smem == smem_bytes(rows, gemm.stages, stage, 1,
                                               xset_bytes(rows, gemm.split)) <= SMEM_LIMIT
                assert gemm.grid == (col_tiles * gemm.split, row_tiles)


@pytest.mark.parametrize("rows,inter,bits,plan", [
    # the 1.5B FFN (D 2432, I 9728, bn 512): GEMM1's 76 blocks in clusters of
    # four (one hidden tile each), GEMM2's 19 column tiles with K in four
    (64, 9728, 8, FfnPlan(GemmPlan(64, 4, 8, 204160, (76, 1)),
                          GemmPlan(64, 4, 8, 231040, (76, 1)))),
    (4, 9728, 8, FfnPlan(GemmPlan(16, 4, 8, 150208, (76, 1)),
                         GemmPlan(16, 4, 8, 156928, (76, 1)))),
    (64, 9728, 4, FfnPlan(GemmPlan(64, 4, 8, 146816, (76, 1)),
                          GemmPlan(64, 4, 8, 173696, (76, 1)))),
    (5, 9728, 4, FfnPlan(GemmPlan(16, 4, 8, 92864, (76, 1)),
                         GemmPlan(16, 4, 8, 99584, (76, 1)))),
    # I 1536: two hidden tiles of 768, clusters of six
    (64, 1536, 8, FfnPlan(GemmPlan(64, 6, 8, 204160, (12, 1)),
                          GemmPlan(64, 2, 6, 181856, (38, 1)))),
    (256, 1536, 8, FfnPlan(GemmPlan(64, 6, 8, 204160, (12, 4)),
                           GemmPlan(64, 1, 8, 198272, (19, 4)))),
    (256, 9728, 8, FfnPlan(GemmPlan(64, 4, 8, 204160, (76, 4)),
                           GemmPlan(64, 1, 8, 198272, (19, 4)))),
])
def test_ffn_plan_at_the_smoke_shapes(rows, inter, bits, plan):
    assert ffn_plan(rows, 2432, inter, pick_block_n(inter), bits, H100_SMS) == plan


STEP_DIMS = [(2432, 608, 152), (704, 176, 44), (1216, 304, 76), (768, 192, 48), (192, 48, 12),
             (4096, 1024, 256), (8192, 2048, 512), (12, 4, 1)]


def test_step_plan_rules_at_every_shape():
    """Rows 1-256 at many widths and card sizes: the row tile is 16 up to 16
    rows, else 64; each product's split is the largest up to MAX_SPLIT and
    its chunks whose blocks fit on the SMs (at least 1); its stages 1 to 8,
    at most its blocks' chunks; its shared memory (as the C side computes
    it) fits; the grid covers its column tiles, split and row tiles."""
    for batch, (d, c, r), sms in itertools.product(range(1, 257), STEP_DIMS, (132, 16, 1)):
        plan = ssm_step_plan(batch, d, c, r, sms)
        rows = ROW_TILES[0] if batch <= ROW_TILES[0] else ROW_TILES[1]
        row_tiles = cdiv(batch, rows)
        for p, k, col_tiles in ((plan.inp, d, 2 * cdiv(c, TILE_COLS)),
                                (plan.mix, c, cdiv(r + 2 * c, TILE_COLS)),
                                (plan.out, c, cdiv(d, TILE_COLS))):
            chunks = cdiv(k, CHUNK)
            assert p.rows == rows
            assert p.split == max(1, min(MAX_SPLIT, chunks, sms // (col_tiles * row_tiles)))
            assert 1 <= p.stages <= min(8, cdiv(chunks, p.split))
            stage = rows * 128 + W8_BYTES
            assert p.smem == smem_bytes(rows, p.stages, stage, p.split, 0) <= SMEM_LIMIT
            assert p.grid == (col_tiles * p.split, row_tiles)
            if p.split > 1:
                assert col_tiles * row_tiles * p.split <= sms


def test_ffn_plan_rules_at_every_shape():
    """Rows 1-256 at many widths: GEMM1's cluster is the bn / 128 blocks of
    a hidden tile (at most 16, non-portable above 8); GEMM2's split is the
    largest up to MAX_SPLIT and the tiles whose blocks fit on the SMs; both
    fit in shared memory with 1 to 8 stages and no more stages than their
    chunks; the grids cover the column tiles, split and row tiles."""
    for rows, d, inter, bits, sms in itertools.product(
            range(1, 257), (128, 704, 2432, 4096), (1152, 1536, 2560, 3456, 9728, 11008 + 256),
            (8, 4), (132, 16)):
        bn = pick_block_n(inter)
        plan = ffn_plan(rows, d, inter, bn, bits, sms)
        br = ROW_TILES[0] if rows <= ROW_TILES[0] else ROW_TILES[1]
        row_tiles = cdiv(rows, br)
        stage = br * 128 + (W4_BYTES if bits == 4 else W8_BYTES)
        tiles = inter // bn
        up, down = plan
        assert up.rows == down.rows == br
        assert up.split == bn // TILE_COLS <= MAX_UP_CLUSTER
        assert up.grid == (inter // TILE_COLS, row_tiles) and up.grid[0] % up.split == 0
        assert 1 <= up.stages <= min(8, cdiv(d, CHUNK))
        assert up.smem == smem_bytes(br, up.stages, stage, 1,
                                     (8 + 1 + MAX_UP_CLUSTER) * br * 4) <= SMEM_LIMIT
        col_tiles = cdiv(d, TILE_COLS)
        assert down.split == max(1, min(MAX_SPLIT, tiles, sms // (col_tiles * row_tiles)))
        assert 1 <= down.stages <= min(8, cdiv(tiles, down.split) * (bn // CHUNK))
        assert down.smem == smem_bytes(br, down.stages, stage, 1,
                                       down_extra(br, down.split, 1, 0)) <= SMEM_LIMIT
        assert down.grid == (col_tiles * down.split, row_tiles)


# ---- the A fragments ----------------------------------------------------------

def _source(name):
    return (_build.CSRC / name).read_text()


ROW_CHOICE = "16 * (mat >> 1) + 4 * (i >> 1) + (i & 1) + 2 * ((mat & 1) ^ (i >> 2))"


def test_the_emulation_follows_the_kernels_source():
    """The emulation below uses the kernels' row choice, selectors and
    nibble unpacking as the sources state them."""
    hopper, core = _source("hopper.cuh"), _source("decode_gemm.cuh")
    assert ROW_CHOICE in hopper
    assert "sel_even = (lane & 3) < 2 ? 0x6420u : 0x2064u;" in core
    assert "sel_odd = (lane & 3) < 2 ? 0x7531u : 0x3175u;" in core
    assert "__vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u)" in hopper
    assert "(v << e) & (0x01010101u * ((0xFFu << e) & 0xFFu))" in hopper
    assert "a[kk][i] = nibbles_lo(p[i], e);" in hopper
    assert "a[kk + 2][i] = nibbles_lo(p[i] >> 4, e);" in hopper
    assert re.search(r"return max\(__ffs\(\(int\)s\) - 1, 0\);", hopper)


def _swizzle(tile):
    """A (rows, 128) byte tile in the 128-byte swizzle, as TMA writes it."""
    rows = tile.shape[0]
    smem = np.zeros(rows * 128, dtype=np.uint8)
    for r in range(rows):
        for c in range(8):
            at = r * 128 + ((c ^ (r % 8)) << 4)
            smem[at:at + 16] = tile[r, 16 * c:16 * c + 16]
    return smem


def _byte_perm(x, y, sel):
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _ldsm_x4_trans(smem, addrs, lane):
    """Lane `lane`'s four registers of ldmatrix.x4.trans: from matrix m
    (rows at the addresses of lanes 8m..8m+7) the 16-bit elements of rows
    2 (lane % 4) and 2 (lane % 4) + 1, column lane / 4."""
    q, g = lane % 4, lane // 4
    regs = []
    for m in range(4):
        a0, a1 = addrs[8 * m + 2 * q], addrs[8 * m + 2 * q + 1]
        b = [smem[a0 + 2 * g], smem[a0 + 2 * g + 1], smem[a1 + 2 * g], smem[a1 + 2 * g + 1]]
        regs.append(sum(int(v) << (8 * i) for i, v in enumerate(b)))
    return regs


def _frag_offset(lane, chunk):
    mat, i = lane >> 3, lane & 7
    row = 16 * (mat >> 1) + 4 * (i >> 1) + (i & 1) + 2 * ((mat & 1) ^ (i >> 2))
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _vsub4(a, b):
    return sum((((a >> (8 * i)) - (b >> (8 * i))) & 0xFF) << (8 * i) for i in range(4))


def _nibbles_lo(p, e):
    v = _vsub4((p & 0x0F0F0F0F) ^ 0x08080808, 0x08080808)
    return ((v << e) & 0xFFFFFFFF) & (0x01010101 * ((0xFF << e) & 0xFF))


def _fragments(smem, warp_in_block, lane, k_steps, unpack=None):
    """hopper.cuh::qm_frags (int8) or i4_frags (unpack: the two columns'
    exponents) for consumer warp `warp_in_block` (warpgroup w // 4, warp
    w % 4): a[kk][i] as four int8 each."""
    wg, w = divmod(warp_in_block, 4)
    addrs = [_frag_offset(ln, 4 * wg + w) for ln in range(32)]
    sel_even = 0x6420 if lane % 4 < 2 else 0x2064
    sel_odd = 0x7531 if lane % 4 < 2 else 0x3175
    frags = {}
    for kk in range(k_steps):
        r = _ldsm_x4_trans(smem, [a + kk * 32 * 128 for a in addrs], lane)
        p = [_byte_perm(r[0], r[1], sel_even), _byte_perm(r[0], r[1], sel_odd),
             _byte_perm(r[2], r[3], sel_even), _byte_perm(r[2], r[3], sel_odd)]
        for i in range(4):
            if unpack is None:
                frags[kk, i] = p[i]
            else:
                e = unpack[i & 1]
                frags[kk, i] = _nibbles_lo(p[i], e)
                frags[kk + 2, i] = _nibbles_lo(p[i] >> 4, e)
    return {key: np.array([(v >> (8 * j)) & 0xFF for j in range(4)], dtype=np.uint8).view(np.int8)
            for key, v in frags.items()}


def _expected(weights, warp_in_block, lane, kk, i):
    """The s8 m64k32 A fragment from registers: register i of lane l holds
    row l / 4 + 8 (i % 2), k 4 (l % 4) + 16 (i / 2) + 0..3; fragment row g
    of warp w is weight column 16 w + 2 g, row g + 8 column 16 w + 2 g + 1
    (in its warpgroup's 64)."""
    wg, w = divmod(warp_in_block, 4)
    col = 64 * wg + 16 * w + 2 * (lane // 4) + i % 2
    k0 = 32 * kk + 4 * (lane % 4) + 16 * (i // 2)
    return weights[k0:k0 + 4, col]


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_fragments_follow_the_ptx_layout(seed):
    rng = np.random.default_rng(seed)
    tile = rng.integers(-127, 128, (128, 128)).astype(np.int8)
    smem = _swizzle(tile.view(np.uint8))
    for warp in range(8):
        for lane in range(32):
            frags = _fragments(smem, warp, lane, 4)
            for (kk, i), got in frags.items():
                np.testing.assert_array_equal(got, _expected(tile, warp, lane, kk, i))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int4_fragments_unpack_as_unpack_int4(seed):
    """Four 128-row groups of an int4 weight quantized by
    ``quantize_weight_int4``, scaled apart so that the shifts take 1 to 8:
    each group's packed 64-row tile, swizzled, through the int8 row choice
    and selectors and the nibble unpacking, gives each lane the fragment
    values of ``unpack_int4(w_q4, w_sh)``."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((512, 128), generator=gen)
    w *= torch.tensor([1.0, 0.3, 0.1, 0.02]).repeat_interleave(128)[:, None]
    w *= torch.rand((1, 128), generator=gen) + 0.5
    w_q4, _, w_sh = quantize_weight_int4(w)
    assert set(w_sh.unique().tolist()) == {1, 2, 4, 8}
    full = unpack_int4(w_q4, w_sh).numpy()
    for group in range(4):
        smem = _swizzle(w_q4[64 * group:64 * group + 64].numpy().view(np.uint8))
        exps = [int(s).bit_length() - 1 for s in w_sh[group].tolist()]
        values = full[128 * group:128 * group + 128]
        for warp in range(8):
            for lane in range(32):
                wg, wi = divmod(warp, 4)
                col = 64 * wg + 16 * wi + 2 * (lane // 4)
                frags = _fragments(smem, warp, lane, 2, unpack=(exps[col], exps[col + 1]))
                assert len(frags) == 16
                for (kk, i), got in frags.items():
                    np.testing.assert_array_equal(got, _expected(values, warp, lane, kk, i))


# ---- the decode FFN's K split over a cluster --------------------------------

def _ffn_operands(seed, s, d, inter):
    gen = torch.Generator().manual_seed(seed)
    w1_q, w1_s = quantize_weight(torch.randn((d, inter), generator=gen) * 0.05)
    w2_q, w2_s = quantize_weight(torch.randn((inter, d), generator=gen) * 0.05)
    x = torch.randn((s, d), generator=gen)
    x_s = x.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) / 127.0
    x_q = torch.clamp(torch.round(x / x_s), -127, 127).to(torch.int8)
    return (x_q, x_s, w1_q, w1_s, torch.randn(inter, generator=gen).to(torch.bfloat16) * 0.1,
            w2_q, w2_s, torch.randn(d, generator=gen).to(torch.bfloat16) * 0.1)


def _cluster_ffn(x_q, x_s, w1_q, w1_s, b1, w2_q, w2_s, b2, split, order=lambda q: q):
    """ffn_fused.cu's two launches in numpy float32: GEMM1's epilogue and the
    per-(row, tile) scale from the 128-column blocks' maxima (maxed over the
    tile's cluster); GEMM2's blocks r = 0..split-1 each holding the tiles
    r, r + split, ..., and in each round the owner of each accumulator row
    block (j % split) adding the blocks' p_t in rank order (``order`` may
    permute it, to show that the order matters)."""
    s, d = x_q.shape
    inter = w1_q.shape[1]
    bn = pick_block_n(inter)
    tiles = inter // bn
    acc1 = (x_q.numpy().astype(np.int64) @ w1_q.numpy().astype(np.int64)).astype(np.float32)
    pre = acc1 * x_s.numpy() * w1_s.numpy() + b1.float().numpy()
    h = get_activation("gelu")(torch.from_numpy(pre)).numpy()
    block_max = np.abs(h).reshape(s, inter // 128, 128).max(axis=2)
    hs = np.maximum(block_max.reshape(s, tiles, bn // 128).max(axis=2), np.float32(1e-8))
    hs = (hs * np.float32(1.0 / 127.0)).astype(np.float32)
    hq = np.clip(np.rint(h / np.repeat(hs, bn, axis=1)), -127, 127).astype(np.int64)
    w2 = w2_q.numpy().astype(np.int64)
    owner = (np.arange(s) // 8) % split           # rows 8 j .. 8 j + 7: column block j
    total = np.zeros((s, d), dtype=np.float32)
    for rho in range(-(-tiles // split)):
        held = {}                                   # each block's p of this round
        for rank in range(split):
            t = rho * split + rank
            if t < tiles:
                acc2 = (hq[:, t * bn:(t + 1) * bn] @ w2[t * bn:(t + 1) * bn]).astype(np.float32)
                held[rank] = acc2 * hs[:, t:t + 1]
        for rank in range(split):                   # the owners add in rank order
            rows = owner == rank
            for q in range(split):
                src = order(q)
                if src in held:
                    total[rows] = total[rows] + held[src][rows]
    out = total * w2_s.numpy() + b2.float().numpy()
    return torch.from_numpy(out).to(torch.bfloat16), total


@pytest.mark.parametrize("split,rows,inter", [(4, 64, 9728), (4, 5, 9728), (3, 37, 9728),
                                              (2, 64, 1536), (1, 16, 2560), (4, 64, 2560)])
def test_cluster_accumulation_is_the_reference_bit_for_bit(split, rows, inter):
    args = _ffn_operands(split * 1000 + rows, rows, 256, inter)
    out, _ = _cluster_ffn(*args, split=split)
    assert torch.equal(out, ffn_decode_int8_reference(*args, hidden_act="gelu"))


def test_another_order_of_the_f32_adds_moves_the_sums():
    """The order can be seen: adding each round's tiles in reverse rank
    order moves some of the f32 sums, where the rank order gives the
    tile-ordered sums of the reference's loop."""
    args = _ffn_operands(7, 64, 256, 9728)
    _, ranked = _cluster_ffn(*args, split=4)
    _, sequential = _cluster_ffn(*args, split=1)
    _, reversed_ = _cluster_ffn(*args, split=4, order=lambda q: 3 - q)
    assert np.array_equal(ranked, sequential)
    assert not np.array_equal(reversed_, sequential)


# ---- the K split's exchange ---------------------------------------------------

CONSUMER_THREADS = 256


@pytest.mark.parametrize("rows,split", [(r, s) for r in (16, 64, 128, 256) for s in (1, 2, 3, 4)
                                        if r // 8 >= s])
def test_split_exchange_slots_fit_the_plan(rows, split):
    """decode_gemm.cuh's exchange as its loops count it: column block j
    goes to owner j % split, slot j / split there (a running counter, no
    division), its four entries at ((from * owned + slot) * 4 + e) * 256 +
    tid for each pushing rank `from`; the owner's bit mask holds exactly its
    blocks. Every (block, entry, rank, thread) has its own place inside the
    slots that smem_bytes gives the split."""
    blocks = rows // 8
    owned = cdiv(blocks, split)
    part_floats = ((smem_bytes(rows, 0, 0, split, 0) - smem_bytes(rows, 0, 0, 1, 0)) // 4
                   if split > 1 else 0)
    places = {}
    owner, slot = 0, 0
    for j in range(blocks):
        assert (owner, slot) == (j % split, j // split)
        for e in range(4):
            for rank in range(split):
                at = ((rank * owned + slot) * 4 + e) * CONSUMER_THREADS
                places.setdefault((owner, at), []).append((j, e, rank))
                if split > 1:
                    assert at + CONSUMER_THREADS <= part_floats
        owner += 1
        if owner == split:
            owner, slot = 0, slot + 1
    assert all(len(v) == 1 for v in places.values())
    for rank in range(split):
        mask = sum(1 << j for j in range(rank, blocks, split))
        assert [j for j in range(blocks) if (mask >> j) & 1] == \
            [j for j in range(blocks) if j % split == rank]
    core = _source("decode_gemm.cuh")
    assert "for (int j = rank; j < blocks; j += split) m |= 1u << j;" in core
    assert "return part + ((from * owned + slot) * 4 + e) * kDgConsumerThreads + L.tid;" in core


# ---- the bf16 decode FFN (#4) and the fat MoE FFN (#10) on the same core --------

@pytest.mark.parametrize("rows,inter,plan", [
    # the 1.5B FFN (D 2432, I 9728): GEMM1's 76 column tiles whole, GEMM2's
    # 19 with K (152 chunks of 64) in four
    (64, 9728, FfnPlan(GemmPlan(64, 1, 8, 197760, (76, 1)), GemmPlan(64, 4, 8, 230528, (76, 1)))),
    (4, 9728, FfnPlan(GemmPlan(16, 1, 8, 148608, (76, 1)), GemmPlan(16, 4, 8, 156800, (76, 1)))),
    (5, 9728, FfnPlan(GemmPlan(16, 1, 8, 148608, (76, 1)), GemmPlan(16, 4, 8, 156800, (76, 1)))),
    (256, 9728, FfnPlan(GemmPlan(64, 1, 8, 197760, (76, 4)),
                        GemmPlan(64, 1, 8, 197760, (19, 4)))),
    # I 1536: GEMM1's 12 column tiles split K in four too
    (64, 1536, FfnPlan(GemmPlan(64, 4, 8, 230528, (48, 1)), GemmPlan(64, 4, 6, 181344, (76, 1)))),
    (4, 1536, FfnPlan(GemmPlan(16, 4, 8, 156800, (48, 1)), GemmPlan(16, 4, 6, 119904, (76, 1)))),
    (5, 1536, FfnPlan(GemmPlan(16, 4, 8, 156800, (48, 1)), GemmPlan(16, 4, 6, 119904, (76, 1)))),
    (256, 1536, FfnPlan(GemmPlan(64, 2, 8, 230528, (24, 4)),
                        GemmPlan(64, 1, 8, 197760, (19, 4)))),
])
def test_bf16_ffn_plan_at_the_smoke_shapes(rows, inter, plan):
    assert bf16_ffn_plan(rows, 2432, inter, H100_SMS) == plan


@pytest.mark.parametrize("rows,dims,bits,plan", [
    # the 1.5B MoE preset (H 704, 8 experts of 2816, bn 2816: the wide form,
    # 176 GEMM1 blocks); GEMM2's six column tiles over the 8 tiles
    (64, (704, 2816), 8, FatPlan(GemmPlan(64, 0, 6, 154976, (176, 1)),
                                 GemmPlan(64, 8, 8, 231056, (48, 1)), 1)),
    (4, (704, 2816), 8, FatPlan(GemmPlan(16, 0, 6, 113312, (176, 1)),
                                GemmPlan(16, 8, 8, 156944, (48, 1)), 1)),
    (5, (704, 2816), 8, FatPlan(GemmPlan(16, 0, 6, 113312, (176, 1)),
                                GemmPlan(16, 8, 8, 156944, (48, 1)), 1)),
    (256, (704, 2816), 8, FatPlan(GemmPlan(64, 0, 6, 154976, (176, 4)),
                                  GemmPlan(64, 5, 6, 215216, (30, 4)), 2)),
    # the 3B preset in int4 (H 768, experts of 3072, bn 128: 192 tiles, one
    # block a tile in GEMM1); GEMM2 in clusters of 16, 4 (64 rows) or 8 (4
    # rows) tiles a block in each round
    (64, (768, 3072), 4, FatPlan(GemmPlan(64, 1, 6, 111968, (192, 1)),
                                 GemmPlan(64, 16, 5, 221280, (96, 1)), 4)),
    (4, (768, 3072), 4, FatPlan(GemmPlan(16, 1, 6, 70304, (192, 1)),
                                GemmPlan(16, 16, 8, 157840, (96, 1)), 8)),
    (5, (768, 3072), 4, FatPlan(GemmPlan(16, 1, 6, 70304, (192, 1)),
                                GemmPlan(16, 16, 8, 157840, (96, 1)), 8)),
    (256, (768, 3072), 4, FatPlan(GemmPlan(64, 1, 6, 111968, (192, 4)),
                                  GemmPlan(64, 5, 5, 221408, (30, 4)), 4)),
    # I 256 (bn 128, 16 tiles of one chunk)
    (64, (704, 256), 8, FatPlan(GemmPlan(64, 1, 6, 154976, (16, 1)),
                                GemmPlan(64, 16, 1, 58912, (96, 1)), 1)),
    (5, (704, 256), 8, FatPlan(GemmPlan(16, 1, 6, 113312, (16, 1)),
                               GemmPlan(16, 16, 1, 27808, (96, 1)), 1)),
])
def test_fat_plan_at_the_smoke_shapes(rows, dims, bits, plan):
    h, inter = dims
    assert fat_plan(rows, h, inter, 8, fat_block_n(inter), bits, H100_SMS) == plan


def test_bf16_ffn_plan_rules_at_every_shape():
    """Rows 1-256 at many widths: both products split K (chunks of 64) over
    the largest split up to MAX_SPLIT and their chunks whose blocks fit on
    the SMs; stages 1 to 8 and no more than a block's chunks; shared memory
    as the C side computes it, within the limit; the grids cover the column
    tiles, split and row tiles."""
    for rows, d, inter, sms in itertools.product(
            range(1, 257), (128, 704, 2432, 4096), (1024, 1536, 9728, 11008), (132, 16)):
        plan = bf16_ffn_plan(rows, d, inter, sms)
        br = ROW_TILES[0] if rows <= ROW_TILES[0] else ROW_TILES[1]
        row_tiles = cdiv(rows, br)
        for p, k, n in ((plan.up, d, inter), (plan.down, inter, d)):
            chunks, col_tiles = cdiv(k, BW_CHUNK), cdiv(n, TILE_COLS)
            assert p.rows == br
            assert p.split == max(1, min(MAX_SPLIT, chunks, sms // (col_tiles * row_tiles)))
            assert 1 <= p.stages <= min(8, cdiv(chunks, p.split))
            assert p.smem == smem_bytes(br, p.stages, br * 128 + BW_BYTES, 1,
                                        xset_bytes(br, p.split)) <= SMEM_LIMIT
            assert p.grid == (col_tiles * p.split, row_tiles)


FAT_DIMS = [(704, 2816), (768, 3072), (704, 256), (256, 512), (128, 192), (256, 704),
            (128, 1024), (1216, 4096)]


def test_fat_plan_rules_at_every_shape():
    """Rows 1-256 at many widths, int8 and int4, 4 to 64 experts: GEMM1's
    cluster is the bn / 128 blocks of a tile up to MAX_UP_CLUSTER, else 0
    (the wide form, where bn is wider or not whole blocks); GEMM2's split is
    the largest up to MAX_FAT_SPLIT and the tiles whose blocks fit on the
    SMs; its group the largest up to MAX_GROUP and the block's share of the
    tiles whose slots leave MIN_STAGES stages; everything fits in shared
    memory as the C side computes it; the grids cover the column tiles,
    split and row tiles."""
    for rows, (h, inter), bits, experts, sms in itertools.product(
            range(1, 257, 3), FAT_DIMS, (8, 4), (8, 4, 64), (132, 16)):
        bn = fat_block_n(inter)
        if bits == 4 and (h % 128 or bn % 128):
            continue
        plan = fat_plan(rows, h, inter, experts, bn, bits, sms)
        br = ROW_TILES[0] if rows <= ROW_TILES[0] else ROW_TILES[1]
        row_tiles = cdiv(rows, br)
        stage = br * 128 + (W4_BYTES if bits == 4 else W8_BYTES)
        ei, tiles = experts * inter, experts * inter // bn
        wide = bn % TILE_COLS != 0 or bn // TILE_COLS > MAX_UP_CLUSTER
        assert fat_wide(bn) == wide
        assert plan.up.split == (0 if wide else bn // TILE_COLS)
        assert plan.up.grid == (cdiv(ei, TILE_COLS), row_tiles)
        assert 1 <= plan.up.stages <= min(8, cdiv(h, CHUNK))
        assert plan.up.smem == smem_bytes(br, plan.up.stages, stage, 1,
                                          (8 + 1 + MAX_UP_CLUSTER) * br * 4) <= SMEM_LIMIT
        col_tiles = cdiv(h, TILE_COLS)
        split = plan.down.split
        assert split == max(1, min(MAX_FAT_SPLIT, tiles, sms // (col_tiles * row_tiles)))

        def fits(g):
            return smem_bytes(br, MIN_STAGES, stage, 1,
                              down_extra(br, split, g, experts)) <= SMEM_LIMIT
        group = plan.group
        assert 1 <= group <= min(MAX_GROUP, cdiv(tiles, split))
        assert group == 1 or fits(group)
        assert group == min(MAX_GROUP, cdiv(tiles, split)) or not fits(group + 1)
        per_block = cdiv(tiles, split * group) * group * cdiv(bn, CHUNK)
        assert 1 <= plan.down.stages <= min(8, per_block)
        assert plan.down.smem == smem_bytes(br, plan.down.stages, stage, 1,
                                            down_extra(br, split, group, experts)) <= SMEM_LIMIT
        assert plan.down.grid == (col_tiles * split, row_tiles)


def test_the_fat_emulation_follows_the_kernels_source():
    """The emulations below walk the tiles, rounds and adds as the sources
    state them."""
    ffn, moe, core = _source("quant_ffn.cuh"), _source("moe_ffn.cu"), _source("decode_gemm.cuh")
    assert "const int t0 = (rho * split + rank) * group;" in ffn
    assert "for (int q = 0, t = t0; q < split && t < tiles; ++q) {" in core
    assert "for (int g = 0; g < group && t < tiles; ++g, ++t) {" in core
    assert "if (live != nullptr && live[t / tile_experts] == 0) continue;" in core
    assert "const int wgap = per * kDgKC - a.bn;" in ffn
    assert "const int kw = k0 - tile * ch.wgap + wt.row0;" in _source("decode_gemm.cuh")
    assert "bnp = (bn + kDgKC - 1) / kDgKC * kDgKC" in moe
    assert "p[i] = __fmul_rn(__int2float_rn(acc[i]), cv[g * BR + L.row(i)]);" in ffn
    assert "v = __fmul_rn(v, a.comb[(size_t)row * a.experts + t / a.tile_experts]);" in ffn


def _fat_operands(seed, s, h, experts, inter, routed=None):
    """Seeded int8 operands of the fat kernel: rows routed top-2 over the
    first `routed` experts (all by default), so that the others are dead."""
    gen = torch.Generator().manual_seed(seed)
    ei = experts * inter
    w1t_q, w1t_s = quantize_weight(torch.randn((h, ei), generator=gen) * 0.05)
    w2t_q, w2t_s = quantize_weight(torch.randn((ei, h), generator=gen) * 0.05)
    b1t = torch.randn(ei, generator=gen) * 0.1
    x = torch.randn((s, h), generator=gen)
    xs = x.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    logits = torch.randn((s, experts), generator=gen)
    if routed is not None:
        logits[:, routed:] = -float("inf")
    top = logits.topk(2, dim=1)
    comb = torch.zeros((s, experts)).scatter(1, top.indices, torch.softmax(top.values, dim=1))
    return xq, xs, comb, w1t_q, w1t_s, b1t, w2t_q, w2t_s, experts


def _fat_cluster(xq, xs, comb, w1t_q, w1t_s, b1t, w2t_q, w2t_s, experts, split, group,
                 order=None):
    """moe_ffn.cu's launches in numpy: GEMM1's epilogue, each (row, tile)
    absmax as the max of the 128-column blocks' maxima (order-free), hq with
    each tile padded to whole 128-row chunks (the weight's K row of a chunk
    the rows' less the padding of the tiles before it); then, for each row
    tile, GEMM2's rounds: unit u = rho * split + q of rank q holds the tiles
    u * group .. u * group + group - 1, each a fresh exact sum over its
    chunks scaled by hs * combine, and the owners add a round's tiles in
    rank order, inside a rank in group order (``order`` may permute a
    round's adds), skipping the tiles of experts no row of the row tile
    routes to. f32 (S, H) out."""
    s, h = xq.shape
    ei = w1t_q.shape[1]
    inter = ei // experts
    bn = fat_block_n(inter)
    tiles, bnp, tile_experts = ei // bn, cdiv(bn, CHUNK) * CHUNK, inter // bn
    acc1 = torch.from_numpy(xq.numpy().astype(np.int64) @ w1t_q.numpy().astype(np.int64))
    hid = get_activation("gelu")(acc1.float() * xs * w1t_s + b1t)
    cols = np.arange(ei)
    absmax = np.zeros((s, tiles), dtype=np.float32)
    for cb in range(cdiv(ei, TILE_COLS)):
        block = hid[:, cb * TILE_COLS:(cb + 1) * TILE_COLS].abs().numpy()
        for t in np.unique(cols[cb * TILE_COLS:(cb + 1) * TILE_COLS] // bn):
            inside = cols[cb * TILE_COLS:(cb + 1) * TILE_COLS] // bn == t
            absmax[:, t] = np.maximum(absmax[:, t], block[:, inside].max(axis=1))
    hs = torch.clamp(torch.from_numpy(absmax), min=1e-8) * (1.0 / 127.0)
    hq = torch.zeros((s, tiles * bnp), dtype=torch.int64)
    for t in range(tiles):
        q_t = torch.clamp(torch.round(hid[:, t * bn:(t + 1) * bn] / hs[:, t:t + 1]), -127, 127)
        hq[:, t * bnp:t * bnp + bn] = q_t.long()
    w2 = np.concatenate([w2t_q.numpy().astype(np.int64), np.zeros((bnp, h), np.int64)])
    out = torch.zeros((s, h))
    br = ROW_TILES[0] if s <= ROW_TILES[0] else ROW_TILES[1]
    units = cdiv(tiles, group)
    for m0 in range(0, s, br):
        rows = slice(m0, min(s, m0 + br))
        live = (comb[rows] != 0).any(dim=0)
        total = torch.zeros((rows.stop - m0, h))
        for rho in range(cdiv(units, split)):
            held = []                                # (tile, p) in the owners' order
            for q in range(split):
                for g in range(group):
                    t = (rho * split + q) * group + g
                    if t >= tiles or not live[t // tile_experts]:
                        continue
                    acc2 = np.zeros((rows.stop - m0, h), dtype=np.int64)
                    for c in range(bnp // CHUNK):    # chunk c: hq rows and W2 rows
                        k0 = t * bnp + c * CHUNK
                        kw = k0 - t * (bnp - bn)
                        acc2 += hq[rows, k0:k0 + CHUNK].numpy() @ w2[kw:kw + CHUNK]
                    cv = hs[rows, t:t + 1] * comb[rows, t // tile_experts:t // tile_experts + 1]
                    held.append((t, torch.from_numpy(acc2).float() * cv))
            for _, p in (held if order is None else order(held)):
                total = total + p
        out[rows] = total
    return out * w2t_s


@pytest.mark.parametrize("rows,h,experts,inter,split,group,routed", [
    (64, 128, 4, 2816, 4, 1, None),    # bn 2816: the wide form, 22 blocks a tile
    (5, 128, 4, 704, 2, 2, None),      # bn 704: not whole chunks, padded in hq
    (37, 128, 4, 192, 3, 3, None),     # bn 192, two row tiles of 16 and odd groups
    (64, 128, 8, 384, 8, 2, None),     # bn 128: 24 tiles of one chunk
    (4, 128, 8, 384, 16, 2, 3),        # experts 3-7 routed by no row: their tiles skipped
    (20, 128, 8, 384, 5, 3, 2),
])
def test_fat_accumulation_is_the_reference_bit_for_bit(rows, h, experts, inter, split, group,
                                                       routed):
    args = _fat_operands(rows * 31 + split, rows, h, experts, inter, routed)
    out = _fat_cluster(*args, split=split, group=group)
    assert torch.equal(out, expert_ffn_fat_reference(*args))


def test_fat_accumulation_in_another_order_moves_the_sums():
    """The order can be seen: a round's tiles added in reverse give other
    f32 sums than the reference's tile order, which the ranks' order with
    groups inside them gives."""
    args = _fat_operands(5, 64, 128, 8, 384)
    ref = expert_ffn_fat_reference(*args)
    assert torch.equal(_fat_cluster(*args, split=4, group=3), ref)
    moved = _fat_cluster(*args, split=4, group=3, order=lambda held: held[::-1])
    assert not torch.equal(moved, ref)


def _bf16_split(x, w, k_split):
    """One bf16 product as ffn_fused.cu's blocks sum it: K in chunks of 64,
    rank r taking the chunks [r * per, (r + 1) * per) (per = ceil(chunks /
    split)), its f32 partial sum, the ranks' partials added in rank order
    from 0."""
    k = x.shape[1]
    chunks = cdiv(k, BW_CHUNK)
    per = cdiv(chunks, k_split)
    covered, total = [], torch.zeros((x.shape[0], w.shape[1]))
    for r in range(k_split):
        lo, hi = min(k, r * per * BW_CHUNK), min(k, (r + 1) * per * BW_CHUNK)
        covered += list(range(lo, hi))
        total = total + x[:, lo:hi].float() @ w[lo:hi].float()
    assert covered == list(range(k))
    return total


@pytest.mark.parametrize("rows,d,inter", [(64, 256, 1024), (5, 192, 640), (37, 320, 1536)])
def test_bf16_ffn_split_is_the_reference_bit_for_bit(rows, d, inter):
    """The bf16 layout on its plan's splits (and on others), ReLU, with
    values on a grid coarse enough that every f32 sum is exact in any order:
    the hidden rounded to bf16 after bias and activation, the output after
    b2, bit for bit the plain version."""
    gen = torch.Generator().manual_seed(rows + d)

    def grid(*shape, step):
        return (torch.randint(-3, 4, shape, generator=gen) * step).to(torch.bfloat16)
    x, w1, w2 = grid(rows, d, step=0.25), grid(d, inter, step=0.125), grid(inter, d, step=0.125)
    b1, b2 = grid(inter, step=0.125), grid(d, step=0.125)
    ref = ffn_decode_reference(x, w1, b1, w2, b2, "relu")
    plan = bf16_ffn_plan(rows, d, inter, H100_SMS)
    for split_up, split_down in ((plan.up.split, plan.down.split), (1, 1), (3, 4)):
        hid = torch.relu(_bf16_split(x, w1, split_up) + b1.float()).to(torch.bfloat16)
        out = (_bf16_split(hid, w2, split_down) + b2.float()).to(torch.bfloat16)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("rows,split", [(r, s) for r in (16, 64) for s in range(2, 17)])
def test_pair_exchange_places_fit_the_plan(rows, split):
    """decode_gemm.cuh's sliced exchange as its code computes it: the four sums of
    consumer thread t's column block j (pair p = 256 j + t of P = 256 rows /
    8) go to owner p * split / P, at place p - ceil(owner * P / split) of
    its run; every (pushing rank, pair) has its own 16-byte place inside
    the slot set that xset_bytes gives, every owner is a rank, and the
    owners' runs are about P / split pairs each."""
    pairs = rows // 8 * CONSUMER_THREADS
    run = cdiv(pairs, split)
    set_bytes = xset_bytes(rows, split)
    places, runs = set(), collections.Counter()
    for p in range(pairs):
        owner = p * split // pairs
        local = p - cdiv(owner * pairs, split)
        assert 0 <= owner < split and 0 <= local < run
        runs[owner] += 1
        for rank in range(split):
            at = (rank * run + local) * 16
            assert at + 16 <= set_bytes
            places.add((owner, at))
    assert len(places) == pairs * split
    assert max(runs.values()) - min(runs.values()) <= 1
    src = _source("decode_gemm.cuh")
    assert "const int owner = p * split / pairs;" in src
    assert "local = p - (owner * pairs + split - 1) / split;" in src
    assert "reinterpret_cast<float4*>(set) + rank * run + local, owner)" in src


# ---- the per-expert MoE FFN (#11, csrc/moe_dense.cu) --------------------------

@pytest.mark.parametrize("rows,dims,experts,plan", [
    # the 1.5B MoE preset: GEMM1 22 column blocks an expert (grid z 8); GEMM2's
    # 6 column tiles x 8 experts, K split in two over a cluster
    (64, (704, 2816), 8, DensePlan(GemmPlan(64, 0, 6, 154976, (22, 1)),
                                   GemmPlan(64, 2, 8, 230528, (12, 1)))),
    (4, (704, 2816), 8, DensePlan(GemmPlan(16, 0, 6, 113312, (22, 1)),
                                  GemmPlan(16, 2, 8, 156800, (12, 1)))),
    (5, (704, 2816), 8, DensePlan(GemmPlan(16, 0, 6, 113312, (22, 1)),
                                  GemmPlan(16, 2, 8, 156800, (12, 1)))),
    (256, (704, 2816), 8, DensePlan(GemmPlan(64, 0, 6, 154976, (22, 4)),
                                    GemmPlan(64, 1, 8, 197760, (6, 4)))),
    # the smoke's 2-layer models: 8 experts of 512, and 40 of 256 (no split)
    (5, (256, 512), 8, DensePlan(GemmPlan(16, 0, 2, 39520, (4, 1)),
                                 GemmPlan(16, 4, 1, 35856, (8, 1)))),
    (5, (256, 256), 40, DensePlan(GemmPlan(16, 0, 2, 39520, (2, 1)),
                                  GemmPlan(16, 1, 2, 37920, (2, 1)))),
])
def test_dense_plan_at_the_smoke_shapes(rows, dims, experts, plan):
    h, inter = dims
    assert dense_plan(rows, h, inter, experts, H100_SMS) == plan


def test_dense_plan_rules_at_every_shape():
    """Rows 1-256 at many widths and 2 to 64 experts: GEMM1 is the wide form
    (split 0) over ceil(I / 128) column blocks an expert with the whole K;
    GEMM2 splits an expert's ceil(I / 128) chunks over the largest cluster up
    to MAX_FAT_SPLIT whose blocks fit on the SMs beside its column tiles, row
    tiles and experts, with the owner-slot exchange's slots; stages 1 to 8
    and no more than a block's chunks; shared memory as the C side computes
    it, within the limit."""
    for rows, (h, inter), experts, sms in itertools.product(
            range(1, 257, 3), FAT_DIMS, (2, 8, 40, 64), (132, 16)):
        plan = dense_plan(rows, h, inter, experts, sms)
        br = ROW_TILES[0] if rows <= ROW_TILES[0] else ROW_TILES[1]
        row_tiles = cdiv(rows, br)
        stage = br * 128 + W8_BYTES
        assert plan.up.split == 0 and plan.up.rows == plan.down.rows == br
        assert plan.up.grid == (cdiv(inter, TILE_COLS), row_tiles)
        assert 1 <= plan.up.stages <= min(8, cdiv(h, CHUNK))
        assert plan.up.smem == smem_bytes(br, plan.up.stages, stage, 1,
                                          (8 + 1 + MAX_UP_CLUSTER) * br * 4) <= SMEM_LIMIT
        chunks, col_tiles = cdiv(inter, CHUNK), cdiv(h, TILE_COLS)
        split = plan.down.split
        assert split == max(1, min(MAX_FAT_SPLIT, chunks,
                                   sms // (col_tiles * row_tiles * experts)))
        assert 1 <= plan.down.stages <= min(8, cdiv(chunks, split))
        assert plan.down.smem == smem_bytes(br, plan.down.stages, stage, split, 0) <= SMEM_LIMIT
        assert plan.down.grid == (col_tiles * split, row_tiles)


def _dense_emulation(xq, xs, w1q, w1s, b1, w2q, w2s, b2, out_dtype, act, split):
    """csrc/moe_dense.cu's launches in torch: GEMM1 expert by expert into the
    f32 hidden (S, E * I) with each (row, expert) absmax over the whole of I;
    fat_quant_kernel's hs and hq, each expert's I padded with zeros to whole
    128-row chunks (Ip); GEMM2 over the (E * I, H) stack, a K split's ranks
    taking chunks [r * per / split, (r + 1) * per / split) of hq's expert
    tile, a chunk's weight rows e * I + k (reading into the next expert's
    rows, or zeros past the stack, against hq's zero padding); the ranks'
    int32 sums added, then float(acc) * hs * w2_s + b2 in that order."""
    e, h, inter = w1q.shape
    s = xq.shape[0]
    per = cdiv(inter, CHUNK)
    ip = per * CHUNK
    fn = get_activation(act)
    hidden = torch.cat([fn(int_mm(xq, w1q[i]).float() * xs * w1s[i] + b1[i]) for i in range(e)],
                       dim=1)
    absmax = hidden.reshape(s, e, inter).abs().amax(dim=2)
    hs = torch.clamp(absmax, min=1e-8) * (1.0 / 127.0)
    hq = torch.zeros((s, e * ip), dtype=torch.int8)
    for i in range(e):
        hq[:, i * ip:i * ip + inter] = torch.clamp(
            torch.round(hidden[:, i * inter:(i + 1) * inter] / hs[:, i:i + 1]), -127, 127)
    stack = torch.cat([w2q.reshape(e * inter, h), torch.zeros((ip, h), dtype=torch.int8)])
    out = []
    for i in range(e):
        acc = torch.zeros((s, h), dtype=torch.int32)
        for r in range(split):
            lo, hi = r * per // split * CHUNK, (r + 1) * per // split * CHUNK
            if hi > lo:
                rows_ = stack[i * inter + lo:i * inter + hi]
                acc += int_mm(hq[:, i * ip + lo:i * ip + hi], rows_)
        y = acc.float() * hs[:, i:i + 1] * w2s[i] + b2[i]
        out.append(y.to(out_dtype))
    return torch.stack(out)


@pytest.mark.parametrize("s,inter,experts,split,act", [
    (5, 256, 3, 2, "gelu"), (17, 192, 4, 1, "relu"), (17, 192, 4, 2, "silu"),
    (9, 384, 2, 3, "gelu"), (3, 128, 40, 1, "gelu")])
def test_dense_emulation_is_the_reference_bit_for_bit(s, inter, experts, split, act):
    """The per-expert kernel's launches (the padded hq, the K split's int32
    parts, the weight read past an expert's rows against zeros) equal
    expert_ffn_dense_reference bit for bit, I a multiple of 128 or not, at
    any split: the int32 parts add exactly, so the split cannot move the
    result."""
    gen = torch.Generator().manual_seed(s * inter + experts)
    h = 128
    w1q = torch.randint(-127, 128, (experts, h, inter), generator=gen).to(torch.int8)
    w2q = torch.randint(-127, 128, (experts, inter, h), generator=gen).to(torch.int8)
    w1s = torch.rand((experts, 1, inter), generator=gen) * 1e-3
    w2s = torch.rand((experts, 1, h), generator=gen) * 1e-3
    b1 = torch.randn((experts, inter), generator=gen) * 0.1
    b2 = torch.randn((experts, h), generator=gen) * 0.1
    xq = torch.randint(-127, 128, (s, h), generator=gen).to(torch.int8)
    xs = torch.rand((s, 1), generator=gen) * 0.01
    args = (xq, xs, w1q, w1s, b1, w2q, w2s, b2)
    for out_dtype in (torch.bfloat16, torch.float32):
        ref = expert_ffn_dense_reference(*args, out_dtype, act)
        assert torch.equal(_dense_emulation(*args, out_dtype, act, split), ref)
    src = _source("quant_ffn.cuh")
    assert "const int c_lo = rank * a.per / split, c_hi = (rank + 1) * a.per / split;" in src
    assert "DgChunks{slice, 1, 1, a.per, a.per * kDgKC - a.k}" in src
    assert "float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + q]), hs), ws0);" in src
    assert "y0 = __fadd_rn(y0, b0);" in src


# ---- the grouped MoE FFN (#12, csrc/moe_grouped.cu) ---------------------------

@pytest.mark.parametrize("rows,dims,row_tile,plan", [
    # request B's 64 x 32 = 2048 tokens of the 1.5B MoE model: P = 4096 + 8 x
    # 128 rows; GEMM2's 6 column tiles x 40 row tiles of 128 fill the SMs
    (5120, (704, 2816), 0, DensePlan(GemmPlan(128, 0, 6, 210528, (22, 40)),
                                     GemmPlan(128, 1, 7, 230512, (6, 40)))),
    (5120, (704, 2816), 64, DensePlan(GemmPlan(64, 0, 6, 154976, (22, 80)),
                                      GemmPlan(64, 1, 8, 197760, (6, 80)))),
    # the ragged 37 tokens: P = 1152, 6 x 9 tiles of 128 would leave SMs
    # idle: 64 rows, 6 x 18 blocks; at 128 GEMM2 splits in two
    (1152, (704, 2816), 0, DensePlan(GemmPlan(64, 0, 6, 154976, (22, 18)),
                                     GemmPlan(64, 1, 8, 197760, (6, 18)))),
    (1152, (704, 2816), 128, DensePlan(GemmPlan(128, 0, 6, 210528, (22, 9)),
                                       GemmPlan(128, 2, 5, 230480, (12, 9)))),
    # the 2-layer MoE model's bucketed prefill of request A (4 x 64 tokens):
    # 2 x 24 GEMM2 blocks, each expert's 4 chunks split over 2
    (1536, (256, 512), 0, DensePlan(GemmPlan(64, 0, 2, 56608, (4, 24)),
                                    GemmPlan(64, 2, 2, 82976, (4, 24)))),
    # a prefill of 33,000 tokens: P = 66,000 + 8 x 128 rounded down to whole
    # tiles, past a grid's 65,535 in y; the row tiles stay well inside it
    (66944, (704, 2816), 0, DensePlan(GemmPlan(128, 0, 6, 210528, (22, 523)),
                                      GemmPlan(128, 1, 7, 230512, (6, 523)))),
])
def test_grouped_plan_at_the_smoke_shapes(rows, dims, row_tile, plan):
    """grouped_plan's choice (row_tile 0), or the other row tile's plan that
    ``chip_smoke.py --grouped-times`` times beside it."""
    h, inter = dims
    if row_tile == 0:
        assert grouped_plan(rows, h, inter, H100_SMS) == plan
    else:
        assert _expert_plan(rows, row_tile, h, inter, 1, H100_SMS) == plan


@pytest.mark.parametrize("rows", [1, 4096, 65535, 65536, 66944, 200_000])
def test_requantization_covers_every_row_past_the_grid_limit(rows):
    """fat_quant_kernel's rows run over fat_quant_grid's y and z (r = z * gridDim.y
    + y, past the rows nothing), y within 65,535, so every row is requantized
    exactly once at any row count: the grouped FFN's P passes 65,535 from
    32,768 tokens on. Up to 65,535 rows the grid is one slice of a block a
    row, as before. Every launch takes that grid, and the grouped entry
    point's guard is the one its row-tile grids need."""
    grid_z = (rows + 65534) // 65535
    grid_y = (rows + grid_z - 1) // grid_z
    assert grid_y <= 65535 and (grid_z == 1) == (rows <= 65535)
    r = (np.arange(grid_z)[:, None] * grid_y + np.arange(grid_y)[None, :]).ravel()
    assert np.array_equal(r[r < rows], np.arange(rows))
    assert grid_y * grid_z - rows < grid_z       # the blocks that find no row
    ffn, fat, grouped = _source("quant_ffn.cuh"), _source("moe_ffn.cu"), _source("moe_grouped.cu")
    assert "const int z = (rows + 65534) / 65535;" in ffn
    assert "return dim3(tiles, (rows + z - 1) / z, z);" in ffn
    assert "const size_t r = (size_t)blockIdx.z * gridDim.y + blockIdx.y;" in ffn
    assert "if (r >= (size_t)rows || (emap != nullptr && emap[r / kGroupTile] < 0)) return;" in ffn
    # Each launch site starts the aligned or the any-width instance on that grid.
    assert "const dim3 qgrid = fat_quant_grid(f.slices, f.rows);" in ffn
    assert "const dim3 grid = fat_quant_grid(tiles, rows);" in fat
    for any_width in ("true", "false"):
        assert f"fat_quant_kernel<{any_width}><<<qgrid, kBlock, 0, s>>>(" in ffn
        assert f"fat_quant_kernel<{any_width}><<<grid, kBlock, 0, s>>>(" in fat
    assert ffn.count("<<<") + fat.count("<<<") == 4
    assert "rows / row_tile > 65535" in grouped
    # the plan's row tiles at that P fit the y limit, with room to spare
    if rows % TILE == 0:
        plan = grouped_plan(rows, 704, 2816, H100_SMS)
        assert plan.up.grid[1] == plan.down.grid[1] == rows // plan.up.rows <= 65535


def test_grouped_plan_rules_at_every_shape():
    """P from 128 to 8192 rows at many widths: the row tile divides the
    grouped tile, and is the grouped tile only where GEMM2's blocks of 128
    rows fill the SMs; GEMM1 is the wide form over ceil(I / 128) column blocks and
    the row tiles; GEMM2 splits the ceil(I / 128) chunks over the largest
    cluster up to MAX_FAT_SPLIT whose blocks fit on the SMs beside its column
    and row tiles (so none once the row tiles fill them); stages 1 to 8 and no
    more than a block's chunks; shared memory as the C side computes it,
    within the limit."""
    for tiles, (h, inter), br, sms in itertools.product(
            (1, 2, 3, 9, 12, 40, 64), FAT_DIMS, (0, 64, 128), (132, 16)):
        rows = tiles * TILE
        if br == 0:      # the grouped tile where its GEMM2 blocks fill the SMs
            plan = grouped_plan(rows, h, inter, sms)
            br = 128 if tiles * cdiv(h, TILE_COLS) >= sms else 64
        else:
            plan = _expert_plan(rows, br, h, inter, 1, sms)
        assert TILE % br == 0 and plan.up.rows == plan.down.rows == br
        row_tiles, stage = rows // br, br * 128 + W8_BYTES
        assert plan.up.split == 0 and plan.up.grid == (cdiv(inter, TILE_COLS), row_tiles)
        assert 1 <= plan.up.stages <= min(8, cdiv(h, CHUNK))
        assert plan.up.smem == smem_bytes(br, plan.up.stages, stage, 1,
                                          (8 + 1 + MAX_UP_CLUSTER) * br * 4) <= SMEM_LIMIT
        chunks, col_tiles = cdiv(inter, CHUNK), cdiv(h, TILE_COLS)
        split = plan.down.split
        assert split == max(1, min(MAX_FAT_SPLIT, chunks, sms // (col_tiles * row_tiles)))
        assert col_tiles * row_tiles < sms or split == 1
        assert 1 <= plan.down.stages <= min(8, cdiv(chunks, split))
        assert plan.down.smem == smem_bytes(br, plan.down.stages, stage, split, 0) <= SMEM_LIMIT
        assert plan.down.grid == (col_tiles * split, row_tiles)


def _grouped_operands(seed, s, h, experts, inter, probs):
    """Seeded int8 operands of the grouped kernel: s tokens routed to two
    distinct experts each with the (uneven) probabilities ``probs``, laid out
    by the grouped dispatch (padding rows 0, tiles past the last expert's
    -1)."""
    gen = torch.Generator().manual_seed(seed)
    ei = experts * inter
    w1t_q, w1t_s = quantize_weight(torch.randn((h, ei), generator=gen) * 0.05)
    w2t_q, w2t_s = quantize_weight(torch.randn((ei, h), generator=gen) * 0.05)
    b1t = torch.randn(ei, generator=gen) * 0.1
    x = torch.randn((s, h), generator=gen)
    xs = x.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    idx = torch.multinomial(torch.tensor(probs).expand(s, experts), 2, replacement=False,
                            generator=gen)
    dest, emap = grouped_dispatch(idx, experts)
    p = emap.numel() * TILE
    xq_pad = torch.zeros((p, h), dtype=torch.int8)
    xs_pad = torch.zeros((p, 1), dtype=torch.float32)
    xq_pad[dest] = xq.repeat_interleave(2, dim=0)
    xs_pad[dest] = xs.repeat_interleave(2, dim=0)
    return xq_pad, xs_pad, emap, w1t_q, w1t_s, b1t, w2t_q, w2t_s, experts


def _grouped_emulation(xq, xs, emap, w1t_q, w1t_s, b1t, w2t_q, w2t_s, experts, act, plan):
    """csrc/moe_grouped.cu's launches in numpy, block by block: GEMM1 for
    each row tile of the plan's row tile and 128 columns of its expert e =
    emap[m0 // 128] (a tile of -1 skipped), the weight's columns e * I + n0
    on of the fat stack (past the expert's I the next expert's columns, or
    zeros past the stack, multiplied and dropped; x and W1 zero past H), the
    epilogue and each row's absmax over the expert's whole I; the
    requantization with I padded to whole chunks (Ip); GEMM2 for each row
    tile and 128 output columns, the K split's ranks taking chunks [r * per
    / split, (r + 1) * per / split), a chunk's W2 rows e * I + 128 c (into
    the next expert's rows, or zeros past the stack, against hq's padding),
    the int32 parts added, then bf16(float(acc) * hs * w2_s); a tile of -1
    zeros. bf16 (P, H)."""
    p, h = xq.shape
    ei = w1t_q.shape[1]
    inter = ei // experts
    br, split = plan.up.rows, plan.down.split
    per = cdiv(inter, CHUNK)
    ip = per * CHUNK
    hp = cdiv(h, CHUNK) * CHUNK
    x = np.zeros((p, hp), np.int64)
    x[:, :h] = xq.numpy()
    w1 = np.zeros((hp, ei + TILE_COLS), np.int64)
    w1[:h, :ei] = w1t_q.numpy()
    w2 = np.zeros((ei + ip, hp), np.int64)
    w2[:ei, :h] = w2t_q.numpy()
    fn = get_activation(act)
    hidden = torch.full((p, inter), float("nan"))
    absmax = np.zeros(p, np.float32)
    for m0 in range(0, p, br):
        e = int(emap[m0 // TILE])
        if e < 0:
            continue
        rows = slice(m0, m0 + br)
        for n0 in range(0, inter, TILE_COLS):
            cols = slice(e * inter + n0, e * inter + n0 + TILE_COLS)
            acc = torch.from_numpy(x[rows] @ w1[:, cols])
            live = min(TILE_COLS, inter - n0)       # the columns the epilogue keeps
            c = slice(e * inter + n0, e * inter + n0 + live)
            blk = fn(acc[:, :live].float() * xs[rows] * w1t_s[:, c] + b1t[c])
            hidden[rows, n0:n0 + live] = blk
            absmax[rows] = np.maximum(absmax[rows], blk.abs().amax(dim=1).numpy())
    hs = torch.clamp(torch.from_numpy(absmax)[:, None], min=1e-8) * (1.0 / 127.0)
    hq = np.zeros((p, ip), np.int64)
    out = torch.zeros((p, h), dtype=torch.bfloat16)
    for m0 in range(0, p, br):
        e = int(emap[m0 // TILE])
        if e < 0:
            continue                                 # the zeros GEMM2 writes
        rows = slice(m0, m0 + br)
        hq[rows, :inter] = torch.clamp(torch.round(hidden[rows] / hs[rows]), -127, 127).numpy()
        for n0 in range(0, h, TILE_COLS):
            acc = np.zeros((br, TILE_COLS), np.int64)
            for r in range(split):
                for ch in range(r * per // split, (r + 1) * per // split):
                    kw = e * inter + ch * CHUNK
                    acc += hq[rows, ch * CHUNK:(ch + 1) * CHUNK] @ w2[kw:kw + CHUNK,
                                                                       n0:n0 + TILE_COLS]
            live = min(TILE_COLS, h - n0)
            y = torch.from_numpy(acc[:, :live]).float() * hs[rows] * w2t_s[:, n0:n0 + live]
            out[rows, n0:n0 + live] = y.to(torch.bfloat16)
    return out


@pytest.mark.parametrize("s,h,experts,inter,sms,row_tile,act", [
    # uneven loads, the last expert empty; H and I not multiples of 128
    (37, 192, 4, 192, 132, 128, "gelu"),
    (37, 192, 4, 192, 132, 64, "relu"),
    # a K split (few SMs) at I = 384 (3 chunks), and 5 experts of 128
    (70, 128, 4, 384, 16, 128, "silu"),
    (90, 320, 5, 128, 4, 64, "gelu"),
])
def test_grouped_emulation_is_the_reference_bit_for_bit(s, h, experts, inter, sms, row_tile,
                                                        act):
    """The grouped kernel's launches (a row tile's expert from emap, the fat
    stack's columns and rows from e * I, the padded hq, the K split's int32
    parts) equal expert_ffn_grouped_reference bit for bit, with uneven loads,
    an empty expert, tiles of no expert and H and I not multiples of 128, at
    either row tile and any split: the int32 parts add exactly, so neither
    can move the result."""
    probs = [8.0, 4, 2, 1, 1][:experts - 1] + [0.0]
    args = _grouped_operands(s * 7 + experts, s, h, experts, inter, probs)
    emap = args[2]
    assert (emap < 0).any() and int(emap[emap >= 0].max()) < experts - 1
    plan = _expert_plan(args[0].shape[0], row_tile, h, inter, 1, sms)
    ref = expert_ffn_grouped_reference(*args, act)
    assert torch.equal(_grouped_emulation(*args, act, plan), ref)
    ffn, grouped = _source("quant_ffn.cuh"), _source("moe_grouped.cu")
    assert "const int wexp = kGrouped ? a.emap[m0 / kGroupTile] : 0;" in ffn
    assert "ffn_up_kernel<false, BR, true, kGrouped>" in ffn
    assert "n0 + wexp * a.n, m0," in ffn
    assert "const int e = kGrouped ? a.emap[m0 / kGroupTile] : slice;" in ffn
    assert ("const DgWeight wt{kAny ? static_cast<const int8_t*>(a.w) : nullptr, a.experts * a.k, "
            "a.n,\n                    kAny ? !a.w_own : 1, (e - slice) * a.k};") in ffn
    assert "if (r >= (size_t)rows || (emap != nullptr && emap[r / kGroupTile] < 0)) return;" in ffn
    assert "expert_ffn_run<128, true>(f, split, st_up, st_down, s)" in grouped
