"""The host side and the arithmetic of the int8 decode kernels, on the CPU.

``csrc/ssm_step.cu`` (the int8 layout of the decode mixer step, #3) and
``csrc/ffn_fused.cu`` (the int8 and int4 decode FFN, #4) run swapped-operand
int8 ``wgmma`` products (``csrc/decode_gemm.cuh``) on the plans of
``ops/kernels/decode_plan.py``. The kernels build and run only on the card,
where ``chip_smoke.py`` holds them against their plain versions. Here:
the plans at the shapes the smoke runs and their rules at every shape; the
int8 and int4 A-fragment build (swizzled tile, ``ldmatrix.trans`` row
choice, byte permutes, nibble unpacking) emulated lane by lane against the
PTX fragment layout and ``unpack_int4``; the decode FFN's K split over a
cluster, whose tile-ordered f32 accumulation must equal
``ffn_decode_int8_reference`` bit for bit; and the split's exchange slots
inside the plans' shared memory.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from apertis_llm_torch.models.quantize import quantize_weight, quantize_weight_int4, unpack_int4
from apertis_llm_torch.ops.activations import get_activation
from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.kernels.decode_plan import (
    CHUNK, MAX_SPLIT, MAX_UP_CLUSTER, ROW_TILES, SMEM_LIMIT, TILE_COLS, W4_BYTES, W8_BYTES,
    FfnPlan, GemmPlan, StepPlan, ffn_plan, smem_bytes, ssm_step_plan)
from apertis_llm_torch.ops.kernels.ffn_fused import ffn_decode_int8_reference, pick_block_n

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


@pytest.mark.parametrize("rows,inter,bits,plan", [
    # the 1.5B FFN (D 2432, I 9728, bn 512): GEMM1's 76 blocks in clusters of
    # four (one hidden tile each), GEMM2's 19 column tiles with K in four
    (64, 9728, 8, FfnPlan(GemmPlan(64, 4, 8, 204160, (76, 1)),
                          GemmPlan(64, 4, 8, 230528, (76, 1)))),
    (4, 9728, 8, FfnPlan(GemmPlan(16, 4, 8, 150208, (76, 1)),
                         GemmPlan(16, 4, 8, 164992, (76, 1)))),
    (64, 9728, 4, FfnPlan(GemmPlan(64, 4, 8, 146816, (76, 1)),
                          GemmPlan(64, 4, 8, 173184, (76, 1)))),
    (5, 9728, 4, FfnPlan(GemmPlan(16, 4, 8, 92864, (76, 1)),
                         GemmPlan(16, 4, 8, 107648, (76, 1)))),
    # I 1536: two hidden tiles of 768, clusters of six
    (64, 1536, 8, FfnPlan(GemmPlan(64, 6, 8, 204160, (12, 1)),
                          GemmPlan(64, 2, 6, 181344, (38, 1)))),
    (256, 1536, 8, FfnPlan(GemmPlan(64, 6, 8, 204160, (12, 4)),
                           GemmPlan(64, 1, 8, 197760, (19, 4)))),
    (256, 9728, 8, FfnPlan(GemmPlan(64, 4, 8, 204160, (76, 4)),
                           GemmPlan(64, 1, 8, 197760, (19, 4)))),
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
        assert down.smem == smem_bytes(br, down.stages, stage, down.split, 0) <= SMEM_LIMIT
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
