"""The host side and the arithmetic of the decode kernels' f32 forms, on the CPU.

The f32 forms of the decode FFN (#4, ``csrc/ffn_fused.cu``) and of the mixer
step (#3, ``csrc/ssm_step.cu``) serve an f32 tree and its int8 quantization
(f32 norms, biases and rows) on the Hopper products of
``csrc/decode_gemm.cuh``: int8 weights through the int8 layout's kernels,
f32 weights in split TF32 (``kDgTF``: each f32 value as TF32 hi and lo parts,
hi.hi + lo.hi + hi.lo), bf16 weights as the bf16 layout's. The kernels build
and run only on the card, where ``chip_smoke.py`` (phase 3i) holds them
against their plain versions. Here: their plans at the 1.5B dense, MoE and
MHA widths; which dtype mixes reach which form and plan; the split-TF32
product emulated by bits against f64 (three products inside the forms'
tolerance, one TF32 product outside it); and the A-fragment layout of an f32
weight tile against the PTX fragment layout and the epilogue's columns.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from apertis_llm_torch.ops.kernels import _build, decode_plan, ffn_fused, ssm_step
from apertis_llm_torch.ops.kernels.decode_plan import (
    BW_BYTES, BW_CHUNK, CHUNK, SMEM_LIMIT, TF_BYTES, TF_CHUNK, TILE_COLS, W8_BYTES,
    f32_ffn_plan, f32_step_plan, ffn_plan, smem_bytes, ssm_step_plan, xset_bytes)
from apertis_llm_torch.ops.kernels.ssm_step import MixerWeights

H100_SMS = 132
CSRC = Path(ffn_fused.__file__).resolve().parents[2] / "csrc"
# chip_smoke.py's tolerance of the f32 forms: relative to the largest value.
F32_FORM_TOL = 1e-4

# (label, D, C, R, I): the 1.5B dense preset (its mixer and FFN), the 1.5B
# MoE preset's mixer (hidden 704, 11 heads of 16) and the 1.5B MHA preset's
# FFN (hidden 2432, I 9728).
WIDTHS = [("1.5B dense", 2432, 608, 152, 9728), ("1.5B MoE", 704, 176, 44, None),
          ("1.5B MHA", 2432, None, None, 9728)]
ROWS = (1, 4, 64, 256)


def cdiv(a, b):
    return -(-a // b)


@pytest.fixture(autouse=True)
def _keep_launch_counts():
    """The routing tests reach the wrappers, which count their launches;
    other test files assert the counts from 0, so each test leaves them as
    it found them."""
    counted = [f for mod in (ffn_fused, ssm_step) for f in vars(mod).values()
               if callable(f) and hasattr(f, "launches")]
    before = [f.launches for f in counted]
    yield
    for f, n in zip(counted, before):
        f.launches = n


def _check_float_gemm(p, k, n, rows, tf32, lo):
    """One float product's plan: the row tile, the split, the stages and the
    shared memory of ``dg_smem_bytes`` with the sliced exchange's slots."""
    br = 16 if rows <= 16 else 64
    chunk, w_bytes = (TF_CHUNK, TF_BYTES) if tf32 else (BW_CHUNK, BW_BYTES)
    stage = (2 if tf32 and lo else 1) * br * 128 + w_bytes
    assert p.rows == br
    assert 1 <= p.split <= min(8 if tf32 else 4, cdiv(k, chunk))
    assert p.split in (1, 2, 3, 4, 8)
    # A split only where its blocks, in whole clusters, fit one wave.
    assert p.split == 1 or p.grid[0] * p.grid[1] <= H100_SMS
    assert p.grid == (cdiv(n, TILE_COLS) * p.split, cdiv(rows, br))
    assert 1 <= p.stages <= min(8, cdiv(cdiv(k, chunk), p.split))
    assert p.smem == smem_bytes(br, p.stages, stage, 1, xset_bytes(br, p.split))
    assert p.smem <= SMEM_LIMIT
    # No stage more would fit, unless the cap or the chunks stop it.
    assert (p.stages == min(8, cdiv(cdiv(k, chunk), p.split))
            or p.smem + stage + 16 > SMEM_LIMIT)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("label,d,c,r,inter", [w for w in WIDTHS if w[4] is not None])
def test_f32_ffn_plans_fit_the_card(rows, label, d, c, r, inter):
    """The f32 FFN's plan for each weight mix (f32 weights in split TF32,
    bf16 ones as the bf16 layout's), on bf16 and f32 rows, and the int8
    layout's plan that its int8 form runs, within the card's shared
    memory."""
    for w1_tf, w2_tf in ((True, True), (True, False), (False, True), (False, False)):
        for x_lo in (False, True):
            plan = f32_ffn_plan(rows, d, inter, w1_tf, w2_tf, x_lo, H100_SMS)
            _check_float_gemm(plan.up, d, inter, rows, w1_tf, x_lo)
            _check_float_gemm(plan.down, inter, d, rows, w2_tf, True)
            if not (w1_tf or w2_tf):
                assert plan == decode_plan.bf16_ffn_plan(rows, d, inter, H100_SMS)
    q = ffn_plan(rows, d, inter, ffn_fused.pick_block_n(inter), 8, H100_SMS)
    for p in q:
        assert p.smem <= SMEM_LIMIT and p.stages >= 1
        assert (p.smem - smem_bytes(p.rows, 0, p.rows * 128 + W8_BYTES, 1, 0)) >= \
            p.stages * (p.rows * 128 + W8_BYTES)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("label,d,c,r,inter", [w for w in WIDTHS if w[2] is not None])
def test_f32_step_plans_fit_the_card(rows, label, d, c, r, inter):
    """The f32 step's three products (in_proj x and z, x_param, out_proj):
    split TF32 with a lo tile (the row kernels' rows are f32), bf16
    projections as the bf16 layout's, int8 ones on the int8 step's plan."""
    plan = f32_step_plan(rows, d, c, r, H100_SMS)
    for p, k, n in ((plan.inp, d, 2 * cdiv(c, TILE_COLS) * TILE_COLS), (plan.mix, c, r + 2 * c),
                    (plan.out, c, d)):
        _check_float_gemm(p, k, n, rows, True, True)
    assert f32_step_plan(rows, d, c, r, H100_SMS, tf32=False) == \
        decode_plan.bf16_step_plan(rows, d, c, r, H100_SMS)
    for p in ssm_step_plan(rows, d, c, r, H100_SMS):
        assert p.smem <= SMEM_LIMIT and p.stages >= 1 and p.split <= cdiv(max(d, c), CHUNK)


def test_split_tf32_plan_at_the_chat_shape():
    """One chat token of the 1.5B f32 model (1 row, the step's bf16 FFN
    input): GEMM1 over 76 column tiles whole, no lo tile; GEMM2 split in
    four over its 19 column tiles (eight would not fit one wave); the
    mixer's in_proj and x_param split in eight (clusters of 8) over their
    10 and 11 column tiles, out_proj in four over its 19."""
    ffn = f32_ffn_plan(1, 2432, 9728, True, True, False, H100_SMS)
    assert ffn.up == decode_plan.GemmPlan(16, 1, 8, smem_bytes(16, 8, 16 * 128 + TF_BYTES, 1, 0),
                                          (76, 1))
    assert (ffn.down.split, ffn.down.grid) == (4, (76, 1))
    step = f32_step_plan(1, 2432, 608, 152, H100_SMS)
    assert [(p.split, p.grid) for p in step] == [(8, (80, 1)), (8, (88, 1)), (4, (76, 1))]


# ---- which form takes which dtype mix -----------------------------------------

def _reached(what):
    raise RuntimeError(f"the {what}'s launch was reached")


def _meta(shape, dtype):
    """A tensor that is not on the CPU (so the wrappers take the card's
    route) and holds no data."""
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("xdt,w1dt,w2dt,bdt,odt,form", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.bfloat16, None, "ffn_decode"),
    (torch.bfloat16, torch.float32, torch.float32, torch.float32, torch.float32, "f32"),
    (torch.float32, torch.float32, torch.float32, torch.float32, None, "f32"),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32, torch.float32, "f32"),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32, "f32"),
    (torch.float32, torch.bfloat16, torch.float32, torch.bfloat16, None, "f32"),
])
def test_ffn_dtype_mixes_reach_their_form(monkeypatch, xdt, w1dt, w2dt, bdt, odt, form):
    """ffn_decode keeps an all-bf16 FFN on the bf16 layout and sends every
    other mix to the f32 form, whose plan runs each weight in its own kind:
    an f32 weight in split TF32 (GEMM1 with a lo tile where x is not bf16),
    a bf16 one as the bf16 layout's."""
    calls = []
    monkeypatch.setattr(ffn_fused, "ffn_decode_f32", lambda *a: calls.append("f32"))
    monkeypatch.setattr(ffn_fused._build, "check_tensor", lambda *a: None)
    monkeypatch.setattr(ffn_fused._build, "check_aligned", lambda *a: None)
    monkeypatch.setattr(ffn_fused, "bf16_plan", lambda *a: _reached("bf16 layout"))
    monkeypatch.setattr(ffn_fused._build, "sm_count", lambda index: H100_SMS)
    d, inter = 256, 512
    args = (_meta((4, d), xdt), _meta((d, inter), w1dt), _meta((inter,), bdt),
            _meta((inter, d), w2dt), _meta((d,), bdt))
    if form == "f32":
        ffn_fused.ffn_decode(*args, out_dtype=odt)
        assert calls == ["f32"]
        plan = ffn_fused.f32_plan(args[0], args[1], args[3])
        assert plan == f32_ffn_plan(4, d, inter, w1dt == torch.float32, w2dt == torch.float32,
                                    xdt == torch.float32, H100_SMS)
        x_tiles = 2 if w1dt == torch.float32 and xdt == torch.float32 else 1
        w_bytes = TF_BYTES if w1dt == torch.float32 else BW_BYTES
        assert plan.up.smem == smem_bytes(16, plan.up.stages, x_tiles * 16 * 128 + w_bytes, 1,
                                          xset_bytes(16, plan.up.split))
    else:
        with pytest.raises(Exception, match="bf16 layout's launch was reached"):
            ffn_fused.ffn_decode(*args, out_dtype=odt)
        assert calls == []


@pytest.mark.parametrize("bdt,odt,f32_form", [
    (torch.bfloat16, torch.bfloat16, False), (torch.float32, torch.float32, True),
    (torch.float32, torch.bfloat16, True), (torch.bfloat16, torch.float32, True)])
def test_int8_ffn_biases_and_output_pick_the_form(monkeypatch, bdt, odt, f32_form):
    """ffn_decode_int8 keeps bf16 biases and output on the int8 layout's
    entry and sends f32 ones to apertis_ffn_decode_int8_f32, the same two
    launches on the same plan."""
    seen = []
    monkeypatch.setattr(ffn_fused, "ffn_decode_int8_f32", lambda *a: seen.append("int8_f32"))
    monkeypatch.setattr(ffn_fused._build, "check_tensor", lambda *a: seen.append("checked"))
    monkeypatch.setattr(ffn_fused._build, "check_aligned", lambda *a: None)
    monkeypatch.setattr(ffn_fused, "_quant_scratch", lambda *a: _reached("int8 layout"))
    d, inter = 256, 512
    args = (_meta((4, d), torch.int8), _meta((4, 1), torch.float32),
            _meta((d, inter), torch.int8), _meta((1, inter), torch.float32),
            _meta((inter,), bdt), _meta((inter, d), torch.int8), _meta((1, d), torch.float32),
            _meta((d,), bdt))
    if f32_form:
        ffn_fused.ffn_decode_int8(*args, out_dtype=odt)
        assert seen == ["int8_f32"]
    else:
        with pytest.raises(Exception, match="int8 layout's launch was reached"):
            ffn_fused.ffn_decode_int8(*args, out_dtype=odt)


def _mixer(d, c, r, proj_dtype, small_dtype):
    heads = c // 16

    def t(*shape, dtype=small_dtype):
        return _meta(shape, dtype)
    return MixerWeights(t(d), t(d), t(d, c, dtype=proj_dtype), t(d, c, dtype=proj_dtype),
                        t(c, 4), t(c), t(c, r + 2 * c, dtype=proj_dtype), t(r, heads),
                        t(heads), t(heads, 16), t(c), t(c, d, dtype=proj_dtype),
                        *([t(1, c, dtype=torch.float32), t(1, c, dtype=torch.float32),
                           t(1, r + 2 * c, dtype=torch.float32), t(1, d, dtype=torch.float32)]
                          if proj_dtype == torch.int8 else []))


@pytest.mark.parametrize("proj,small,rows_dtype,form", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, "bf16"),
    (torch.int8, torch.bfloat16, torch.bfloat16, "int8"),
    (torch.float32, torch.float32, torch.float32, "f32"),
    (torch.int8, torch.float32, torch.float32, "int8_f32"),
    (torch.bfloat16, torch.float32, torch.float32, "f32"),
    (torch.int8, torch.bfloat16, torch.float32, "int8_f32"),
    (torch.float32, torch.bfloat16, torch.bfloat16, "f32"),
])
def test_step_dtype_mixes_reach_their_form(monkeypatch, proj, small, rows_dtype, form):
    """ssm_decode_step sends a step whose rows and float weights are all bf16
    to the Hopper layouts and any other to the f32 forms (hopper_layout),
    whose plan is the int8 step's for int8 projections, split TF32 for f32
    ones and the bf16 layout's for bf16 ones."""
    d, c, r = 2432, 608, 152
    w = _mixer(d, c, r, proj, small)
    h, conv, ssm = _meta((4, d), rows_dtype), _meta((4, 3, c), rows_dtype), _meta((4, c),
                                                                                  torch.float32)
    seen = []
    for name in ("ssm_decode_step_f32", "ssm_decode_step_int8_f32", "ssm_decode_step_int8"):
        monkeypatch.setattr(ssm_step, name, lambda *a, name=name: seen.append(name))
    monkeypatch.setattr(ssm_step, "_launch_step", lambda *a: seen.append("bf16") or (0, ()))
    monkeypatch.setattr(ssm_step._build, "check", lambda *a: None)
    monkeypatch.setattr(ssm_step._build, "sm_count", lambda index: H100_SMS)
    ssm_step.ssm_decode_step(h, conv, ssm, w, 1e-5)
    assert seen == [{"bf16": "bf16", "int8": "ssm_decode_step_int8",
                     "f32": "ssm_decode_step_f32",
                     "int8_f32": "ssm_decode_step_int8_f32"}[form]]
    if form in ("f32", "int8_f32"):
        plan = ssm_step.step_plan(h, w, f32_form=True)
        want = (ssm_step_plan(4, d, c, r, H100_SMS) if proj == torch.int8 else
                f32_step_plan(4, d, c, r, H100_SMS, tf32=proj == torch.float32))
        assert plan == want


# ---- the split-TF32 arithmetic -----------------------------------------------

def tf32_round(x: np.ndarray) -> np.ndarray:
    """hopper.cuh::tf32_round: to TF32 (10 mantissa bits), to nearest with
    ties away from zero, by the bits: add half a TF32 ulp to the magnitude's
    bits and clear the low 13."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x: np.ndarray):
    hi = tf32_round(x)
    return hi, tf32_round((x.astype(np.float32) - hi).astype(np.float32))


def split_tf32_product(x: np.ndarray, w: np.ndarray, products: int = 3) -> np.ndarray:
    """decode_gemm.cuh's split-TF32 product of rows x (S, K) and an f32
    weight w (K, N): per 32-K chunk a fresh accumulator of hi.hi + lo.hi +
    hi.lo (the TF32 values multiply exactly; the chunk's f32 sum taken in
    f64 and rounded once), the chunks' sums added in order in f32; with
    ``products`` 1, one TF32 product hi.hi."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    out = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], 32):
        sl = slice(k0, k0 + 32)
        part = xh[:, sl].astype(np.float64) @ wh[sl].astype(np.float64)
        if products == 3:
            part += xh[:, sl].astype(np.float64) @ wl[sl].astype(np.float64)
            part += xl[:, sl].astype(np.float64) @ wh[sl].astype(np.float64)
        out = (out + part.astype(np.float32)).astype(np.float32)
    return out


def test_tf32_rounding_follows_the_kernels_source():
    src = (CSRC / "hopper.cuh").read_text()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in src
    assert "__uint_as_float(tf32_round(x - hi))" in src
    dg = (CSRC / "decode_gemm.cuh").read_text()
    # Three products a k8 step, a fresh accumulator a chunk (acc flag 0 on
    # the step-0 hi.hi), the chunk's sum added with an f32 add.
    assert "WgmmaTf32<BR>::rs(t, f[kk][0], bh, kk > 0 ? 1 : 0);" in dg
    assert "WgmmaTf32<BR>::rs(t, f[kk][1], bh, 1);" in dg
    assert "acc[j] = __fadd_rn(acc[j], t[j]);" in dg
    assert 32 == TF_CHUNK


def test_tf32_split_is_exact_on_bf16_and_carries_f32():
    g = np.random.default_rng(0)
    x = g.standard_normal(10_000).astype(np.float32)
    hi, lo = split_tf32(x)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0) and np.all((lo.view(np.uint32) & 0x1FFF) == 0)
    # hi + lo carries x to about 2^-22 of it.
    assert np.max(np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)) < 2.0 ** -21
    b = torch.from_numpy(x).bfloat16().float().numpy()
    bh, bl = split_tf32(b)
    assert np.array_equal(bh, b) and not np.any(bl)


def test_split_tf32_product_is_inside_the_f32_tolerance():
    """At 64 rows of 2432 by a 2432 x 256 f32 weight: the three-product
    split (hi.hi + lo.hi + hi.lo) stays well inside chip_smoke.py's
    F32_FORM_TOL of the f64 product, where one TF32 product (what TF32
    cuBLAS computes) falls outside it."""
    g = np.random.default_rng(23)
    x = g.standard_normal((64, 2432)).astype(np.float32)
    w = (g.standard_normal((2432, 256)) / np.sqrt(2432)).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).max()
    three = np.abs(split_tf32_product(x, w) - exact).max() / scale
    one = np.abs(split_tf32_product(x, w, products=1) - exact).max() / scale
    assert three < F32_FORM_TOL / 100
    assert one > F32_FORM_TOL
    # bf16 rows have no lo part: two products give the three's result.
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    assert np.abs(split_tf32_product(xb, w) - xb.astype(np.float64) @ w).max() / scale < \
        F32_FORM_TOL / 100


# ---- the A fragments of an f32 weight tile ------------------------------------

def tf_frag_offset(wg, warp, lane, half):
    """decode_gemm.cuh::tf_frag_offset: the byte offset of the lane's two
    columns at K row lane % 4 + 4 half of a chunk's first k8 step."""
    col = 64 * wg + 16 * warp + 2 * (lane >> 2)
    k, c = (lane & 3) + 4 * half, col & 31
    return (col >> 5) * TF_CHUNK * 128 + k * 128 + (((c >> 2) ^ k) << 4) + (c & 3) * 4


def tma_tile(w: np.ndarray) -> np.ndarray:
    """The stage's f32 weight tile (32 K rows x 128 columns) as TMA writes
    it: four 32-column blocks, each 32 rows of 128 bytes in the 128-byte
    swizzle (16-byte chunk j of row k at j ^ (k % 8))."""
    out = np.zeros(TF_BYTES // 4, np.float32)
    for k in range(32):
        for col in range(128):
            blk, c = divmod(col, 32)
            byte = blk * 32 * 128 + k * 128 + (((c >> 2) ^ (k & 7)) << 4) + (c & 3) * 4
            out[byte // 4] = w[k, col]
    return out


def test_tf32_fragments_follow_the_ptx_layout():
    """Each lane's A fragment of k8 step kk holds, in register i, the
    weight at K row 8 kk + lane % 4 + 4 (i // 2) of the column that wgmma's
    M row 16 warp + lane // 4 + 8 (i % 2) stands for (the PTX m64nNk8 TF32
    A layout); those columns are the int8 kinds' order (M row 16 w + g + 8 h
    is column 16 w + 2 g + h), a bijection onto the warpgroup's 64 columns,
    and the accumulator's entry e of a lane is then column DgLane::column,
    64 wg + 16 warp + 2 (lane // 4) + (e % 4) // 2."""
    g = np.random.default_rng(1)
    w = g.standard_normal((32, 128)).astype(np.float32)
    tile = tma_tile(w)
    for wg in range(2):
        m_to_col = {}
        for warp in range(4):
            for lane in range(32):
                off = [tf_frag_offset(wg, warp, lane, h) for h in (0, 1)]
                for kk in range(4):
                    a = tile[(off[0] + kk * 1024) // 4:(off[0] + kk * 1024) // 4 + 2]
                    b = tile[(off[1] + kk * 1024) // 4:(off[1] + kk * 1024) // 4 + 2]
                    regs = [a[0], a[1], b[0], b[1]]
                    for i, v in enumerate(regs):
                        m_row = 16 * warp + lane // 4 + 8 * (i % 2)
                        k = 8 * kk + lane % 4 + 4 * (i // 2)
                        col = 64 * wg + 16 * warp + 2 * (lane >> 2) + (i % 2)
                        assert v == w[k, col]
                        assert m_to_col.setdefault(m_row, col) == col
                # The accumulator rows of this lane are M rows lane // 4 and
                # + 8: columns col and col + 1, DgLane::column's.
                for e in range(4):
                    m_row = 16 * warp + lane // 4 + 8 * (e // 2)
                    assert m_to_col[m_row] == 64 * wg + 16 * warp + 2 * (lane >> 2) + (e % 4) // 2
        assert sorted(m_to_col.values()) == list(range(64 * wg, 64 * wg + 64))
    src = (CSRC / "decode_gemm.cuh").read_text()
    assert "return (L.col >> 5) * kDgTFBlock + k * 128 + (((c >> 2) ^ k) << 4) + (c & 3) * 4;" in src


def test_scratch_and_codes_follow_the_sources():
    """The f32 FFN's C entry takes the plan and one scratch buffer; the
    routing reads float codes 1 bf16, 0 f32."""
    assert _build.SIGNATURES["apertis_ffn_decode_f32"][7:22] == [_build._I] * 15
    assert _build.float_code(torch.empty(1, dtype=torch.bfloat16), "x") == 1
    assert _build.float_code(torch.empty(1), "x") == 0
    assert "simt.cuh" not in _build.HEADERS and not (CSRC / "simt.cuh").exists()
