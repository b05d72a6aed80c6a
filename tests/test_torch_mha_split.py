"""The split decode attention (#9, ``csrc/mha_step.cu``) on the CPU.

The kernel splits each (row, head)'s slots over ``mha_plan``'s blocks, runs
an online softmax over each block's tiles and adds the blocks' maxima, sums
and contexts in rank order. Its plan is plain Python and is pinned here;
its order of sums is emulated in plain torch (``_emulate``, used by these
tests only) and held against the JAX package's kernel
(``apertis_llm_tpu/ops/pallas/mha_step.py::mha_decode_ctx``, in interpret
mode on the CPU, as ``tests/test_torch_mha.py`` runs it) at the tolerances
the port's plain version is held to: f32 1e-5, bf16 one bf16 ulp of the
largest value, an int8 cache under f32 rows 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apertis_llm_tpu.ops.pallas import mha_step as jax_mha_step
from apertis_llm_torch.ops.kernels.decode_plan import SMEM_LIMIT
from apertis_llm_torch.ops.kernels.mha_step import (
    MHA_FULL_SMEM, MHA_MAX_SPLIT, MHA_SHORT_SPLIT_SLOTS, MHA_SMEM, MHA_SPLIT_SLOTS, MHA_STAGES,
    MHA_WARPS, NEG, _HEAD_DIMS,
    mha_decode_ctx_reference, mha_parts, mha_plan, mha_smem, mha_splits, mha_stages, mha_tile,
    quantize_heads)

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7     # one bf16 ulp relative to the largest value
SMS = 132                # the H100's SMs
# (cache dtype, row dtype) of the four forms.
FORMS = (("bfloat16", "bfloat16"), ("int8", "bfloat16"), ("float32", "float32"),
         ("int8", "float32"))


# ---- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("cache,rows", FORMS)
@pytest.mark.parametrize("heads", [11, 38])
@pytest.mark.parametrize("length", [96, 256, 296, 2048])
def test_plan_one_block_where_rows_fill_the_card(cache, rows, heads, length):
    """64 rows x 11 or 38 heads already fill the 132 SMs: one block a
    (row, head)."""
    plan = mha_plan(64, heads, length, 64, cache, rows, SMS)
    assert plan.split == 1 and plan.grid == 64 * heads


@pytest.mark.parametrize("cache,rows", FORMS)
@pytest.mark.parametrize("batch,length", [(1, 1), (1, 8), (1, 43), (4, 43), (12, 88),
                                          (1, 88), (4, 88), (1, 127)])
def test_plan_one_block_over_a_short_cache(cache, rows, batch, length):
    """A cache shorter than two splits' least slots keeps one block a
    (row, head): MHA_SPLIT_SLOTS for an int8 cache or many pairs,
    MHA_SHORT_SPLIT_SLOTS for a float cache at few."""
    plan = mha_plan(batch, 11, length, 64, cache, rows, SMS)
    least = (MHA_SHORT_SPLIT_SLOTS if cache != "int8" and 3 * batch * 11 <= SMS
             else MHA_SPLIT_SLOTS)
    assert (plan.split == 1) == (length < 2 * least)


@pytest.mark.parametrize("cache,rows", FORMS)
@pytest.mark.parametrize("heads", [11, 38])
def test_plan_fills_the_card_at_batch_1_over_a_long_cache(cache, rows, heads):
    """At (1, 2048) the split brings B * H * S to the SMs, within the
    cluster limit."""
    plan = mha_plan(1, heads, 2048, 64, cache, rows, SMS)
    assert 1 < plan.split <= MHA_MAX_SPLIT
    assert heads * plan.split >= SMS
    assert plan.grid == heads * plan.split
    assert 2048 // plan.split >= MHA_SPLIT_SLOTS


@pytest.mark.parametrize("batch,heads,length,head_dim,bf16_split,int8_split", [
    (1, 38, 2048, 64, 7, 7), (1, 11, 2048, 64, 16, 16), (4, 38, 288, 64, 2, 2),
    (2, 38, 192, 64, 3, 3), (4, 11, 288, 64, 6, 4), (1, 1, 320, 96, 14, 5),
    (4, 11, 400, 64, 6, 6), (1, 2, 512, 128, 16, 8), (2, 11, 1024, 64, 12, 12),
    (1, 2, 1000, 256, 16, 15), (1, 4, 2100, 128, 16, 16), (4, 11, 88, 64, 4, 1),
    (4, 38, 88, 64, 1, 1)])
def test_plan_split_values(batch, heads, length, head_dim, bf16_split, int8_split):
    """The splits the smoke checks on the card (MHA_SPLIT_SHAPES): a float
    cache at few pairs splits from MHA_SHORT_SPLIT_SLOTS slots a block, an
    int8 cache from MHA_SPLIT_SLOTS."""
    for cache, rows, split in (("bfloat16", "bfloat16", bf16_split),
                               ("float32", "float32", bf16_split),
                               ("int8", "bfloat16", int8_split), ("int8", "float32", int8_split)):
        assert mha_plan(batch, heads, length, head_dim, cache, rows, SMS).split == split


@pytest.mark.parametrize("length", [1, 2, 3, 7, 88, 197, 2048, 2049])
@pytest.mark.parametrize("split", [1, 2, 3, 5, 8, 12, 16])
def test_splits_cover_the_cache_once(length, split):
    """Every block holds at least one slot, and the blocks' ranges cover
    [0, L) once, in rank order."""
    if split > length:
        return
    ranges = mha_splits(length, split)
    assert len(ranges) == split
    assert ranges[0][0] == 0 and ranges[-1][1] == length
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(b > a for a, b in ranges)


@pytest.mark.parametrize("head_dim", _HEAD_DIMS)
@pytest.mark.parametrize("cache,rows", FORMS)
def test_smem_within_limit_and_independent_of_length(head_dim, cache, rows):
    """Every plan's shared memory fits a block, within its budget wherever
    a warp's ring has more than two stages, grows with the cache only up to
    MHA_STAGES stages (the same at 100,000 and 1,000,000 slots), and is the
    same at 2048 and 100,000 slots where the rows fill the card."""
    for batch in (1, 4, 64):
        for heads in (2, 11):
            plans = [mha_plan(batch, heads, length, head_dim, cache, rows, SMS)
                     for length in (1, 88, 2048, 100_000)]
            budget = MHA_FULL_SMEM if batch * heads >= 2 * SMS else MHA_SMEM
            for p in plans:
                assert 1 <= p.stages <= MHA_STAGES and p.smem <= SMEM_LIMIT
                assert p.stages <= 2 or p.smem <= budget
            assert plans[3] == mha_plan(batch, heads, 1_000_000, head_dim, cache, rows, SMS)
    assert (mha_plan(64, 11, 2048, head_dim, cache, rows, SMS)
            == mha_plan(64, 11, 100_000, head_dim, cache, rows, SMS))
    cache_bytes = {"int8": 1, "bfloat16": 2, "float32": 4}[cache]
    assert 1 <= mha_tile(head_dim, cache_bytes) <= 64


@pytest.mark.parametrize("length,split,most,stages", [
    (1, 1, 4, 1), (32, 1, 4, 1), (33, 1, 4, 2), (96, 1, 4, 3), (296, 1, 4, 4), (296, 1, 2, 2),
    (2048, 16, 4, 4), (100_000, 16, 4, 4), (96, 1, 2, 2)])
def test_stages_follow_the_longest_warp(length, split, most, stages):
    """A warp's ring holds the longest warp's tiles (a quarter of its
    block's slots; bf16, Dh 64: 8 slots a tile), at most ``most``."""
    assert mha_tile(64, 2) == 8
    assert mha_stages(length, split, 8, most) == stages


@pytest.mark.parametrize("batch,heads,length,stages", [
    (64, 11, 96, 3), (64, 38, 296, 3), (1, 11, 2048, 4), (4, 38, 288, 5), (4, 11, 88, 1)])
def test_rows_that_fill_the_card_take_small_rings(batch, heads, length, stages):
    """Rows that fill the card without a split keep a block within
    MHA_FULL_SMEM (bf16, Dh 64: three stages); split or short caches take
    up to the warp's tiles within MHA_SMEM."""
    plan = mha_plan(batch, heads, length, 64, "bfloat16", "bfloat16", SMS)
    assert plan.stages == stages
    assert plan.smem <= (MHA_FULL_SMEM if batch * heads >= 2 * SMS else MHA_SMEM)


def test_plan_refuses_a_float_cache_of_another_dtype():
    with pytest.raises(ValueError):
        mha_plan(1, 2, 64, 64, "float32", "bfloat16", SMS)


# ---- the kernel's order of sums against the JAX kernel ---------------------------

def _resident(length, split, tile, stages, start, end):
    """Whether a warp's ring holds all its tiles (one max over its slots)
    or streams them (an online softmax over its tiles)."""
    return -(-(end - start) // tile) <= stages


def _emulate(q, k, v, k_new, v_new, bias, head_dim, split, ks=None, vs=None):
    """The kernel's arithmetic in its order: each warp of each of ``split``
    blocks takes its slots (``mha_parts``) tile by tile (``mha_tile``): where
    its ring (``mha_plan``'s stages) holds them all, one max over them; else
    a running max, sum and context rescaled by exp(m_old - m_new) a tile;
    the warps' parts are added in rank then warp order with weights
    exp(m_p - m), then the self-term (a part without slots adds exactly 0).
    An int8 cache's V scales fold into the context's probabilities, not the
    sum. Returns (B, D) in q's dtype."""
    b, d = q.shape
    length = k.shape[1]
    heads = d // head_dim
    qs = (q.float() * head_dim ** -0.5).to(q.dtype).float().reshape(b, heads, head_dim)
    s_self = (qs * k_new.float().reshape(b, heads, head_dim)).sum(dim=-1)
    kh = k.float().reshape(b, length, heads, head_dim)
    vh = v.float().reshape(b, length, heads, head_dim)
    if ks is None:
        s = torch.einsum("bhd,blhd->bhl", qs, kh)
    else:
        qscale = torch.clamp(qs.abs().amax(dim=-1), min=1e-8) * (1.0 / 127.0)
        q_i = torch.clamp(torch.round(qs / qscale[..., None]), -127, 127)
        s = torch.einsum("bhd,blhd->bhl", q_i, kh) * (ks * qscale[..., None])
    s = s + bias[:, None, :].float()
    plan = mha_plan(b, heads, length, head_dim, k.dtype, q.dtype, SMS, split)
    tile = plan.tile
    parts = []
    for start, end in mha_parts(length, split):
        m_run = torch.full((b, heads), -torch.inf)
        l_run = torch.zeros(b, heads)
        ctx = torch.zeros(b, heads, head_dim)
        step = end - start if _resident(length, split, tile, plan.stages, start, end) else tile
        for t0 in range(start, end, max(step, 1)):
            t1 = min(end, t0 + step)
            m_new = torch.maximum(m_run, s[..., t0:t1].amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s[..., t0:t1] - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            pv = p if vs is None else p * vs[..., t0:t1]
            ctx = ctx * alpha[..., None] + torch.einsum("bhl,blhd->bhd", pv, vh[:, t0:t1])
            m_run = m_new
        parts.append((m_run, l_run, ctx))
    m = s_self
    for m_r, _, _ in parts:
        m = torch.maximum(m, m_r)
    denom = torch.zeros(b, heads)
    out = torch.zeros(b, heads, head_dim)
    for m_r, l_r, c_r in parts:
        w = torch.exp(m_r - m)
        denom = denom + w * l_r
        out = out + w[..., None] * c_r
    p_self = torch.exp(s_self - m)
    out = out + p_self[..., None] * v_new.float().reshape(b, heads, head_dim)
    return (out * (1.0 / (denom + p_self))[..., None]).reshape(b, d).to(q.dtype)


def test_cases_reach_both_softmax_paths():
    """The JAX comparisons below cover warps whose ring holds every tile
    and warps that stream theirs (f32, Dh 128: tiles of 2 slots)."""
    resident = {}
    for head_dim, heads, cache, rows in ((64, 2, "bfloat16", "bfloat16"),
                                         (128, 1, "float32", "float32")):
        plan = mha_plan(3, heads, 197, head_dim, cache, rows, SMS, 1)
        start, end = mha_parts(197, 1)[0]
        resident[head_dim] = _resident(197, 1, plan.tile, plan.stages, start, end)
    assert resident == {64: True, 128: False}


def _inputs(case, b, heads, head_dim, length, split, row_dtype, seed):
    """numpy inputs of one case: a ragged mask with its stale slot;
    ``masked split`` masks the slots of block 1 of ``split`` (block 0's
    first tile at one block); ``masked row`` masks every cached slot of
    row 0 (only the self-term is left)."""
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    t = lambda *s: rng.standard_normal(s).astype(np.float32)      # noqa: E731
    q, k_new, v_new = t(b, d), t(b, d), t(b, d)
    k, v = t(b, length, d), t(b, length, d)
    valid = rng.integers(0, 4, (b, length)) > 0
    valid[:, length - 1] = False                    # the stale slot
    if case == "masked split":
        if split > 1:
            lo, hi = mha_splits(length, split)[1]
        else:
            lo, hi = 0, mha_tile(head_dim, 4 if row_dtype == "float32" else 2)
        valid[:, lo:hi] = False
    elif case == "masked row":
        valid[0] = False
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    return q, k, v, k_new, v_new, bias


@functools.lru_cache(maxsize=None)
def _case(case, head_dim, heads, cache, rows, split):
    """(port inputs, the JAX kernel's output as f32 numpy) of one case."""
    b, length = 3, 197
    q, k, v, k_new, v_new, bias = _inputs(case, b, heads, head_dim, length, split, rows,
                                          seed=head_dim + heads + split)
    dt = getattr(torch, rows)
    cast = lambda a: torch.from_numpy(a).to(dt)                        # noqa: E731
    jcast = lambda a: jnp.asarray(a, jnp.dtype(rows))                  # noqa: E731
    port = [cast(q), None, None, cast(k_new), cast(v_new), torch.from_numpy(bias)]
    jin = [jcast(q), None, None, jcast(k_new), jcast(v_new), jnp.asarray(bias)]
    scales = None
    if cache == "int8":
        (kq, ks), (vq, vs) = (quantize_heads(torch.from_numpy(a), head_dim) for a in (k, v))
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
        port[1:3] = [kq, vq]
        jin[1:3] = [jnp.asarray(kq.numpy())[None], jnp.asarray(vq.numpy())[None]]
        scales = (ks, vs)
        kw = dict(ks_stack=jnp.asarray(ks.numpy())[None], vs_stack=jnp.asarray(vs.numpy())[None])
    else:
        port[1:3] = [cast(k), cast(v)]
        jin[1:3] = [jcast(k)[None], jcast(v)[None]]
        kw = {}
    ref = jax_mha_step.mha_decode_ctx(*jin, 0, head_dim=head_dim, **kw)
    return tuple(port), scales, np.asarray(ref, np.float32)


def _close(got, ref, tol):
    got = got.float().numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("split", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["ragged", "masked split", "masked row"])
@pytest.mark.parametrize("head_dim,heads", [(64, 2), (96, 2), (128, 1)])
@pytest.mark.parametrize("cache,rows", FORMS)
def test_split_order_matches_jax_kernel(split, case, head_dim, heads, cache, rows):
    """The kernel's split order against the JAX kernel over 197 slots (no
    split a multiple of the block count, several tiles a block at one and
    two blocks), at the plain version's tolerances."""
    port, scales, ref = _case(case, head_dim, heads, cache, rows, split)
    ks, vs = scales if scales is not None else (None, None)
    got = _emulate(*port, head_dim, split, ks, vs)
    assert got.dtype == port[0].dtype
    _close(got, ref, BF16_ULP if rows == "bfloat16" else 1e-5)
    if case == "masked row":
        # Row 0 sees only its own token: the context is v_new.
        _close(got[:1], port[4][:1].float().numpy(), BF16_ULP if rows == "bfloat16" else 1e-6)


@pytest.mark.parametrize("split", [1, 2, 3, 8])
@pytest.mark.parametrize("cache,rows", FORMS)
def test_split_order_matches_plain_version(split, cache, rows):
    """The split order and the port's plain version (the yardstick the card
    holds the kernel against) part by rounding only."""
    port, scales, _ = _case("ragged", 64, 2, cache, rows, split)
    ks, vs = scales if scales is not None else (None, None)
    got = _emulate(*port, 64, split, ks, vs)
    plain = mha_decode_ctx_reference(*port, 64, ks, vs)
    tol = BF16_ULP if rows == "bfloat16" else 1e-5
    _close(got, plain.float().numpy(), tol)


def test_masked_split_adds_exactly_zero():
    """A block whose slots are all masked adds exactly 0: splitting the
    masked slots off gives the same f32 output as dropping them."""
    port, _, _ = _case("masked split", 64, 2, "float32", "float32", 3)
    q, k, v, k_new, v_new, bias = port
    lo, hi = mha_splits(k.shape[1], 3)[1]
    assert bool((bias[:, lo:hi] == NEG).all())
    got = _emulate(q, k, v, k_new, v_new, bias, 64, 3)
    keep = torch.cat([torch.arange(lo), torch.arange(hi, k.shape[1])])
    # Block 1 dropped: blocks 0 and 2 as the kernel splits them.
    parts = _emulate(q, k[:, keep].contiguous(), v[:, keep].contiguous(), k_new, v_new,
                     bias[:, keep].contiguous(), 64, 2)
    np.testing.assert_allclose(got.numpy(), parts.numpy(), rtol=2e-6, atol=1e-7)
