"""The port's w8a8 product (``ops/kernels/quant_matmul.py``) vs the JAX
package's ``quant_matmul_dyn``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
kernel runs under ``pltpu.force_tpu_interpret_mode()``, as
``tests/test_quant_matmul.py`` runs it; on CPU tensors the port's wrapper
takes its plain version, which must be bit-equal to it: the int32 sums are
exact and the epilogue ``acc * x_s * w_s`` rounds the same products in the
same order. The int8 model tests set ``APERTIS_QUANT_MATMUL=dyn`` and
``APERTIS_LN_QUANT=force`` on the JAX side, the port's one int8 arithmetic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from apertis_llm_tpu.models.quantize import quantize_weight as jax_quantize_weight
from apertis_llm_tpu.ops.pallas.quant_matmul import quant_matmul_dyn as jax_quant_matmul_dyn
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.params import init_params
from apertis_llm_torch.models.quantize import quantize_params, quantize_weight
from apertis_llm_torch.ops import moe as torch_moe
from apertis_llm_torch.ops.kernels import decode_plan
from apertis_llm_torch.ops.kernels import quant_matmul as qm
from apertis_llm_torch.ops.kernels.quant_matmul import (
    quant_matmul_dyn, quant_matmul_dyn_pre_q, quant_matmul_dyn_pre_q_reference)
from apertis_llm_torch.ops.quant import linear_dyn, quantize_rows

torch.set_num_threads(2)

BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128, decode_max_length=64)


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (0.05 * rng.normal(size=(k, n))).astype(np.float32)
    b = (0.1 * rng.normal(size=(n,))).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(37, 160, 44), (5, 96, 396), (64, 256, 300)])
def test_plain_version_is_bit_equal_to_jax_kernel(dtype, m, k, n):
    """quant_matmul_dyn on CPU tensors (the plain version) against the
    interpret-mode TPU kernel, at ragged M and at N not a multiple of 8 (the
    MoE mixer's N = 44 and 396), without and with a bias: every output bit
    equal, the bias added in the output type after the rounding, as
    ``_linear``'s ``y + b``."""
    x, w, b = _inputs(m * n, m, k, n)
    jdt = jnp.dtype(dtype)
    wq, ws = jax_quantize_weight(jnp.asarray(w))
    jx = jnp.asarray(x, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_quant_matmul_dyn(jx, wq, ws)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(np.array(jnp.asarray(jx, jnp.float32))).to(tdt)
    twq, tws = torch.from_numpy(np.array(wq)), torch.from_numpy(np.array(ws))
    for bias in (None, b):
        got = quant_matmul_dyn(tx, twq, tws, None if bias is None else
                               torch.from_numpy(bias).to(tdt))
        want = ref if bias is None else ref + jnp.asarray(bias, jdt)
        assert got.dtype == tdt and got.shape == (m, n)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jnp.asarray(want, jnp.float32)))
    assert quant_matmul_dyn_pre_q.launches == 0


def test_pre_q_form_leading_dims_and_devices():
    """The pre-quantized form takes leading dimensions and (N,) or (1, N)
    scales and matches the dynamic form and ``ops/quant.py::linear_dyn``;
    a tensor that is neither on the CPU nor on the card (meta) raises before
    any launch."""
    x, w, b = _inputs(3, 2 * 7, 64, 40)
    wq, ws = (torch.from_numpy(np.asarray(a)) for a in jax_quantize_weight(jnp.asarray(w)))
    xt = torch.from_numpy(x).reshape(2, 7, 64)
    x_q, x_s = quantize_rows(xt)
    got = quant_matmul_dyn_pre_q(x_q, x_s, wq, ws.reshape(-1), torch.from_numpy(b),
                                 torch.float32)
    assert got.shape == (2, 7, 40)
    assert torch.equal(got, quant_matmul_dyn(xt, wq, ws, torch.from_numpy(b)))
    assert torch.equal(got, linear_dyn(xt, wq, ws, torch.from_numpy(b)))
    assert torch.equal(got, quant_matmul_dyn_pre_q_reference(x_q, x_s, wq, ws,
                                                             torch.from_numpy(b), torch.float32))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quant_matmul_dyn_pre_q(torch.empty((4, 64), dtype=torch.int8, **meta),
                               torch.empty((4, 1), **meta),
                               torch.empty((64, 40), dtype=torch.int8, **meta),
                               torch.empty((1, 40), **meta), None, torch.bfloat16)
    assert quant_matmul_dyn_pre_q.launches == 0


def _counting(monkeypatch):
    """Count the w8a8 wrapper's calls (on CPU tensors it runs the plain
    version): the model's linears reach it through ``ops/quant.py`` and
    ``moe_ragged`` directly."""
    calls = []
    real = qm.quant_matmul_dyn_pre_q

    def counted(*args):
        calls.append(args[2].shape)
        return real(*args)

    monkeypatch.setattr(qm, "quant_matmul_dyn_pre_q", counted)
    monkeypatch.setattr(torch_moe, "quant_matmul_dyn_pre_q", counted)
    return calls


def _int8_model(seed=0, **over):
    """An int8 model (min_size=0: every projection int8) from the port's
    init with noise on every leaf."""
    cfg = ApertisConfig(**dict(BASE, **over))
    gen = torch.Generator().manual_seed(seed)
    tree = jax.tree.map(lambda a: a + 0.02 * torch.randn(a.shape, generator=gen),
                        init_params(cfg, torch.Generator().manual_seed(seed), device="cpu"))
    return cfg, from_jax_params(quantize_params(tree, min_size=0), cfg, device="cpu")


@pytest.mark.parametrize("family", ["ssm", "mha"])
def test_every_int8_linear_goes_through_the_w8a8_product(family, monkeypatch):
    """An int8 model's prefill and decode step call the w8a8 wrapper for
    every int8 linear, with the row-major (in, out) weight as the JAX tree
    holds it (no column-major copy is kept): the SSM mixer's four
    projections and the FFN pair at prefill, the int8 head at prefill and
    at each decode step (whose mixer and FFN are the fused step and FFN);
    MHA's q, k, v, o and the FFN pair at prefill, the fused QKV and o at
    each decode step."""
    over = dict(attention_type="standard_mha") if family == "mha" else {}
    cfg, model = _int8_model(1, **over)
    engine = InferenceEngine(cfg, model, quant_matmul="dyn")
    assert not hasattr(model.layers[0].ffn.w1, "_w_cols")
    calls = _counting(monkeypatch)
    ids = np.random.default_rng(2).integers(4, 131, (2, 5)).astype(np.int32)
    engine.generate(ids, max_new_tokens=3, eos_token_id=())
    nl = cfg.num_hidden_layers
    per_step = 2 if family == "mha" else 0
    assert len(calls) == nl * 6 + 1 + 2 * (nl * per_step + 1)
    if family == "mha":
        qkv = model.layers[0].attn.fused_qkv()[0]
        assert qkv.is_contiguous() and qkv.shape == (128, 384)
        assert calls.count((128, 384)) == 2 * nl


def test_moe_ragged_groups_go_through_the_w8a8_product(monkeypatch):
    """moe_ragged over int8 experts runs each non-empty expert group's two
    products through the wrapper: 2 per expert that some token chose."""
    cfg, model = _int8_model(3, use_expert_system=True, num_experts=4, experts_per_token=2)
    ffn = model.layers[0].ffn
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(30, 128)).astype(np.float32))
    routing = torch_moe.route(x, *ffn.router_weights(), 2, layer_norm_eps=cfg.layer_norm_eps)
    calls = _counting(monkeypatch)
    out = torch_moe.moe_ragged(x, routing, dict(ffn.experts.named_parameters()), cfg.hidden_act,
                               cfg.layer_norm_eps)
    assert out.shape == (30, 128) and torch.isfinite(out).all()
    assert len(calls) == 2 * len(set(routing.indices.reshape(-1).tolist()))


# ---- #8 on the card's design: its plan, quantization pass and ordered sums ----

H100_SMS = 132


@pytest.mark.parametrize("m,k,n,plan", [
    # 2048 prefill rows: 16 x 76 tiles of 128 rows, qm_kernel's block-scaled mode
    (2048, 2432, 9728, qm.FusedPlan(128, 1, 1, 0, True)),
    (16, 2432, 9728, qm.FusedPlan(16, 1, 1, 0, True)),
    # the int8 head: 250 column tiles, no split
    (64, 2432, 32000, qm.FusedPlan(64, 1, 1, 0, True)),
    (4, 2432, 32000, qm.FusedPlan(16, 1, 1, 0, True)),
    # w2 at decode rows: 19 column tiles, K's 19 blocks of 512 over four
    # blocks of a cluster, in rounds of 3 (64 rows) or 5 (16 rows) blocks
    (64, 9728, 2432, qm.FusedPlan(64, 4, 3, 5, True)),
    (17, 9728, 2432, qm.FusedPlan(64, 4, 3, 5, True)),
    (4, 9728, 2432, qm.FusedPlan(16, 4, 5, 8, True)),
    # x_param_proj (N = 1368) and N = 44: no TMA for the weight, no split
    (300, 608, 1368, qm.FusedPlan(128, 1, 1, 0, False)),
    (128, 608, 44, qm.FusedPlan(128, 1, 1, 0, False)),
    (17, 597, 44, qm.FusedPlan(64, 1, 1, 0, False)),
])
def test_fused_plan_at_the_smoke_shapes(m, k, n, plan):
    assert qm.fused_plan(m, n, k, H100_SMS) == plan


def test_fused_plan_rules_at_every_shape():
    """Row tiles whose int32 and f32 accumulators fit (16, 64, 128: never
    #7's 256); a split only where tile_plan would split #7, on at most
    as many blocks as K has 512-wide blocks, and only with a TMA weight;
    then GEMM2's largest group of blocks (up to its share) whose exchange
    slots leave MIN_STAGES stages, and as many stages as fit."""
    for m in (1, 4, 5, 16, 17, 37, 64, 65, 128, 129, 300, 2048):
        for n in (44, 64, 1368, 2432, 9728, 32000):
            for k in (96, 597, 608, 2432, 4001, 9728):
                plan = qm.fused_plan(m, n, k, H100_SMS)
                assert plan.rows == next((r for r in qm.FUSED_ROW_TILES if m <= r), 128)
                blocks = -(-k // qm.QUANT_BLOCK_K)
                tiles = -(-m // plan.rows) * -(-n // qm.TILE_COLS)
                tma_w = n % 16 == 0
                assert plan.tma_w == tma_w
                seven = qm.tile_plan(m, n, k, 1, H100_SMS)
                want = min(seven.split, blocks) if tma_w and plan.rows <= qm.SPLIT_ROWS else 1
                assert plan.split == max(1, want)
                if plan.split == 1:
                    assert (plan.group, plan.stages) == (1, 0)
                    continue
                assert plan.rows <= qm.SPLIT_ROWS and 2 * tiles <= H100_SMS
                stage = plan.rows * 128 + decode_plan.W8_BYTES

                def smem(group, stages):
                    extra = decode_plan.down_extra(plan.rows, plan.split, group, 0)
                    return decode_plan.smem_bytes(plan.rows, stages, stage, 1, extra)
                top = min(decode_plan.MAX_GROUP, -(-blocks // plan.split))
                assert 1 <= plan.group <= top
                assert plan.group == top or smem(plan.group + 1, decode_plan.MIN_STAGES) > \
                    decode_plan.SMEM_LIMIT
                assert 1 <= plan.stages <= decode_plan.MAX_STAGES
                assert smem(plan.group, plan.stages) <= decode_plan.SMEM_LIMIT


@pytest.mark.parametrize("m,k", [(5, 96), (37, 597), (16, 608), (3, 1100), (8, 2432)])
def test_quantization_pass_layout_and_scales(m, k):
    """quantize_blocks, the plain version of #8's quantization pass: rows of
    stride Kp (K rounded up to whole 128-byte chunks) with zeros past K,
    one f32 scale per row and 512-wide block, and the levels and scales
    that the plain version of #8 computes block by block."""
    x = torch.from_numpy(np.random.default_rng(m * k).normal(size=(m, k)).astype(np.float32))
    x[0, :] = 0.0                                   # an all-zero row: s = 1e-8 / 127
    x_q, s = qm.quantize_blocks(x.to(torch.bfloat16))
    kp = -(-k // 128) * 128
    assert x_q.shape == (m, kp) and x_q.dtype == torch.int8
    assert s.shape == (m, -(-k // 512)) and s.dtype == torch.float32
    assert not x_q[:, k:].any()
    xf = x.to(torch.bfloat16).float()
    for j0 in range(0, k, 512):
        xb = xf[:, j0:j0 + 512]
        sj = torch.clamp(xb.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        assert torch.equal(s[:, j0 // 512:j0 // 512 + 1], sj)
        q = torch.clamp(torch.round(xb / sj), -127, 127).to(torch.int8)
        assert torch.equal(x_q[:, j0:j0 + xb.shape[1]], q)
    assert float(s[0, 0]) == np.float32(np.float32(1e-8) * np.float32(1.0 / 127.0))


def _fused_sums(x, w_q, split, group, order=lambda q: q, local_partials=False):
    """#8 on the card in numpy float32: the quantization pass
    (quantize_blocks), each 512-wide block's exact int32 sum over its
    chunks (the weight's rows past K are zeros, as TMA and the producer's
    loads give them), p_j = float32(acc_j) * s_j; at split 1 qm_kernel's
    fold acc_f = acc_f + p_j in j order; at a split ffn_down_kernel's
    rounds: block r holds in round rho the ``group`` blocks of unit rho *
    split + r, and the owner adds the round's p in rank order (``order``
    may permute it), then group order. ``local_partials``: each rank adds
    its own blocks first and the owner adds the ranks' partial sums (an
    order that the kernel does not take)."""
    x_q, s = qm.quantize_blocks(x)
    m, kp = x_q.shape
    k, n = w_q.shape
    w = np.zeros((kp, n), dtype=np.int64)
    w[:k] = w_q.numpy()
    xq, sn = x_q.numpy().astype(np.int64), s.numpy()
    blocks = sn.shape[1]
    p = [(xq[:, 512 * j:512 * j + 512] @ w[512 * j:512 * j + 512]).astype(np.float32)
         * sn[:, j:j + 1] for j in range(blocks)]
    total = np.zeros((m, n), dtype=np.float32)
    units = -(-blocks // group)
    for rho in range(-(-units // split)):
        held = {}
        for rank in range(split):
            for g in range(group):
                t = (rho * split + rank) * group + g
                if t < blocks:
                    held[(rank, g)] = p[t]
        for q in range(split):
            mine = [held[(order(q), g)] for g in range(group) if (order(q), g) in held]
            if local_partials and mine:
                part = mine[0]
                for v in mine[1:]:
                    part = part + v
                mine = [part]
            for v in mine:
                total = total + v
    return total


def _fused_out(total, w_s, b, dtype):
    y = torch.from_numpy(total * w_s.reshape(1, -1).numpy()).to(dtype)
    return y + b if b is not None else y


@pytest.mark.parametrize("split", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [608, 2432, 9728])
def test_fused_fold_and_ordered_exchange_are_the_reference_bit_for_bit(split, k):
    """qm_kernel's block-scaled fold and ffn_down_kernel's tile-ordered
    exchange over a cluster of 1 to 4 blocks, in rounds of the groups the
    plan would take, give quant_matmul_dyn_fused_reference's bits in bf16
    and f32."""
    rng = np.random.default_rng(split * 10 + k)
    m, n = 37, 64
    w = (0.05 * rng.normal(size=(k, n))).astype(np.float32)
    w_q, w_s = quantize_weight(torch.from_numpy(w))
    blocks = -(-k // 512)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dtype)
        b = torch.from_numpy((0.1 * rng.normal(size=(n,))).astype(np.float32)).to(dtype)
        for group in sorted({1, min(3, -(-blocks // split)), -(-blocks // split)}):
            out = _fused_out(_fused_sums(x, w_q, split, group), w_s, b, dtype)
            assert torch.equal(out, qm.quant_matmul_dyn_fused_reference(x, w_q, w_s, b))


def test_another_order_of_the_fused_adds_moves_the_sums():
    """The order can be seen: the owner adding a round's terms in reverse
    rank order, or each rank adding its own blocks first, moves some of the
    f32 sums, where the kernels' order gives the sequential sums."""
    rng = np.random.default_rng(11)
    m, k, n = 64, 9728, 64
    w = (0.05 * rng.normal(size=(k, n))).astype(np.float32)
    w_q, _ = quantize_weight(torch.from_numpy(w))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    sequential = _fused_sums(x, w_q, 1, 1)
    assert np.array_equal(_fused_sums(x, w_q, 4, 3), sequential)
    assert not np.array_equal(_fused_sums(x, w_q, 4, 3, order=lambda q: 3 - q), sequential)
    assert not np.array_equal(_fused_sums(x, w_q, 4, 3, local_partials=True), sequential)
