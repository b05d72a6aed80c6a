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
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops import moe as torch_moe
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
    engine = InferenceEngine(cfg, model)
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
