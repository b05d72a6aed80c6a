"""The port's ``quant_matmul="auto"`` and ``moe_mode="fat"`` against the JAX
package on the CPU.

``auto`` runs an int8 linear on rows not quantized already through the
weight-only kernel #6 (``ops/quant.py::resolve_mode``), and from
``AUTO_DYN_ROWS`` rows fuses a pre-norm whose consumers are all int8 with
their row quantization (#5, then the w8a8 product: ``fuses_pre_norm``), as
the JAX package's ``_maybe_ln_quant`` does under ``auto``. Off the TPU the
JAX package turns its own ``auto`` linears into ``weightonly``
(models/apertis.py:126-128) and fuses no pre-norm below 512 rows, so each
side of the port's threshold is held against JAX run explicitly: below it
against ``APERTIS_QUANT_MATMUL=weightonly`` (the same weight-only
arithmetic, the dequantized product where #6 sums the exact products in
f32), above it against ``auto`` with ``APERTIS_LN_QUANT=force`` (the fused
pre-norms feeding the w8a8 product, every other linear weight-only). The
tests put the port on each side by patching the threshold.

``fat`` computes the fat MoE stack's two products in plain torch
(``ops/moe.py::moe_dense_fat``), held against JAX's ``moe_dense_fat`` and a
MoE model against the JAX engine under ``APERTIS_MOE_FUSED=fat``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.moe_fuse import _fuse_one_fat as jax_fuse_one_fat
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.quantize import quantize_weight as jax_quantize_weight
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops import moe as jax_moe
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models import apertis as torch_model
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.moe_fuse import fuse_one_fat
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops import moe as torch_moe
from apertis_llm_torch.ops import quant as torch_quant

torch.set_num_threads(2)

BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128)
MOE = dict(BASE, use_expert_system=True, num_experts=4, experts_per_token=2,
           intermediate_size=128)
DECODE_ENV = {"APERTIS_SSM_STEP": "force", "APERTIS_FFN_FUSED": "force",
              "APERTIS_MOE_GROUPED": "force"}
# Each side's JAX mode: below the threshold weightonly, above it auto with
# the fused pre-norm quantization.
SIDES = {"below": {"APERTIS_QUANT_MATMUL": "weightonly"},
         "above": {"APERTIS_QUANT_MATMUL": "auto", "APERTIS_LN_QUANT": "force"}}


def _side(side, monkeypatch):
    """Put the port's rule on ``side`` of its threshold for every row count
    the tests reach (the threshold patched to one row, or past them) and JAX
    in that side's mode."""
    monkeypatch.setattr(torch_quant, "AUTO_DYN_ROWS", 1 if side == "above" else 1 << 20)
    for key, value in dict(DECODE_ENV, **SIDES[side]).items():
        monkeypatch.setenv(key, value)


def _tree(seed, kw):
    rng = np.random.default_rng(seed)
    jcfg = JaxConfig(**kw)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, ApertisConfig(**kw), tree


def _ragged_batch():
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, prompt in enumerate(([1, 5, 9, 33, 70, 4, 18], [2, 8], [7, 3, 99, 41])):
        batch[row, :len(prompt)] = prompt
        mask[row, :len(prompt)] = 1
    return batch, mask


def test_auto_resolves_by_the_measured_rule(monkeypatch):
    """``auto`` runs #6 on rows not quantized already and every other mode
    itself; a pre-norm fuses under ``dyn`` always, under ``auto`` from the
    threshold on (never with None), under the other modes never."""
    assert torch_quant.resolve_mode("auto") == "pallas"
    for mode in ("dyn", "weightonly", "pallas", "fused"):
        assert torch_quant.resolve_mode(mode) == mode
    rows = (1, 63, 64, 4096, 1 << 20)
    for threshold, want in ((None, [False] * 5), (64, [False, False, True, True, True])):
        monkeypatch.setattr(torch_quant, "AUTO_DYN_ROWS", threshold)
        assert [torch_quant.fuses_pre_norm("auto", r) for r in rows] == want
        assert all(torch_quant.fuses_pre_norm("dyn", r) for r in rows)
        for mode in ("weightonly", "pallas", "fused"):
            assert not any(torch_quant.fuses_pre_norm(mode, r) for r in rows)


@pytest.mark.parametrize("side", ["below", "above"])
def test_auto_linear_matches_jax_explicit_mode(side, monkeypatch):
    """One int8 linear of 37 f32 rows not quantized already under ``auto``
    against JAX's ``_linear`` in the side's mode: #6 on either side of the
    threshold, as JAX's linear is weight-only off the TPU under
    ``weightonly`` and ``auto`` alike; 1e-5 of the largest output (the exact
    products summed in another order)."""
    _side(side, monkeypatch)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(37, 600)).astype(np.float32)
    w_q, w_s = jax_quantize_weight(jnp.asarray(0.05 * rng.normal(size=(600, 300)), jnp.float32))
    b = (0.1 * rng.normal(size=(300,))).astype(np.float32)
    ref = np.asarray(jax_model._linear({"w_q": w_q, "w_s": w_s, "b": jnp.asarray(b)},
                                       jnp.asarray(x)))
    got = torch_quant.linear_int8(torch.from_numpy(x), torch.from_numpy(np.array(w_q)),
                                  torch.from_numpy(np.array(w_s)), torch.from_numpy(b), "auto")
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("side", ["below", "above"])
def test_auto_int8_model_matches_jax_explicit_mode(side, monkeypatch):
    """A 2-layer int8 selective-SSM model served under the engine's default
    (``auto``) against the JAX engine in the side's mode: the prefill
    logits of the ragged prompts (bucketed to 32 positions) within 1e-2 of
    the largest (the int8 model tests' tolerance), greedy generation
    token-exact, and the fused pre-norm quantization (#5) run above the
    threshold only."""
    _side(side, monkeypatch)
    jcfg, cfg, tree = _tree(7, BASE)
    jengine = JaxEngine(jcfg, jax_quantize_params(jax.tree.map(jnp.asarray, tree), min_size=0))
    model = from_jax_params(quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
                            cfg, device="cpu")
    engine = InferenceEngine(cfg, model)
    assert engine.quant_matmul == "auto"
    calls = []
    real = torch_model.ln_quantize
    monkeypatch.setattr(torch_model, "ln_quantize", lambda *a: calls.append(1) or real(*a))
    batch, mask = _ragged_batch()
    ids, mask32 = np.pad(batch, ((0, 0), (0, 25))), np.pad(mask, ((0, 0), (0, 25)))
    lens = mask32.sum(axis=1)
    jpre = jax_model.prefill(jengine.params, jcfg, jax_model.init_cache(jcfg, 3),
                             jnp.asarray(ids), attention_mask=jnp.asarray(mask32),
                             logit_positions=jnp.asarray(lens - 1))
    tpre = model.prefill(model.init_cache(3), torch.as_tensor(ids, dtype=torch.long),
                         torch.as_tensor(mask32), logit_positions=torch.as_tensor(lens - 1))
    want = np.asarray(jpre.logits, np.float32)
    assert np.abs(tpre.logits.numpy() - want).max() <= 1e-2 * np.abs(want).max()
    assert len(calls) == (2 * cfg.num_hidden_layers if side == "above" else 0)
    kw = dict(max_new_tokens=8, eos_token_id=())
    ref = jengine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    np.testing.assert_array_equal(engine.generate(batch, attention_mask=mask, **kw), ref)


@pytest.mark.parametrize("bits", [8, 4])
def test_fat_products_match_jax_moe_dense_fat(bits):
    """``moe_dense_fat`` against JAX's on one routed token batch (37 rows, 4
    experts of 128 at width 128) over each package's fat stack of the same
    int8 experts, int8 and int4: 1e-3 of the largest output (the centring's
    mean and variance are f32 sums taken in another order, which can move an
    int8 level of x)."""
    rng = np.random.default_rng(11)
    e, h, inter = 4, 128, 128
    experts = {"ln_w": 1 + 0.1 * rng.normal(size=(e, h)), "ln_b": 0.1 * rng.normal(size=(e, h)),
               "b1": 0.02 * rng.normal(size=(e, inter)), "b2": 0.02 * rng.normal(size=(e, h))}
    experts = {k: jnp.asarray(v, jnp.float32) for k, v in experts.items()}
    for name, shape in (("w1", (e, h, inter)), ("w2", (e, inter, h))):
        experts[name + "_q"], experts[name + "_s"] = jax_quantize_weight(
            jnp.asarray(0.05 * rng.normal(size=shape), jnp.float32))
    x = rng.normal(size=(37, h)).astype(np.float32)
    router = [rng.normal(size=s).astype(np.float32) for s in ((h,), (h,), (h, e), (e,))]
    routing = jax_moe.route(jnp.asarray(x), *map(jnp.asarray, router), 2, layer_norm_eps=1e-12)
    jfat = jax_fuse_one_fat(experts, bits=bits)
    assert ("w1t_q4" in jfat) == (bits == 4)
    ref = np.asarray(jax_moe.moe_dense_fat(jnp.asarray(x), routing, dict(experts, fat=jfat),
                                           "gelu", 1e-12))
    fat = fuse_one_fat({k: torch.from_numpy(np.array(v)) for k, v in experts.items()}, bits)
    got = torch_moe.moe_dense_fat(
        torch.from_numpy(x), torch_moe.RouterOutput(
            torch.from_numpy(np.array(routing.weights)),
            torch.from_numpy(np.array(routing.indices)).long(), None, None),
        fat, torch.from_numpy(np.array(experts["b2"])), "gelu", 1e-12)
    assert np.abs(got.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()


def test_fat_mode_model_matches_jax(monkeypatch):
    """A 2-layer int8 MoE model served with ``moe_mode="fat"`` (and
    ``dyn``) against the JAX engine under ``APERTIS_MOE_FUSED=fat``: the
    decode steps' MoE FFN through ``moe_dense_fat`` and never the fat
    kernel, the prefill logits within 1e-2 of the largest (the int8 model
    tests' tolerance), and greedy generation token-exact."""
    for key, value in dict(DECODE_ENV, APERTIS_MOE_FUSED="fat", APERTIS_QUANT_MATMUL="dyn",
                           APERTIS_LN_QUANT="force").items():
        monkeypatch.setenv(key, value)
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)
    jcfg, cfg, tree = _tree(10, MOE)
    jengine = JaxEngine(jcfg, jax_quantize_params(jax.tree.map(jnp.asarray, tree), min_size=0))
    assert "fat" in jengine.params["layers"]["ffn"]["experts"]
    model = from_jax_params(quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
                            cfg, device="cpu")
    engine = InferenceEngine(cfg, model, quant_matmul="dyn", moe_mode="fat")
    calls = {"moe_dense_fat": 0, "moe_dense_fat_kernel": 0}
    for name in calls:
        real = getattr(torch_moe, name)
        monkeypatch.setattr(torch_moe, name, lambda *a, _n=name, _f=real: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a))[1])
    batch, mask = _ragged_batch()
    ids, mask32 = np.pad(batch, ((0, 0), (0, 25))), np.pad(mask, ((0, 0), (0, 25)))
    lens = mask32.sum(axis=1)
    jpre = jax_model.prefill(jengine.params, jcfg, jax_model.init_cache(jcfg, 3),
                             jnp.asarray(ids), attention_mask=jnp.asarray(mask32),
                             logit_positions=jnp.asarray(lens - 1))
    tpre = model.prefill(model.init_cache(3), torch.as_tensor(ids, dtype=torch.long),
                         torch.as_tensor(mask32), logit_positions=torch.as_tensor(lens - 1))
    want = np.asarray(jpre.logits, np.float32)
    assert np.abs(tpre.logits.numpy() - want).max() <= 1e-2 * np.abs(want).max()
    kw = dict(max_new_tokens=8, eos_token_id=())
    ref = jengine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    calls.update(moe_dense_fat=0)
    np.testing.assert_array_equal(engine.generate(batch, attention_mask=mask, **kw), ref)
    # One prefill and seven decode steps, each once a layer.
    assert calls == {"moe_dense_fat": 8 * cfg.num_hidden_layers, "moe_dense_fat_kernel": 0}
