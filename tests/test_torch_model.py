"""PyTorch model vs the JAX model on one set of weights (CPU, float32).

The JAX parameter tree is perturbed with numpy noise (so biases and norm
affines are not at their zero/unit init), handed to the JAX functions as is
and to the port through ``from_jax_params``. The port's decode path has the
fused-kernel semantics, so it is compared with JAX's fused-forced decode
(``APERTIS_SSM_STEP=force``, ``APERTIS_FFN_FUSED=force``, interpret mode).

The int8 model has one int8 arithmetic at every row count: the JAX package's
under ``APERTIS_QUANT_MATMUL=dyn`` and ``APERTIS_LN_QUANT=force`` as well
(``QUANT_ENV``), which the int8 tests set on the JAX side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.quantize import quantize_tied_head as jax_quantize_tied_head
from apertis_llm_tpu.models.ssm_fuse import attach_fused_ssm_params
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.quantize import quantize_params
from tests.reference_oracle import load_reference

torch.set_num_threads(2)

BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=64)


def _pair(seed=0, **over):
    """(jax config, jax params, torch model) sharing perturbed weights."""
    kw = dict(BASE, **over)
    jcfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), from_jax_params(
        tree, ApertisConfig(**kw), device="cpu")


QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force",
             "APERTIS_SSM_STEP": "force", "APERTIS_FFN_FUSED": "force"}


def _int8_pair(monkeypatch, seed=0):
    """(jax config, int8 jax params with the int8 tied head, int8 torch
    model): each package quantizes the same perturbed f32 weights with
    ``min_size=0``, so all six projections are int8."""
    for key, value in QUANT_ENV.items():
        monkeypatch.setenv(key, value)
    jcfg = JaxConfig(**BASE)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    jparams = jax_quantize_tied_head(
        jax_quantize_params(jax.tree.map(jnp.asarray, tree), min_size=0))
    model = from_jax_params(
        quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
        ApertisConfig(**BASE), device="cpu")
    model.quantize_tied_head()
    model.set_modes("dyn", "fatk")
    assert model.quantized and model.lm_head is not None
    return jcfg, jparams, model


def _ragged(rng, lens, width, vocab):
    ids = rng.integers(4, vocab, (len(lens), width)).astype(np.int32)
    mask = (np.arange(width)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("masked", [False, True])
def test_forward_logits_match_jax(masked):
    jcfg, jparams, model = _pair()
    rng = np.random.default_rng(1)
    ids, mask = _ragged(rng, [13, 9], 13, jcfg.vocab_size)
    mask_arg = mask if masked else None
    ref = jax_model.forward(jparams, jcfg, jnp.asarray(ids),
                            attention_mask=None if mask_arg is None
                            else jnp.asarray(mask_arg)).logits
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long),
                    None if mask_arg is None else torch.as_tensor(mask_arg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _prefill_both(jcfg, jparams, model, ids, mask):
    lens = mask.sum(axis=1)
    jpre = jax_model.prefill(
        jparams, jcfg, jax_model.init_cache(jcfg, ids.shape[0], max_length=64),
        jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        logit_positions=jnp.asarray(lens - 1))
    tpre = model.prefill(model.init_cache(ids.shape[0]),
                         torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask),
                         logit_positions=torch.as_tensor(lens - 1))
    return jpre, tpre


def test_prefill_logits_and_cache_match_jax():
    jcfg, jparams, model = _pair(seed=2)
    ids, mask = _ragged(np.random.default_rng(3), [16, 9, 3], 16, jcfg.vocab_size)
    jpre, tpre = _prefill_both(jcfg, jparams, model, ids, mask)
    assert tpre.logits.shape == (3, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tpre.logits.numpy(), np.asarray(jpre.logits),
                               rtol=1e-5, atol=1e-5)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(tpre.cache[key].numpy(), np.asarray(jpre.cache[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_decode_steps_match_jax_fused_decode(monkeypatch):
    """Eight decode steps from a ragged prefill: logits and the {conv, ssm}
    cache track JAX's fused-kernel decode. Both round the FFN input through
    bf16 at the same point; the tolerance (2e-3 of the largest value, as in
    tests/test_ssm_step.py) covers a flipped bf16 rounding there."""
    jcfg, jparams, model = _pair(seed=4)
    ids, mask = _ragged(np.random.default_rng(5), [12, 5, 8], 12, jcfg.vocab_size)
    jpre, tpre = _prefill_both(jcfg, jparams, model, ids, mask)
    jfused = attach_fused_ssm_params(jparams, jcfg)
    monkeypatch.setenv("APERTIS_SSM_STEP", "force")
    monkeypatch.setenv("APERTIS_FFN_FUSED", "force")
    step = jax.jit(lambda p, c, tok: jax_model.decode_step(
        p, jcfg, c, tok, jnp.asarray(0, jnp.int32)))
    jcache, tcache = jpre.cache, tpre.cache
    tok = np.array(jnp.argmax(jpre.logits[:, 0], axis=-1), np.int32)
    for _ in range(8):
        jlogits, jcache = step(jfused, jcache, jnp.asarray(tok))
        tlogits, tcache = model.decode_step(tcache, torch.as_tensor(tok, dtype=torch.long))
        ref = np.asarray(jlogits)
        scale = np.abs(ref).max()
        assert np.abs(tlogits.numpy() - ref).max() < 2e-3 * scale
        for key in ("conv", "ssm"):
            r = np.asarray(jcache[key])
            assert np.abs(tcache[key].numpy() - r).max() < 2e-3 * np.abs(r).max(), key
        tok = ref.argmax(axis=-1).astype(np.int32)


def test_int8_forward_and_prefill_match_jax(monkeypatch):
    """int8 full-sequence logits, and ragged int8 prefill logits and cache,
    against JAX's ln_quantize + w8a8 path. Both sides quantize the same
    values with the same formulas; the f32 sums around the int8 products
    (norm statistics, conv, dt_proj, scan) are taken in other orders, so an
    activation on a rounding boundary can land on the next int8 level: the
    tolerance is 2e-3 of the largest value (rtol 1e-5 held for the float
    model)."""
    jcfg, jparams, model = _int8_pair(monkeypatch, seed=6)
    ids, mask = _ragged(np.random.default_rng(7), [16, 9, 3], 16, jcfg.vocab_size)
    ref = np.asarray(jax_model.forward(jparams, jcfg, jnp.asarray(ids)).logits)
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long)).numpy()
    assert np.abs(got - ref).max() < 2e-3 * np.abs(ref).max()
    jpre, tpre = _prefill_both(jcfg, jparams, model, ids, mask)
    ref = np.asarray(jpre.logits)
    assert np.abs(tpre.logits.numpy() - ref).max() < 2e-3 * np.abs(ref).max()
    for key in ("conv", "ssm"):
        r = np.asarray(jpre.cache[key])
        assert np.abs(tpre.cache[key].numpy() - r).max() < 2e-3 * np.abs(r).max(), key


def test_int8_decode_steps_match_jax_fused_decode(monkeypatch):
    """Eight int8 decode steps from a ragged int8 prefill against JAX's
    fused int8 decode (the mixer kernel's int8 layout feeding the int8 FFN
    kernel, the int8 head). A step quantizes four rows per layer (norm,
    x_act, g, FFN input) and the FFN hidden per tile; where an f32 sum is
    taken in another order, a value on a rounding boundary lands on the next
    int8 level, and one such flip moves these logits by up to 0.75 % of
    their largest value: the tolerance is 1e-2 of it. The TPU FFN kernel's
    tanh-form erf (|err| <= 3.7e-5) would add many more such flips; the JAX
    kernel is given the port's exact GELU."""
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)
    jcfg, jparams, model = _int8_pair(monkeypatch, seed=8)
    ids, mask = _ragged(np.random.default_rng(9), [12, 5, 8], 12, jcfg.vocab_size)
    jpre, tpre = _prefill_both(jcfg, jparams, model, ids, mask)
    jfused = attach_fused_ssm_params(jparams, jcfg)
    assert "inx_wq" in jfused["layers"]["attn"]["fused"]
    step = jax.jit(lambda p, c, tok: jax_model.decode_step(
        p, jcfg, c, tok, jnp.asarray(0, jnp.int32)))
    jcache, tcache = jpre.cache, tpre.cache
    tok = np.array(jnp.argmax(jpre.logits[:, 0], axis=-1), np.int32)
    for _ in range(8):
        jlogits, jcache = step(jfused, jcache, jnp.asarray(tok))
        tlogits, tcache = model.decode_step(tcache, torch.as_tensor(tok, dtype=torch.long))
        ref = np.asarray(jlogits)
        assert np.abs(tlogits.numpy() - ref).max() < 1e-2 * np.abs(ref).max()
        for key in ("conv", "ssm"):
            r = np.asarray(jcache[key])
            assert np.abs(tcache[key].numpy() - r).max() < 1e-2 * np.abs(r).max(), key
        tok = ref.argmax(axis=-1).astype(np.int32)


def test_forward_matches_pytorch_reference():
    """The SSM variant of tests/test_parity.py against the original PyTorch
    model, through the JAX package's state-dict converter."""
    core = load_reference()
    if core is None:
        pytest.skip("reference oracle unavailable")
    from apertis_llm_tpu.models.convert import from_torch_state_dict

    kw = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=64, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0,
              attention_type="selective_ssm", ssm_d_state=8)
    torch.manual_seed(0)
    ref_model = core.ApertisForCausalLM(core.ApertisConfig(**kw)).eval()
    sd = {k: v.detach().numpy() for k, v in ref_model.state_dict().items()}
    config = ApertisConfig.from_dict(kw)
    tree = jax.tree.map(np.asarray, from_torch_state_dict(sd, JaxConfig.from_dict(kw)))
    model = from_jax_params(tree, config, device="cpu")
    ids = np.random.default_rng(42).integers(4, 97, size=(2, 17)).astype(np.int64)
    with torch.no_grad():
        ref = ref_model(input_ids=torch.from_numpy(ids), use_cache=False)[1].numpy()
        got = model(torch.from_numpy(ids)).numpy()
    assert np.abs(ref - got).max() < 1e-3
