"""PyTorch model vs the JAX model on one set of weights (CPU, float32).

The JAX parameter tree is perturbed with numpy noise (so biases and norm
affines are not at their zero/unit init), handed to the JAX functions as is
and to the port through ``from_jax_params``. The port's decode path has the
fused-kernel semantics, so it is compared with JAX's fused-forced decode
(``APERTIS_SSM_STEP=force``, ``APERTIS_FFN_FUSED=force``, interpret mode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.ssm_fuse import attach_fused_ssm_params
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.convert import from_jax_params
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
    return jcfg, jax.tree.map(jnp.asarray, tree), from_jax_params(tree, ApertisConfig(**kw))


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
    model = from_jax_params(tree, config)
    ids = np.random.default_rng(42).integers(4, 97, size=(2, 17)).astype(np.int64)
    with torch.no_grad():
        ref = ref_model(input_ids=torch.from_numpy(ids), use_cache=False)[1].numpy()
        got = model(torch.from_numpy(ids)).numpy()
    assert np.abs(ref - got).max() < 1e-3
