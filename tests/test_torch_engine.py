"""The PyTorch engine vs the JAX engine, and the port's parameter tree.

Greedy generation must be token-exact with the JAX ``InferenceEngine`` on
the same float32 weights. The port decodes with the fused-kernel semantics,
so the JAX engine runs its fused decode path too (``APERTIS_SSM_STEP`` and
``APERTIS_FFN_FUSED`` forced, interpret mode on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.factory import calculate_model_dimensions
from apertis_llm_torch.models.params import count_params, init_params

torch.set_num_threads(2)

BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128, decode_max_length=64)


def _engines(seed=0):
    jcfg = JaxConfig(**BASE)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    config = ApertisConfig(**BASE)
    return (JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree)),
            InferenceEngine(config, from_jax_params(tree, config)))


def _ragged_batch():
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, prompt in enumerate(([1, 5, 9, 33, 70, 4, 18], [2, 8], [7, 3, 99, 41])):
        batch[row, :len(prompt)] = prompt
        mask[row, :len(prompt)] = 1
    return batch, mask


@pytest.mark.parametrize("penalty", [1.0, 1.7])
def test_greedy_generate_matches_jax_engine(penalty, monkeypatch):
    monkeypatch.setenv("APERTIS_SSM_STEP", "force")
    monkeypatch.setenv("APERTIS_FFN_FUSED", "force")
    jax_engine, engine = _engines()
    batch, mask = _ragged_batch()
    kw = dict(max_new_tokens=10, eos_token_id=(), repetition_penalty=penalty)
    ref = jax_engine.generate(batch, attention_mask=mask,
                              rng=jax.random.PRNGKey(0), **kw)
    got = engine.generate(batch, attention_mask=mask, **kw)
    assert got.shape == (3, 17)
    np.testing.assert_array_equal(got, ref)


def test_eos_stops_row_and_min_new_tokens_overrides():
    _, engine = _engines(seed=1)
    pad = engine.config.pad_token_id
    prompts = np.array([[1, 5, 9], [7, 3, 99]], dtype=np.int32)
    seqs = engine.generate(prompts, max_new_tokens=6, eos_token_id=())[:, 3:]
    eos = int(seqs[0, 0])
    assert eos not in seqs[1].tolist()
    # Row 0 stops at its first token and then emits pads; row 1 runs on.
    out = engine.generate(prompts, max_new_tokens=6, eos_token_id=(eos,))
    assert out.shape == (2, 9)
    assert out[0, 3] == eos and all(t == pad for t in out[0, 4:])
    assert out[1, 3:].tolist() == seqs[1].tolist()
    # Every row finished after one token: the loop stops early...
    one = engine.generate(prompts[:1], max_new_tokens=6, eos_token_id=(eos,))
    assert one.shape == (1, 4)
    # ...unless min_new_tokens keeps it running.
    out = engine.generate(prompts[:1], max_new_tokens=6, min_new_tokens=4,
                          eos_token_id=(eos,))
    assert out.shape == (1, 7) and all(t == pad for t in out[0, 4:])


def test_sampled_generate_is_reproducible_per_generator():
    _, engine = _engines(seed=2)
    prompt = np.array([[1, 5, 9, 33]], dtype=np.int32)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=20,
              top_p=0.95, eos_token_id=())
    a = engine.generate(prompt, generator=torch.Generator().manual_seed(7), **kw)
    b = engine.generate(prompt, generator=torch.Generator().manual_seed(7), **kw)
    assert a.tolist() == b.tolist() and a.shape == (1, 12)


def _shapes(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_shapes(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = tuple(value.shape)
    return out


@pytest.mark.parametrize("size", ["small", "1.5B"])
def test_init_params_builds_jax_names_and_shapes(size):
    """Same tree of names and shapes as the JAX init (the 1.5B tree is built
    on the meta device: shapes only)."""
    if size == "small":
        kw, device = dict(BASE, use_rmsnorm=True), "cpu"
    else:
        dims = calculate_model_dimensions("1.5B", 32000)
        kw = dict(vocab_size=32000, attention_type="selective_ssm", ssm_d_state=16,
                  hidden_size=dims["hidden_size"],
                  num_hidden_layers=dims["num_hidden_layers"],
                  num_attention_heads=dims["num_attention_heads"],
                  intermediate_size=dims["intermediate_size"])
        device = "meta"
    ref = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), JaxConfig(**kw)))
    tree = init_params(ApertisConfig(**kw), torch.Generator(), device=device)
    assert _shapes(tree) == _shapes(ref)
    if size == "1.5B":
        assert count_params(tree) == 1_130_162_104
    else:
        assert float(tree["embed"]["tok"][0].abs().max()) == 0.0   # pad row
        A_log = tree["layers"]["attn"]["A_log"]
        assert bool(((A_log >= np.log(0.5)) & (A_log <= np.log(0.99))).all())
