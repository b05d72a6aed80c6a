"""PyTorch ops vs the JAX ops on the same numpy inputs (CPU, float32, 1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.ops import activations as jax_act
from apertis_llm_tpu.ops import norms as jax_norms
from apertis_llm_tpu.ops import sampling as jax_sampling
from apertis_llm_tpu.ops import ssm as jax_ssm
from apertis_llm_torch.ops import activations as torch_act
from apertis_llm_torch.ops import norms as torch_norms
from apertis_llm_torch.ops import sampling as torch_sampling
from apertis_llm_torch.ops import ssm as torch_ssm

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)


def _close(got: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _rows(seed=0, shape=(6, 48)):
    x = np.random.default_rng(seed).normal(0, 1.5, shape).astype(np.float32)
    x[1] = 0.0      # all-zero row (the zero pad embedding)
    x[2] = 0.75     # constant row
    return x


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_jax(kind):
    x = _rows()
    rng = np.random.default_rng(1)
    w = rng.normal(1.0, 0.1, x.shape[-1]).astype(np.float32)
    b = rng.normal(0.0, 0.1, x.shape[-1]).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    if kind == "rms":
        got = torch_norms.rms_norm(tx, tw, eps=1e-6)
        ref = jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6)
        assert torch.all(got[1] == 0)          # zero inverse on all-zero rows
    else:
        got = torch_norms.layer_norm(tx, tw, tb, eps=1e-12)
        ref = jax_norms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-12)
        assert torch.equal(got[2], tb)         # constant row -> bias exactly
    _close(got, ref)
    assert torch.all(torch.isfinite(got))


@pytest.mark.parametrize("name", ["gelu", "silu", "relu", "unknown"])
def test_activations_match_jax(name):
    x = np.random.default_rng(2).normal(0, 3.0, (64,)).astype(np.float32)
    _close(torch_act.get_activation(name)(torch.from_numpy(x)),
           jax_act.get_activation(name)(jnp.asarray(x)))


def test_causal_conv_and_step_match_jax():
    rng = np.random.default_rng(3)
    b, l, c, k = 2, 9, 12, 4
    x = rng.normal(size=(b, l, c)).astype(np.float32)
    w = rng.normal(size=(c, k)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, bias))
    _close(torch_ssm.depthwise_causal_conv(tx, tw, tb),
           jax_ssm.depthwise_causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)))

    state = rng.normal(size=(b, k - 1, c)).astype(np.float32)
    x_t = rng.normal(size=(b, c)).astype(np.float32)
    y, new_state = torch_ssm.depthwise_conv_step(
        torch.from_numpy(state), torch.from_numpy(x_t), tw, tb)
    y_ref, state_ref = jax_ssm.depthwise_conv_step(
        jnp.asarray(state), jnp.asarray(x_t), jnp.asarray(w), jnp.asarray(bias))
    _close(y, y_ref)
    _close(new_state, state_ref)
    # The step over the carried window equals the last output of the full conv.
    seq = np.concatenate([state, x_t[:, None, :]], axis=1)
    full = torch_ssm.depthwise_causal_conv(torch.from_numpy(seq), tw, tb)
    np.testing.assert_allclose(y.numpy(), full[:, -1].numpy(), **TOL)


def _logits_and_history(seed=4, b=3, v=50, l=12):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, v)).astype(np.float32)
    hist = rng.integers(0, v, (b, l)).astype(np.int32)
    hist[:, :4] = logits.argmax(axis=-1)[:, None]   # penalise the current argmax
    mask = (rng.uniform(size=(b, l)) < 0.7).astype(np.float32)
    return logits, hist, mask


def test_greedy_sampling_matches_jax():
    logits, _, _ = _logits_and_history()
    got = torch_sampling.sample_token(torch.from_numpy(logits))
    ref = jax_sampling.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_repetition_penalty_matches_jax():
    logits, hist, mask = _logits_and_history()
    _close(torch_sampling.apply_repetition_penalty(
               torch.from_numpy(logits), torch.from_numpy(hist), torch.from_numpy(mask), 1.7),
           jax_sampling.apply_repetition_penalty(
               jnp.asarray(logits), jnp.asarray(hist), jnp.asarray(mask), 1.7))
    kw = dict(repetition_penalty=1.7)
    got = torch_sampling.sample_token(torch.from_numpy(logits),
                                      token_history=torch.from_numpy(hist),
                                      history_mask=torch.from_numpy(mask), **kw)
    ref = jax_sampling.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits),
                                    token_history=jnp.asarray(hist),
                                    history_mask=jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not np.array_equal(got.numpy(), logits.argmax(axis=-1))


def test_top_k_top_p_filters_match_jax():
    logits, _, _ = _logits_and_history(seed=5)
    tl = torch.from_numpy(logits)
    _close(torch_sampling.apply_top_k(tl, 7), jax_sampling.apply_top_k(jnp.asarray(logits), 7))
    _close(torch_sampling.apply_top_p(tl, 0.8),
           jax_sampling.apply_top_p(jnp.asarray(logits), 0.8))
    g = torch.Generator().manual_seed(0)
    draws = torch_sampling.sample_token(tl, generator=g, do_sample=True, top_k=7)
    kept = torch_sampling.apply_top_k(tl, 7) > torch_sampling.NEG_INF
    assert bool(kept[torch.arange(3), draws].all())
