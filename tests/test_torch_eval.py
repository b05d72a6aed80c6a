"""The port's evaluation harness against the JAX package's, on the CPU.

On one f32 tree both harnesses score the same padded batches through each
model's masked forward: the per-token NLL agrees within 1e-5 of its value,
the perplexity (rows longer than the window included, scored by the sliding
window) within 1e-5 relative, and the multiple-choice accuracies exactly.
``run_eval`` reads a checkpoint and a JSONL file as JAX's does; with
``quantize="int8"`` the port scores under its ``auto`` int8 arithmetic,
which on the CPU is not JAX's default there, so that case is held to 2 %.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.evaluation import harness as jax_harness
from apertis_llm_tpu.models.convert import save_torch_checkpoint as jax_save
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.evaluation import harness
from apertis_llm_torch.evaluation import (compute_perplexity, evaluate_multiple_choice,
                                          run_eval)
from apertis_llm_torch.models.convert import from_jax_params

torch.set_num_threads(2)

SSM = dict(vocab_size=97, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
           max_position_embeddings=512)
KINDS = {"ssm": SSM, "mha": dict(SSM, attention_type="standard_mha")}


def _pair(kw, seed=0):
    cfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), cfg))
    config = ApertisConfig(**kw)
    return (cfg, jax.tree.map(jnp.asarray, tree), config,
            from_jax_params(jax.tree.map(torch.from_numpy, tree), config, device="cpu"), tree)


def _rows(rng, lens, vocab):
    return [rng.integers(4, vocab, n).tolist() for n in lens]


@pytest.mark.parametrize("kind", ["ssm", "mha"])
def test_token_nll_and_perplexity_match_jax(kind):
    cfg, jparams, config, model, _ = _pair(KINDS[kind], seed=1)
    rng = np.random.default_rng(2)
    rows = _rows(rng, (5, 63, 17, 2, 150, 40), config.vocab_size)
    ids, mask = harness._pad_batch(rows[:4], config.pad_token_id)
    nll, valid = harness._token_nll(model, ids, mask)
    jnll, jvalid = jax_harness._token_nll_fn(cfg)(jparams, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    np.testing.assert_allclose(nll * valid, np.asarray(jnll) * valid, rtol=1e-5, atol=1e-6)
    for window, overlap in ((2048, 256), (64, 16)):
        got = compute_perplexity(model, config, rows, batch_size=4, window=window,
                                 overlap=overlap)
        ref = jax_harness.compute_perplexity(jparams, cfg, rows, batch_size=4, window=window,
                                             overlap=overlap)
        assert got["tokens"] == ref["tokens"]
        np.testing.assert_allclose(got["perplexity"], ref["perplexity"], rtol=1e-5)
        np.testing.assert_allclose(got["nll_per_token"], ref["nll_per_token"], rtol=1e-5)
    with pytest.raises(ValueError, match="overlap"):
        compute_perplexity(model, config, rows, window=64, overlap=64)


def test_multiple_choice_matches_jax():
    cfg, jparams, config, model, tree = _pair(SSM, seed=3)
    words = {f"w{i}": i for i in range(4, 97)}

    def encode(text):
        return [words.get(w, 3) for w in text.split()]

    rng = np.random.default_rng(4)
    items = [{"question": " ".join(f"w{i}" for i in rng.integers(4, 97, 9)),
              "choices": [" ".join(f"w{i}" for i in rng.integers(4, 97, 2 + j))
                          for j in range(4)], "answer": k % 4} for k in range(6)]
    ref = jax_harness.evaluate_multiple_choice(jparams, cfg, items, encode)
    got = evaluate_multiple_choice(model, config, items, encode)
    assert got == ref and got["items"] == 6
    # A tree scores as its model does.
    assert evaluate_multiple_choice(jax.tree.map(torch.from_numpy, tree), config, items,
                                    encode) == got


def _checkpoint(tmp_path, kw, seed):
    cfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), cfg))
    jax_save(tree, cfg, tmp_path, filename="model.pt")
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3,
             **{f"w{i}": i for i in range(4, kw["vocab_size"])}}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    return tmp_path


def test_run_eval_matches_jax(tmp_path):
    # Every projection of this width holds 65,536 weights or more, so the
    # default quantize_params makes the whole tree int8.
    kw = dict(SSM, vocab_size=64, hidden_size=512, num_attention_heads=16, intermediate_size=1024)
    (tmp_path / "m").mkdir()
    path = _checkpoint(tmp_path / "m", kw, seed=5)
    rng = np.random.default_rng(6)
    ppl, mc = tmp_path / "ppl.jsonl", tmp_path / "mc.jsonl"
    ppl.write_text("".join(json.dumps({"text": " ".join(f"w{i}" for i in rng.integers(4, 64, n))})
                           + "\n" for n in (3, 30, 70, 12, 1)))
    mc.write_text("".join(json.dumps({"question": "w5 w9 w11", "choices": ["w4", "w7 w8", "w60",
                                                                          "w33 w12"],
                                      "answer": a}) + "\n" for a in (0, 3)))
    common = dict(tokenizer_path=str(path / "vocab.json"), batch_size=2)
    got = run_eval(str(path), str(ppl), device="cpu", window=32, overlap=8, **common)
    ref = jax_harness.run_eval(str(path), str(ppl), window=32, overlap=8, **common)
    assert got["tokens"] == ref["tokens"]
    np.testing.assert_allclose(got["perplexity"], ref["perplexity"], rtol=1e-5)
    got = run_eval(str(path), str(mc), task="multiple_choice", device="cpu", **common)
    assert got == jax_harness.run_eval(str(path), str(mc), task="multiple_choice", **common)
    got = run_eval(str(path), str(ppl), quantize="int8", device="cpu", max_items=4, **common)
    ref = jax_harness.run_eval(str(path), str(ppl), quantize="int8", max_items=4, **common)
    assert got["tokens"] == ref["tokens"]
    np.testing.assert_allclose(got["perplexity"], ref["perplexity"], rtol=2e-2)
    with pytest.raises(ValueError, match="Unknown eval task"):
        run_eval(str(path), str(ppl), task="bleu", device="cpu", **common)
