"""Fine-tuning from a base model in the port against the JAX package (CPU).

``resize_embeddings`` keeps what JAX's keeps: the overlapping rows bit for
bit, a new pad row at zero, the shapes and the tying (the new rows come from
the port's generator, so they are the one thing that cannot equal JAX's).
Two updates of ``train_from_config`` with ``task_type: finetune`` from a
JAX-saved base of the same vocabulary give JAX's losses within the training
tests' 1e-5; a run with another vocabulary resizes and trains. A bare
weights file of an MHA model with q/k/v/o biases fine-tunes without
attention dropout in the port, where JAX keeps its default 0.1: the port's
modules take their biases from the config, and the reference writes those
biases only at attention dropout 0; the test pins that difference.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models.convert import (
    infer_config_from_state_dict as jax_infer_config, load_torch_state_dict as jax_load_sd)
from apertis_llm_tpu.models.convert import save_torch_checkpoint as jax_save
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.training.pipeline import resize_embeddings as jax_resize
from apertis_llm_tpu.training.pipeline import train_from_config as jax_train_from_config
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.convert import infer_config_from_state_dict, read_pretrained
from apertis_llm_torch.training import train_from_config
from apertis_llm_torch.training.pipeline import resize_embeddings

torch.set_num_threads(2)

BASE = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128)
LOSS_RTOL = 1e-5      # tests/test_torch_training.py's loss tolerance


def _tree(kw, seed):
    cfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    return cfg, jax.tree.map(lambda x: np.asarray(x, np.float32)
                             + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                             jax_init_params(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("new_vocab", [40, 80])
@pytest.mark.parametrize("tied", [True, False])
def test_resize_embeddings_keeps_what_jax_keeps(new_vocab, tied):
    kw = dict(BASE, tie_word_embeddings=tied, pad_token_id=70)
    cfg, tree = _tree(kw, seed=1)
    assert ("lm_head" in tree) != tied
    config = ApertisConfig(**kw)
    ref = jax_resize(jax.tree.map(jnp.asarray, tree), cfg, new_vocab, jax.random.PRNGKey(3))
    got = resize_embeddings(jax.tree.map(torch.from_numpy, tree), config, new_vocab,
                            torch.Generator().manual_seed(3))
    n = min(64, new_vocab)
    new, jnew = got["embed"]["tok"].numpy(), np.asarray(ref["embed"]["tok"])
    assert new.shape == jnew.shape == (new_vocab, 64)
    np.testing.assert_array_equal(new[:n], tree["embed"]["tok"][:n])
    np.testing.assert_array_equal(new[:n], jnew[:n])
    if new_vocab > 70:                         # the pad row is new: zero on both sides
        assert not new[70].any() and not jnew[70].any()
    if new_vocab > 64:
        assert 0.01 < new[n:70].std() < 0.04      # initializer_range 0.02
    assert ("lm_head" in got) == ("lm_head" in ref) == (not tied)
    if not tied:
        head, jhead = got["lm_head"]["w"].numpy(), np.asarray(ref["lm_head"]["w"])
        assert head.shape == jhead.shape == (64, new_vocab)
        np.testing.assert_array_equal(head[:, :n], jhead[:, :n])
    same = resize_embeddings(jax.tree.map(torch.from_numpy, tree), config, 64)
    assert same["embed"]["tok"] is not None and same["embed"]["tok"].shape == (64, 64)


def _vocab(path, size):
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3,
             **{f"w{i}": i for i in range(4, size)}}
    path.write_text(json.dumps(vocab))
    return path


def _config(tmp_path, base, vocab, name, epochs, **train):
    rng = np.random.default_rng(9)
    rows = [{"instruction": " ".join(f"w{i}" for i in rng.integers(4, 40, 7)),
             "output": " ".join(f"w{i}" for i in rng.integers(4, 40, 9))} for _ in range(8)]
    data = tmp_path / "sft.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({
        "data_config": {"train_data_path": str(data), "tokenizer_path": str(vocab),
                        "max_length": 24},
        "model_config": {},
        "training_config": dict({"task_type": "finetune",
                                 "pretrained_model_path_for_finetune": str(base),
                                 "output_dir": str(tmp_path / name), "batch_size": 8,
                                 "gradient_accumulation_steps": 1, "num_epochs": epochs,
                                 "learning_rate": 1e-3, "bf16": False}, **train)}))
    return path


def test_two_finetuning_updates_follow_jax(tmp_path):
    """Two f32 updates (one an epoch of 8 rows) from a base the JAX package
    saved, with a tokenizer of the base's vocabulary size: each epoch's loss
    equals JAX's within 1e-5 (JAX spreads the batch over the CPU's 8 devices,
    the port runs it on one)."""
    cfg, tree = _tree(BASE, seed=4)
    jax_save(tree, cfg, tmp_path / "base", filename="model.pt")
    vocab = _vocab(tmp_path / "vocab.json", 64)
    ref = jax_train_from_config(str(_config(tmp_path, tmp_path / "base", vocab, "jax", 2)))
    got = train_from_config(str(_config(tmp_path, tmp_path / "base", vocab, "port", 2,
                                        device="cpu")))
    assert got["final_step"] == ref["final_step"] == 2
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=LOSS_RTOL)


def test_finetuning_with_another_vocabulary_resizes_and_trains(tmp_path):
    cfg, tree = _tree(BASE, seed=5)
    jax_save(tree, cfg, tmp_path / "base", filename="model.pt")
    vocab = _vocab(tmp_path / "vocab.json", 48)
    got = train_from_config(str(_config(tmp_path, tmp_path / "base", vocab, "port", 2,
                                        device="cpu")))
    assert got["final_step"] == 2 and np.isfinite(got["train_loss"]).all()
    config, out = read_pretrained(tmp_path / "port" / "final")
    assert config.vocab_size == 48 and out["embed"]["tok"].shape == (48, 64)
    assert config.hidden_size == 64 and config.num_hidden_layers == 2


def test_bare_mha_file_finetunes_without_attention_dropout(tmp_path):
    """The kept difference: the port reads attention dropout 0 off a bare
    MHA weights file with q/k/v/o biases, JAX its default 0.1, and the
    fine-tuned model's config says so."""
    kw = dict(BASE, attention_type="standard_mha")       # attention dropout 0: biases
    cfg, tree = _tree(kw, seed=6)
    jax_save(tree, cfg, tmp_path / "base", filename="model.pt")
    bare = tmp_path / "bare" / "model.pt"
    bare.parent.mkdir()
    bare.write_bytes((tmp_path / "base" / "model.pt").read_bytes())
    sd = jax_load_sd(bare)
    assert "model.layers.0.attention.q_proj.bias" in sd
    assert jax_infer_config(sd).attention_probs_dropout_prob == pytest.approx(0.1)
    port_sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    assert infer_config_from_state_dict(port_sd).attention_probs_dropout_prob == 0.0
    vocab = _vocab(tmp_path / "vocab.json", 64)
    got = train_from_config(str(_config(tmp_path, bare, vocab, "port", 1, device="cpu")))
    assert got["final_step"] == 1
    config, _ = read_pretrained(tmp_path / "port" / "final")
    assert config.attention_type == "standard_mha" and config.attention_probs_dropout_prob == 0.0
