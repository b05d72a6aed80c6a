"""The port's training path vs the JAX package's (CPU, tiny models).

One numpy f32 tree (perturbed off its 0/1 init) goes into both packages:
as it is into the JAX functions and through ``from_jax_params`` into the
port. The loss and every parameter's gradient of ``loss_fn`` are compared
leaf by leaf, the optimizer with its schedule and decay mask against optax,
three f32 updates with accumulation 2 against ``make_train_step`` +
``optax.MultiSteps``, the datasets and batch order against the JAX copies,
and the weight export against the JAX package's ``load_pretrained``. On the
CPU the JAX forward never takes its flash kernel (its gate wants a TPU), so
the MHA model (flash, L = 128) is held against JAX's plain attention, the
same function; the flash backward itself is held against the JAX kernel in
``tests/test_torch_backward.py``. On the CPU the port's kernels run their
plain versions.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models.convert import load_pretrained as jax_load_pretrained
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.training import datasets as jax_datasets
from apertis_llm_tpu.training import step as jax_step
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.convert import from_jax_params, params_tree
from apertis_llm_torch.models.params import check_trainable, init_params
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.training import datasets as port_datasets
from apertis_llm_torch.training import step as port_step
from apertis_llm_torch.training import train_from_config
from apertis_llm_torch.training.trainer import ApertisTrainer
from apertis_llm_torch.utils.checkpoint import latest_checkpoint
from apertis_llm_torch.utils.vocab import create_minimal_vocab_file

torch.set_num_threads(2)

BASE = dict(vocab_size=97, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128)
MHA = dict(attention_type="standard_mha", use_flash_attention=True)      # 4 heads of 32
# f32 on both sides. The sums run in other orders (XLA's associative scan
# and fused reductions against the port's step-by-step scan; the flash plain
# version's softmax from the LSE against XLA's): each gradient leaf agrees
# to 1e-4 of its largest element, the loss to a relative 1e-5.
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5


def _trees(seed=0, **over):
    """(JAX config, port config, perturbed numpy f32 tree)."""
    kw = dict(BASE, **over)
    jcfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, ApertisConfig(**kw), tree


def _batch(rng, b, l, vocab):
    ids = rng.integers(4, vocab, (b, l)).astype(np.int32)
    labels = ids.copy()
    labels[:, -5:] = -100          # some ignored positions
    return {"input_ids": ids, "labels": labels}


def _torch_batch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()}


def _jax_leaf(tree, name):
    """The leaf of a stacked JAX tree for a port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for key in parts[2:]:
            node = node[key]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return np.asarray(node)


def _jax_mask_leaf(mask, name):
    """A leaf of JAX's decay mask (one bool per stacked leaf)."""
    node = mask["layers"] if name.startswith("layers.") else mask
    for key in name.split(".")[2 if name.startswith("layers.") else 0:]:
        node = node[key]
    return bool(node)


def _assert_close(got, ref, tol, name):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: {err:.3e} vs max {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("arch", ["ssm", "mha"])
def test_loss_and_gradients_match_jax(arch):
    """The loss at step 0 and every parameter's gradient of a 2-layer model
    equal JAX's ``loss_fn`` / ``value_and_grad`` (f32, no dropout)."""
    jcfg, cfg, tree = _trees(seed=1, **(MHA if arch == "mha" else {}))
    batch = _batch(np.random.default_rng(2), 2, 128, cfg.vocab_size)
    (jloss, _), jgrads = jax.value_and_grad(jax_step.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        None, None)
    model = from_jax_params(tree, cfg, device="cpu")
    params = dict(model.named_parameters())
    loss, metrics = port_step.loss_fn(model, _torch_batch(batch), None)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert float(metrics["lb_loss"]) == 0.0 and float(metrics["rz_loss"]) == 0.0
    for name, g in zip(params, grads):
        _assert_close(g.numpy(), _jax_leaf(jgrads, name), GRAD_TOL, name)


@pytest.mark.parametrize("arch", ["ssm", "mha"])
def test_remat_gives_the_same_gradients_with_dropout(arch):
    """Per-layer rematerialisation recomputes each layer with the dropout
    masks of its first pass (drawn from the step seed and the layer index),
    so remat on and off give equal gradients; and the dropout is live: a
    second seed gives other gradients."""
    _, cfg, tree = _trees(seed=3, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                          **(MHA if arch == "mha" else {}))
    model = from_jax_params(tree, cfg, device="cpu")
    batch = _torch_batch(_batch(np.random.default_rng(4), 2, 128, cfg.vocab_size))
    params = dict(model.named_parameters())

    def grads(remat, seed):
        model.config = cfg.replace(remat=remat)
        loss, _ = port_step.loss_fn(model, batch, seed, torch.bfloat16)
        return [g.float() for g in torch.autograd.grad(loss, list(params.values()))]

    plain, remat, other = grads(False, 7), grads(True, 7), grads(True, 8)
    for name, a, b in zip(params, plain, remat):
        assert torch.equal(a, b), name
    assert any(not torch.equal(a, b) for a, b in zip(plain, other))


def test_decay_mask_matches_jax():
    """Leaf by leaf, the port's weight-decay mask is JAX's ``_decay_mask``,
    whose rank test sees the stacked layer axis (a layer's LayerNorm weight
    is decayed, the final one is not)."""
    for over in ({}, MHA, dict(use_rmsnorm=True)):
        _, cfg, tree = _trees(**over)
        jmask = jax_step._decay_mask(tree)
        mask = port_step.decay_mask(from_jax_params(tree, cfg, device="cpu"))
        assert mask == {name: _jax_mask_leaf(jmask, name) for name in mask}
    assert mask["layers.0.attn.conv.w"] and not mask["layers.0.attn.A_log"]


@pytest.mark.parametrize("total", [3, 50])
def test_schedule_matches_jax(total):
    """The one-cycle cosine schedule equals JAX's at every count, warm-up and
    decay and past the end. Both evaluate it in f32, but their cosines may
    differ by an ulp, which near the end of the decay (cos close to -1) is a
    large share of the small rate there: within 1e-6 relative, or 1e-6 of
    the peak rate."""
    _, jsched = jax_step.make_optimizer(3e-4, total)
    sched = port_step.make_schedule(3e-4, total)
    for count in range(total + 5):
        np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-6,
                                   atol=1e-6 * 3e-4)


def test_optimizer_matches_optax_on_the_same_gradients():
    """Fed the same micro-gradients, the port's optimizer (clip, Adam, masked
    decay, schedule, accumulation over 2) follows optax's chain in
    ``MultiSteps``: 8 micro-steps, 4 updates, one of them clipped. f32, the
    same formulas; 1e-6 of each leaf's largest value."""
    rng = np.random.default_rng(5)
    shapes = {"w": (4, 6), "b": (6,), "scale": (6,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    decay = {"w": True, "b": False, "scale": False}
    tx = optax.MultiSteps(optax.chain(
        optax.clip_by_global_norm(1.0), optax.scale_by_adam(),
        optax.add_decayed_weights(0.01, mask=decay),
        optax.scale_by_schedule(jax_step.make_optimizer(1e-2, 4)[1]), optax.scale(-1.0)),
        every_k_schedule=2)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.tensor(v) for k, v in init.items()}
    opt, _ = port_step.make_optimizer(params, decay, 1e-2, 4, gradient_accumulation_steps=2)
    for i in range(8):
        scale = 3.0 if i in (2, 3) else 0.1      # the second update is clipped
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        assert opt.update({k: torch.from_numpy(v) for k, v in grads.items()}) == (i % 2 == 1)
    assert opt.count == 4
    for k in shapes:
        _assert_close(params[k].numpy(), jparams[k], 1e-6, k)


def test_three_updates_follow_jax():
    """Three f32 updates with accumulation 2 (six micro-steps, clipping on)
    follow JAX's ``make_train_step`` + ``optax.MultiSteps``: the loss of each
    micro-step, and every parameter after them, whose change from its start
    agrees to 1e-2 of its largest value (Adam's update divides each
    gradient by its own magnitude, so the 1e-4 gradient agreement of the
    test above reaches the parameters unscaled, and more where a gradient
    element is near zero)."""
    jcfg, cfg, tree = _trees(seed=6)
    rng = np.random.default_rng(7)
    batches = [_batch(rng, 2, 32, cfg.vocab_size) for _ in range(6)]
    tx, _ = jax_step.make_optimizer(1e-3, 3, gradient_accumulation_steps=2)
    state = jax_step.create_train_state(jax.tree.map(jnp.asarray, tree), tx,
                                        jax.random.PRNGKey(0))
    jstep = jax.jit(jax_step.make_train_step(jcfg, tx))
    jlosses = []
    for batch in batches:
        state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jlosses.append(float(metrics["loss"]))

    model = from_jax_params(tree, cfg, device="cpu")
    opt, _ = port_step.make_optimizer(dict(model.named_parameters()),
                                      port_step.decay_mask(model), 1e-3, 3,
                                      gradient_accumulation_steps=2)
    losses = [float(port_step.train_step(model, opt, _torch_batch(b), i)["loss"])
              for i, b in enumerate(batches)]
    assert opt.count == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for name, p in model.named_parameters():
        start = _jax_leaf(tree, name)
        _assert_close(p.detach().numpy() - start, _jax_leaf(state.params, name) - start,
                      1e-2, name)


def _corpus(tmp_path, n=12, width=20, seed=0):
    vocab_path = tmp_path / "vocab.json"
    create_minimal_vocab_file(vocab_path, 64)
    vocab = json.loads(vocab_path.read_text())
    words = sorted(vocab)
    rng = np.random.default_rng(seed)
    lines = [" ".join(words[j] for j in rng.integers(4, 64, rng.integers(5, width)))
             for _ in range(n)]
    data = tmp_path / "train.jsonl"
    data.write_text("\n".join(json.dumps({"text": t}) for t in lines) + "\n")
    ft = tmp_path / "ft.jsonl"
    ft.write_text("\n".join(json.dumps({"instruction": a, "output": b})
                            for a, b in zip(lines[::2], lines[1::2])) + "\n")
    return vocab_path, vocab, data, ft


def test_datasets_and_batch_order_match_jax(tmp_path):
    """The pretrain and fine-tune datasets give the JAX copies' ids, masks
    and labels, and ``BatchLoader`` the same batches in the same order."""
    _, vocab, data, ft = _corpus(tmp_path)
    kw = dict(vocab_dict=vocab, model_config_vocab_size=60, max_length=16)
    pairs = [(jax_datasets.ApertisPretrainDataset(str(data), **kw),
              port_datasets.ApertisPretrainDataset(str(data), **kw))]
    fkw = dict(tokenizer=vocab, max_length=16, model_config_vocab_size=60,
               model_config_eos_token_id=2, model_config_pad_token_id=0,
               model_config_unk_token_id=3, model_config_bos_token_id=1)
    pairs.append((jax_datasets.ApertisFineTuneDataset(str(ft), **fkw),
                  port_datasets.ApertisFineTuneDataset(str(ft), **fkw)))
    for jds, ds in pairs:
        assert len(jds) == len(ds)
        for epoch in (0, 1):
            jl = jax_datasets.BatchLoader(jds, 4, shuffle=True, drop_last=True, seed=3)
            pl = port_datasets.BatchLoader(ds, 4, shuffle=True, drop_last=True, seed=3)
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            jb, pb = list(jl), list(pl)
            assert len(jb) == len(pb) == len(ds) // 4
            for a, b in zip(jb, pb):
                assert a.keys() == b.keys()
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])


def test_export_loads_in_the_jax_package(tmp_path):
    """The port's ``pytorch_model.bin`` + ``config.json`` load through the
    JAX package's ``load_pretrained`` as the same tree, bit for bit."""
    from apertis_llm_torch.models.convert import save_torch_checkpoint
    for over in ({}, MHA):
        _, cfg, tree = _trees(seed=8, **over)
        model = from_jax_params(tree, cfg, device="cpu")
        out = tmp_path / cfg.attention_type
        save_torch_checkpoint(params_tree(model), cfg, out)
        jcfg, jtree = jax_load_pretrained(out)
        assert jcfg.to_dict() == JaxConfig(**cfg.to_dict()).to_dict()
        got = jax.tree_util.tree_flatten_with_path(jtree)[0]
        ref = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert len(got) == len(ref)
        for path, leaf in got:
            np.testing.assert_array_equal(np.asarray(leaf), ref[path])


def _pipeline_config(tmp_path, vocab_path, data, out, **train):
    cfg = {
        "data_config": {"train_data_path": str(data), "val_data_path": str(data),
                        "tokenizer_path": str(vocab_path), "max_length": 16},
        "model_config": {"target_param_count": "1M", "attention_type": "selective_ssm",
                         "config_overrides": {
                             "hidden_size": 64, "num_hidden_layers": 2,
                             "num_attention_heads": 4, "intermediate_size": 128,
                             "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}},
        "training_config": dict({"output_dir": str(out), "batch_size": 4,
                                 "learning_rate": 3e-3, "num_epochs": 4,
                                 "gradient_accumulation_steps": 1, "device": "cpu",
                                 "bf16": False}, **train),
    }
    path = tmp_path / f"config_{len(list(tmp_path.glob('config_*')))}.json"
    path.write_text(json.dumps(cfg))
    return path


def test_train_from_config_end_to_end(tmp_path):
    """``train_from_config`` trains a 2-layer SSM model on a JSONL corpus:
    the epoch loss falls, every checkpoint holds the train state, the weight
    export, the config and the vocabulary, and resuming from the final
    checkpoint continues the update count."""
    vocab_path, _, data, _ = _corpus(tmp_path)
    out = tmp_path / "run"
    history = train_from_config(str(_pipeline_config(tmp_path, vocab_path, data, out)))
    losses = history["train_loss"]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert history["final_step"] == 4 * 3          # 12 rows / batch 4, 4 epochs
    assert history["best_val_loss"] is not None
    for name in ("checkpoint-epoch-1", "checkpoint-epoch-4", "final"):
        files = {p.name for p in (out / name).iterdir()}
        assert {"state.pt", "pytorch_model.bin", "config.json", "vocab.json"} <= files, name
    assert not (out / "best_model" / "state.pt").exists()     # weights only
    assert (out / "best_model" / "pytorch_model.bin").exists()
    assert latest_checkpoint(out) is not None
    resumed = train_from_config(str(_pipeline_config(
        tmp_path, vocab_path, data, tmp_path / "resumed", num_epochs=1,
        resume_from=str(out / "final"))))
    assert resumed["final_step"] == history["final_step"] + 3


def _tiny_dataset(n=4, length=8):
    ids = np.arange(n * length).reshape(n, length).astype(np.int32) % 90 + 4
    return [{"input_ids": row, "labels": row} for row in ids]


@pytest.mark.parametrize("case", ["int8", "mesh", "pipeline", "fine-tune base"])
def test_unsupported_training_raises(tmp_path, case):
    """Each training variant that is not ported raises NotImplementedError
    naming ROADMAP.md, instead of running something else."""
    _, cfg, tree = _trees()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if case == "int8":
            ApertisTrainer(cfg, quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
                           _tiny_dataset(), device="cpu")
        elif case == "mesh":
            ApertisTrainer(cfg, tree, _tiny_dataset(), mesh_shape=(1, 2, 1, 1), device="cpu")
        elif case == "pipeline":
            ApertisTrainer(cfg, tree, _tiny_dataset(), pipeline_stages=2, device="cpu")
        else:
            vocab_path, _, data, ft = _corpus(tmp_path)
            path = _pipeline_config(tmp_path, vocab_path, ft, tmp_path / "ft",
                                    task_type="finetune",
                                    pretrained_model_path_for_finetune=str(tmp_path))
            train_from_config(str(path))


def test_supported_training_passes_the_gate():
    """The configurations the port trains on the card pass the gate: the
    dense SSM model at any ssm_d_state, the flash MHA model (bf16 or f32:
    the flash kernels take both) and the top-2 MoE model."""
    _, cfg, _ = _trees()
    check_trainable(cfg, device="cuda")
    check_trainable(cfg.replace(**MHA), device="cuda")
    for n in (12, 24, 48, 64):
        check_trainable(cfg.replace(ssm_d_state=n), device="cuda")
    check_trainable(cfg.replace(use_expert_system=True, num_experts=4, experts_per_token=2),
                    device="cuda")
    tree = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    trainer = ApertisTrainer(cfg, tree, _tiny_dataset(), batch_size=2, num_epochs=1,
                             device="cpu", output_dir="unused")
    assert trainer.model.embed.tok.requires_grad and trainer.config.remat
