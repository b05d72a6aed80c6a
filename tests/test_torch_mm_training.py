"""Multimodal training in the port vs the JAX package (CPU, tiny models).

A 2-layer decoder (dense selective SSM, top-2 MoE, or flash MHA) of width
128 behind a ViT of width 64 (2 layers, 4 heads, 32-pixel images of 8-pixel
patches: 17 tokens) and ``vision_proj``, on one perturbed numpy f32 tree
handed to both packages. The loss and every gradient, the ViT's leaves
included, are held against JAX's ``loss_fn``, the decay mask against
``_decay_mask``, three updates against ``make_train_step`` with
``optax.MultiSteps``, and the dataset's image items against JAX's on PNGs
written here. On the CPU the port's kernels run their plain versions and
the JAX forward never takes its flash kernel (its gate wants a TPU), so the
flash MHA model is held against JAX's plain attention, the same function.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.training import datasets as jax_datasets
from apertis_llm_tpu.training import step as jax_step
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.convert import from_jax_params, load_pretrained
from apertis_llm_torch.training import datasets as port_datasets
from apertis_llm_torch.training import step as port_step
from apertis_llm_torch.training import train_from_config
from apertis_llm_torch.training.trainer import ApertisTrainer
from apertis_llm_torch.utils.images import create_sample_image
from apertis_llm_torch.utils.vocab import create_minimal_vocab_file

torch.set_num_threads(2)

VIT = dict(multimodal=True, image_size=32, vision_patch_size=8, vision_embed_dim=64,
           vision_layers=2, vision_heads=4)
BASE = dict(vocab_size=97, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=256, **VIT)
ARCHS = {
    "ssm": {},
    # A capacity factor of 0.5: tokens overflow and are dropped.
    "moe": dict(use_expert_system=True, num_experts=4, experts_per_token=2,
                expert_capacity_factor=0.5),
    "mha": dict(attention_type="standard_mha", use_flash_attention=True),
}
# Text lengths: 111 MHA tokens behind the 17 image tokens are 128 positions,
# where the port's flash gate holds (no mask: the flash route).
TEXT = {"ssm": 32, "moe": 32, "mha": 111}
# f32 on both sides, as tests/test_torch_training.py: sums in other orders,
# each gradient leaf within 1e-4 of its largest element, the loss within a
# relative 1e-5.
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5


def _trees(seed, arch="ssm", **over):
    kw = dict(BASE, **ARCHS[arch], **over)
    jcfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, ApertisConfig(**kw), tree


def _batch(seed, b, l, vocab):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (b, l)).astype(np.int32)
    labels = ids.copy()
    labels[:, -5:] = -100
    pixels = rng.normal(size=(b, 3, 32, 32)).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "pixel_values": pixels}


def _torch_batch(batch):
    return {k: torch.as_tensor(v, dtype=None if k == "pixel_values" else torch.long)
            for k, v in batch.items()}


def _jax_node(tree, name):
    """The leaf (or mask entry) of a stacked JAX tree for a port parameter
    name: ``layers.3.x`` and ``vision.layers.1.y`` index the stacked axis."""
    parts = name.split(".")
    for prefix in (["layers"], ["vision", "layers"]):
        n = len(prefix)
        if parts[:n] == prefix and parts[n].isdigit():
            node = tree
            for key in prefix + parts[n + 1:]:
                node = node[key]
            return node, int(parts[n])
    node = tree
    for key in parts:
        node = node[key]
    return node, None


def _jax_leaf(tree, name):
    node, idx = _jax_node(tree, name)
    return np.asarray(node) if idx is None else np.asarray(node)[idx]


def _assert_close(got, ref, tol, name):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: {err:.3e} vs max {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("arch", ["ssm", "moe", "mha"])
def test_multimodal_loss_and_gradients_match_jax(arch):
    """The loss and every parameter's gradient, the ViT's and
    ``vision_proj``'s included, of a 2-layer multimodal model against JAX's
    ``loss_fn`` / ``value_and_grad`` with ``pixel_values`` (f32, no
    dropout); the MoE model with a capacity that drops tokens, its lb and rz
    losses too; the MHA model through the flash route (no mask, 128
    positions)."""
    jcfg, cfg, tree = _trees(1, arch)
    batch = _batch(2, 2, TEXT[arch], cfg.vocab_size)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jax_step.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        None, None)
    model = from_jax_params(tree, cfg, device="cpu")
    params = dict(model.named_parameters())
    loss, metrics = port_step.loss_fn(model, _torch_batch(batch), None)
    grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    if arch == "moe":
        for name in ("lb_loss", "rz_loss"):
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]),
                                       rtol=LOSS_RTOL)
    vision = [g for name, g in zip(params, grads) if name.startswith("vision")]
    assert len(vision) == 4 + 12 * cfg.vision_layers + 2 + 2
    assert all(float(g.abs().max()) > 0 for g in vision)
    for name, g in zip(params, grads):
        _assert_close(g.numpy(), _jax_leaf(jgrads, name), GRAD_TOL, name)
    # Without the images the loss changes: the prefix is in the graph.
    text_only = {k: v for k, v in _torch_batch(batch).items() if k != "pixel_values"}
    assert float(port_step.loss_fn(model, text_only, None)[0].detach()) != float(loss.detach())


def test_decay_mask_matches_jax_on_multimodal_trees():
    """Leaf by leaf, the port's weight-decay mask is JAX's ``_decay_mask``
    over whole multimodal trees: the ViT's stacked LayerNorm weights (2-D
    leaves in the JAX tree) are decayed, its final LayerNorm, CLS token,
    position embeddings and biases are not."""
    for arch in ARCHS:
        _, cfg, tree = _trees(0, arch)
        jmask = jax_step._decay_mask(tree)
        mask = port_step.decay_mask(from_jax_params(tree, cfg, device="cpu"))
        assert mask == {name: bool(_jax_node(jmask, name)[0]) for name in mask}, arch
        assert mask["vision.layers.1.ln1.w"] and mask["vision.layers.0.ln2.w"]
        assert mask["vision.patch_embed.w"] and mask["vision_proj.w"]
        assert not (mask["vision.final_ln.w"] or mask["vision.cls_token"]
                    or mask["vision.pos_embed"] or mask["vision.layers.0.in_proj_b"])


def test_three_multimodal_updates_follow_jax():
    """Three f32 updates with accumulation 2 (six micro-steps with images)
    follow JAX's ``make_train_step`` + ``optax.MultiSteps``: each
    micro-step's loss within a relative 1e-5, and every parameter's change,
    the ViT's included, within 1e-2 of its largest value (Adam divides each
    gradient by its own magnitude, as tests/test_torch_training.py)."""
    jcfg, cfg, tree = _trees(6)
    batches = [_batch(7 + i, 2, 24, cfg.vocab_size) for i in range(6)]
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


@pytest.mark.parametrize("arch", ["ssm", "mha"])
def test_remat_gives_equal_multimodal_gradients(arch):
    """With dropout live (a step seed) and bf16 compute, per-layer remat of
    the decoder gives the same gradients, the ViT's included, as no remat;
    a second seed gives other gradients."""
    _, cfg, tree = _trees(3, arch, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    model = from_jax_params(tree, cfg, device="cpu")
    batch = _torch_batch(_batch(4, 2, TEXT[arch], cfg.vocab_size))
    params = dict(model.named_parameters())

    def grads(remat, seed):
        model.config = cfg.replace(remat=remat)
        loss, _ = port_step.loss_fn(model, batch, seed, torch.bfloat16)
        return [g.float() for g in torch.autograd.grad(loss, list(params.values()))]

    plain, remat, other = grads(False, 7), grads(True, 7), grads(True, 8)
    for name, a, b in zip(params, plain, remat):
        assert torch.equal(a, b), name
    assert any(not torch.equal(a, b) for a, b in zip(plain, other))


def _image_corpus(tmp_path, n=8):
    """A vocabulary, PNGs of other sizes than the ViT's (the sample gradient
    image and seeded noise), a file that is no image, and a JSONL corpus
    whose items name them relative to the image directory (one has none)."""
    from PIL import Image
    vocab_path = tmp_path / "vocab.json"
    create_minimal_vocab_file(vocab_path, 64)
    words = sorted(json.loads(vocab_path.read_text()))
    images = tmp_path / "images"
    images.mkdir()
    create_sample_image(str(images / "sample.png"), size=40)
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (24 + 8 * i, 48, 3)).astype(np.uint8)).save(
            images / f"noise{i}.png")
    (images / "broken.png").write_text("not an image")
    names = ["sample.png", "noise0.png", "noise1.png", "noise2.png", "broken.png"]
    data = tmp_path / "train.jsonl"
    lines = []
    for i in range(n):
        item = {"text": " ".join(words[j] for j in rng.integers(4, 64, rng.integers(5, 20)))}
        item["image"] = names[i % len(names)]
        lines.append(json.dumps(item))
    data.write_text("\n".join(lines) + "\n")
    return vocab_path, json.loads(vocab_path.read_text()), data, images


def test_dataset_image_items_match_jax(tmp_path):
    """The pretrain dataset's multimodal items (``pixel_values`` (3, S, S)
    from PIL's bilinear resize, a blank for a file that is no image) and
    ``BatchLoader``'s batches are JAX's, bit for bit."""
    _, vocab, data, images = _image_corpus(tmp_path)
    kw = dict(vocab_dict=vocab, model_config_vocab_size=60, max_length=16, multimodal=True,
              image_dir=str(images), image_size=32)
    jds = jax_datasets.ApertisPretrainDataset(str(data), **kw)
    ds = port_datasets.ApertisPretrainDataset(str(data), **kw)
    assert len(ds) == len(jds) == 8
    assert ds[0]["pixel_values"].shape == (3, 32, 32) and ds[0]["pixel_values"].dtype == np.float32
    assert not ds[4]["pixel_values"].any() and ds[1]["pixel_values"].any()
    jb = list(jax_datasets.BatchLoader(jds, 4, shuffle=True, seed=3))
    pb = list(port_datasets.BatchLoader(ds, 4, shuffle=True, seed=3))
    assert len(jb) == len(pb) == 2
    for a, b in zip(jb, pb):
        assert a.keys() == b.keys() and "pixel_values" in b
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_put_batch_keeps_the_pixels_float(tmp_path):
    """The trainer moves ``pixel_values`` to the device in its float dtype,
    unchanged, and the token ids, masks and labels as int64."""
    _, cfg, tree = _trees(0)
    rows = [{"input_ids": np.arange(8, dtype=np.int32) + 4, "labels": np.arange(8) + 4,
             "pixel_values": np.full((3, 32, 32), 0.25 * i - 0.6, np.float32)}
            for i in range(4)]
    trainer = ApertisTrainer(cfg, tree, rows, batch_size=2, num_epochs=1, device="cpu",
                             output_dir=str(tmp_path), save_checkpoints=False)
    batch = next(iter(trainer.train_loader))
    put = trainer._put_batch(batch)
    assert put["pixel_values"].dtype == torch.float32
    assert torch.equal(put["pixel_values"], torch.from_numpy(batch["pixel_values"]))
    assert put["input_ids"].dtype == put["labels"].dtype == torch.int64


def test_train_from_config_trains_a_multimodal_model(tmp_path, monkeypatch):
    """``train_from_config`` on a multimodal config with ``image_dir``: the
    dataset's images reach the model, the epoch loss falls, and the final
    checkpoint holds the ViT, which ``load_pretrained`` reads back into the
    trained weights."""
    vocab_path, _, data, images = _image_corpus(tmp_path)
    out = tmp_path / "run"
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "data_config": {"train_data_path": str(data), "tokenizer_path": str(vocab_path),
                        "image_dir": str(images), "max_length": 16},
        "model_config": {"target_param_count": "1M", "attention_type": "selective_ssm",
                         "multimodal": True,
                         "config_overrides": dict(
                             hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                             intermediate_size=128, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0, **VIT)},
        "training_config": {"output_dir": str(out), "batch_size": 4, "learning_rate": 3e-3,
                            "num_epochs": 4, "gradient_accumulation_steps": 1,
                            "device": "cpu", "bf16": False}}))
    seen = []
    real = port_step.loss_fn

    def spy(model, batch, *a, **k):
        seen.append((tuple(batch["pixel_values"].shape), batch["pixel_values"].dtype))
        return real(model, batch, *a, **k)

    monkeypatch.setattr(port_step, "loss_fn", spy)
    history = train_from_config(str(path))
    losses = history["train_loss"]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert set(seen) == {((4, 3, 32, 32), torch.float32)}
    model = load_pretrained(out / "final", device="cpu")
    assert model.config.multimodal and len(model.vision.layers) == 2
