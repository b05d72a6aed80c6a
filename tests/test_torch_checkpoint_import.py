"""Checkpoint import in the port vs the JAX package's (CPU).

Checkpoints in the reference's format are written here by each package's
``save_torch_checkpoint`` from one perturbed f32 tree: a dense and a MoE
selective-SSM model, an MHA model with q/k/v/o biases, and the dense SSM and
MHA models with the ViT prefix. The port's ``load_pretrained`` reads each
directory with its ``config.json``, and the bare weights file alone through
``infer_config_from_state_dict``; its logits are held against the JAX
package's ``load_pretrained`` of the same path.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.convert import load_pretrained as jax_load_pretrained
from apertis_llm_tpu.models.convert import save_torch_checkpoint as jax_save_checkpoint
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.convert import (
    from_jax_params, from_torch_state_dict, infer_config_from_state_dict, load_pretrained,
    load_torch_state_dict, params_tree, save_torch_checkpoint)
from apertis_llm_torch.multimodal import MultimodalDataProcessor

torch.set_num_threads(2)

REPO_ROOT = Path(__file__).resolve().parents[1]
BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# The ViT at 12 heads (the default a bare file is read with): width 48 in
# heads of 4, 32-pixel images of 8-pixel patches.
VIT = dict(multimodal=True, image_size=32, vision_patch_size=8, vision_embed_dim=48,
           vision_layers=2, vision_heads=12)
# MHA at heads of 64, which a bare file is read with.
MHA = dict(attention_type="standard_mha", num_attention_heads=2)
FAMILIES = {"dense": {}, "moe": dict(use_expert_system=True, num_experts=4,
                                     experts_per_token=2),
            "mha": MHA, "mm": VIT, "mm-mha": dict(MHA, **VIT)}
# The fields a bare file's shapes give, each of which the families above set
# to what they give.
INFERRED = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "attention_type", "ssm_d_state", "ssm_d_inner", "ssm_dt_rank",
            "ssm_conv_kernel", "use_expert_system", "num_experts", "multimodal", "image_size",
            "vision_embed_dim", "vision_patch_size", "vision_layers", "use_rmsnorm")
# f32 logits of one tree through each package: sums in other orders, within
# 1e-5 of the largest value (as tests/test_torch_vit.py).
TOL = 1e-5


def _tree(family, seed=0):
    kw = dict(BASE, **FAMILIES[family])
    jcfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, ApertisConfig(**kw), tree


def _write(tmp_path, family, writer):
    """A checkpoint directory of ``family`` written by ``writer``."""
    jcfg, cfg, tree = _tree(family)
    out = tmp_path / f"{family}-{writer}"
    if writer == "jax":
        jax_save_checkpoint(jax.tree.map(jnp.asarray, tree), jcfg, out)
    else:
        save_torch_checkpoint(params_tree(from_jax_params(tree, cfg, device="cpu")), cfg, out)
    return out, cfg


def _inputs(cfg):
    rng = np.random.default_rng(1)
    ids = rng.integers(4, cfg.vocab_size, (2, 9)).astype(np.int32)
    img = rng.integers(0, 256, (2, 40, 36, 3)).astype(np.uint8) if cfg.multimodal else None
    return ids, img


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("with_config", [True, False])
def test_load_pretrained_matches_jax(tmp_path, family, writer, with_config):
    """A checkpoint written by either package loads into the port, from its
    directory with ``config.json`` or as a bare weights file, and gives the
    JAX package's logits for the same path (images for the multimodal ones);
    with ``config.json`` the config is the writer's; from the bare file it
    is JAX's inference, except that MHA biases imply attention dropout 0."""
    out, cfg = _write(tmp_path, family, writer)
    path = out
    if not with_config:
        bare = tmp_path / "bare"
        bare.mkdir()
        path = Path(shutil.copy(out / "pytorch_model.bin", bare / "weights.bin"))
    model = load_pretrained(path, device="cpu")
    jcfg, jtree = jax_load_pretrained(path)
    want = jcfg.to_dict()
    if not with_config and "mha" in family:
        assert jcfg.attention_probs_dropout_prob == 0.1
        want["attention_probs_dropout_prob"] = 0.0
    assert model.config.to_dict() == want
    if with_config:
        assert model.config.to_dict() == cfg.to_dict()
    ids, img = _inputs(model.config)
    ref = jax_model.forward(jtree, jcfg, jnp.asarray(ids),
                            pixel_values=None if img is None else jnp.asarray(img)).logits
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long),
                    pixel_values=None if img is None else torch.as_tensor(img))
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2, 9, cfg.vocab_size)
    assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_round_trip_is_bit_exact(tmp_path, family):
    """The port's export read back by ``from_torch_state_dict`` is the
    tree it was written from, leaf for leaf, bit for bit, in bf16 too (the
    export writes f32, which holds every bf16 value)."""
    _, cfg, tree = _tree(family, seed=3)
    model = from_jax_params(tree, cfg, device="cpu", dtype=torch.bfloat16)
    save_torch_checkpoint(params_tree(model), cfg, tmp_path)
    sd = load_torch_state_dict(tmp_path / "pytorch_model.bin")
    assert all(v.dtype == torch.float32 for v in sd.values())
    back = from_jax_params(from_torch_state_dict(sd, cfg), cfg, device="cpu",
                           dtype=torch.bfloat16)
    for (name, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), name
    inferred = infer_config_from_state_dict(sd).to_dict()
    assert {k: inferred[k] for k in INFERRED} == {k: cfg.to_dict()[k] for k in INFERRED}


def test_from_pretrained_matches_jax(tmp_path):
    """``ApertisConfig.from_pretrained`` reads a directory's ``config.json``,
    a ``.json`` path, or the parent's ``config.json`` for a directory with
    none, as JAX's does; a path with none raises ``FileNotFoundError``."""
    _, cfg, _ = _tree("mm-mha")
    cfg.save_pretrained(tmp_path)
    (tmp_path / "sub").mkdir()
    for path in (tmp_path, tmp_path / "config.json", tmp_path / "sub"):
        got = ApertisConfig.from_pretrained(path)
        assert got == cfg
        assert got.to_dict() == JaxConfig.from_pretrained(path).to_dict()
    with pytest.raises(FileNotFoundError):
        ApertisConfig.from_pretrained(tmp_path / "nothing" / "here")


def test_entry_points_default_to_the_card(tmp_path):
    """``load_pretrained`` and the processor build on the card unless the
    caller names another device: here, with no card, they raise and say how
    to ask for the CPU."""
    out, _ = _write(tmp_path, "dense", "port")
    if torch.cuda.is_available():
        assert load_pretrained(out).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_pretrained(out)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultimodalDataProcessor(image_size=32, vision_embed_dim=48, vision_patch_size=8,
                                vision_heads=4, vision_layers=1)


def test_new_modules_import_no_jax():
    """Checkpoint import, the images and the processor import nothing of JAX
    or of the JAX package."""
    code = ("import sys\n"
            "import apertis_llm_torch.models.convert, apertis_llm_torch.multimodal\n"
            "import apertis_llm_torch.utils.images, apertis_llm_torch.training.datasets\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'apertis_llm_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
