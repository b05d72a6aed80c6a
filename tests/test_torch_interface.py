"""The port's ``ApertisInterface`` and ``ApertisInference`` against the JAX
package's, on the CPU.

At temperature 0 both interfaces must give the same replies on the same
checkpoint: one written by JAX's ``save_torch_checkpoint`` (selective SSM,
also multimodal with an image prompt, and MHA) and one written by the port's
``create-model``; in f32 and with ``quantize="int8"``. ``ApertisInference``
streams the same growing text. The JAX side runs its fused decode paths, as
the engine tests set them, with the exact GELU in its kernels. Then the
port's own rules: the dummy model for a checkpoint that cannot be read, the
refusal of a serving mesh, errors of the kernels' build propagating out of
the engine's construction, and the card as the default device.
"""

import json

import numpy as np
import pytest
import torch

import jax

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.interface import ApertisInference as JaxInference
from apertis_llm_tpu.inference.interface import ApertisInterface as JaxInterface
from apertis_llm_tpu.models.convert import save_torch_checkpoint as jax_save
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_torch import cli
from apertis_llm_torch.inference import interface as interface_mod
from apertis_llm_torch.inference.interface import ApertisInference, ApertisInterface

torch.set_num_threads(2)

# Every projection of this width has at least 65,536 weights, so the
# default quantize_params(min_size=1 << 16) makes the whole tree int8.
BASE = dict(vocab_size=64, hidden_size=512, num_hidden_layers=2, num_attention_heads=16,
            intermediate_size=1024, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=256)
VOCAB = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3,
         **{w: i + 4 for i, w in enumerate(("hello", "world", "the", "cat", "User:",
                                            "Assistant:", "who", "are", "you", "?"))}}
SERVE_ENV = {"APERTIS_SSM_STEP": "force", "APERTIS_FFN_FUSED": "force",
             "APERTIS_MHA_STEP": "force"}
QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force"}
SAMPLING = dict(temperature=0.0, max_length=8)


@pytest.fixture()
def serving(monkeypatch):
    for key, value in SERVE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)

    def int8():
        for key, value in QUANT_ENV.items():
            monkeypatch.setenv(key, value)
    return int8


def _jax_checkpoint(path, seed=0, **over):
    """A perturbed f32 model saved by the JAX package, with VOCAB."""
    cfg = JaxConfig(**dict(BASE, **over))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), cfg))
    jax_save(tree, cfg, path, filename="model.pt")
    (path / "vocab.json").write_text(json.dumps(VOCAB))
    return path


def _both(path, **kw):
    return JaxInterface(model_path=str(path), **kw), ApertisInterface(model_path=str(path),
                                                                      device="cpu", **kw)


TURNS = ["hello world", "who are you ?"]


@pytest.mark.parametrize("kind", ["ssm", "mha"])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_chat_round_trip_matches_jax(kind, quantize, tmp_path, serving):
    if quantize:
        serving()
    over = {"attention_type": "standard_mha", "num_attention_heads": 8} if kind == "mha" else {}
    jiface, iface = _both(_jax_checkpoint(tmp_path, seed=1, **over), quantize=quantize)
    assert iface.actual_model_path_loaded == str(tmp_path)
    assert iface.model.quantized == (quantize == "int8")
    for turn in TURNS:
        assert iface.chat(turn, **SAMPLING) == jiface.chat(turn, **SAMPLING)
    assert iface.chat_history == jiface.chat_history
    iface.reset_chat()
    streamed = list(iface.chat(TURNS[0], stream=True, **SAMPLING))
    assert streamed[-1] == iface.chat_history[1]["content"] == jiface.chat_history[1]["content"]


def test_inference_streaming_matches_jax(tmp_path, serving):
    path = _jax_checkpoint(tmp_path, seed=2)
    messages = [{"role": "system", "content": "the cat"},
                {"role": "user", "content": "hello world"}]
    kw = dict(stream=True, max_new_tokens=8, temperature=0.0)
    got = list(ApertisInference(str(path), device="cpu").chat(messages, **kw))
    ref = list(JaxInference(str(path)).chat(messages, **kw))
    assert got == ref and len(got) == 8


def test_create_model_checkpoint_serves_as_in_jax(tmp_path, serving):
    """A checkpoint of the port's ``create-model`` (its own minimal vocab)
    gives the JAX interface's replies."""
    out = tmp_path / "m"
    cli.main(["create-model", "--target-params", "1M", "--vocab-size", "96", "--attention-type",
              "selective_ssm", "--output-dir", str(out), "--device", "cpu"])
    jiface, iface = _both(out)
    assert iface.tokenize("hello world") == jiface.tokenize("hello world") == [3, 3]
    assert iface.chat("hello world", **SAMPLING) == jiface.chat("hello world", **SAMPLING)


def test_image_prompt_matches_jax(tmp_path, serving):
    """A multimodal model answers an image prompt as JAX's does: the image
    loaded and normalised to (1, 3, S, S), the prefix before the prompt."""
    from PIL import Image

    over = dict(multimodal=True, image_size=32, vision_patch_size=16, vision_embed_dim=64,
                vision_layers=1, vision_heads=2)
    path = _jax_checkpoint(tmp_path, seed=3, **over)
    image = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (40, 30, 3)).astype(np.uint8)
                    ).save(image)
    jiface, iface = _both(path, multimodal=True)
    assert iface.multimodal
    np.testing.assert_array_equal(iface.preprocess_image(str(image)),
                                  jiface.preprocess_image(str(image)))
    got = iface.generate_response("the cat", image_path=str(image), **SAMPLING)
    assert got == jiface.generate_response("the cat", image_path=str(image), **SAMPLING)


def test_unreadable_checkpoint_falls_back_to_the_dummy(tmp_path):
    iface = ApertisInterface(model_path=str(tmp_path / "missing"), device="cpu")
    assert iface.actual_model_path_loaded == "Dummy Startup Model"
    assert iface.config.vocab_size == 100 and iface.engine is not None
    assert isinstance(iface.generate_response("hello", **SAMPLING), str)
    dummy = ApertisInterface(device="cpu")
    assert dummy.actual_tokenizer_path_loaded == "Dummy Startup Vocab"


def test_mesh_and_quantize_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1, item 5.6"):
        ApertisInterface(device="cpu", mesh_shape=[1, 4, 1])
    with pytest.raises(ValueError, match="int8"):
        ApertisInterface(device="cpu", quantize="int4")


def test_kernel_build_errors_propagate(tmp_path, monkeypatch):
    """A kernel's build failing inside the engine's construction is raised,
    not served as the dummy model."""
    path = _jax_checkpoint(tmp_path, seed=5)

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc failed for ['ssm_step.cu']")

    monkeypatch.setattr(interface_mod, "InferenceEngine", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ApertisInterface(model_path=str(path), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ApertisInterface()
