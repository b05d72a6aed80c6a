"""The port's ViT image prefix vs the JAX package's (CPU).

The ViT is held at the widths of ``tests/test_parity.py:93-116`` (48 wide, 2
layers, 4 heads, 32-pixel images of 8-pixel patches) before a 2-layer
selective-SSM decoder of width 128, on one perturbed f32 tree handed to both
packages: ``preprocess_images``, ``vit_encode`` in f32 and bf16, the int8
ViT (JAX's ``ln_quantize`` + w8a8 under ``APERTIS_LN_QUANT=force`` and
``APERTIS_QUANT_MATMUL=dyn``), multimodal ``forward`` and ``prefill`` (dense
and MoE), greedy ``generate`` with images against the JAX engine, the tree's
round trip and export, and the variant gates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models import vit as jax_vit
from apertis_llm_tpu.models.convert import load_pretrained as jax_load_pretrained
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import (
    from_jax_params, params_tree, save_torch_checkpoint)
from apertis_llm_torch.models.params import (
    check_supported, check_trainable, count_params, init_params)
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.models.vit import preprocess_images
from apertis_llm_torch.ops.kernels.ln_quant import ln_quantize

torch.set_num_threads(2)

BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128, multimodal=True, image_size=32,
            vision_patch_size=8, vision_embed_dim=48, vision_layers=2, vision_heads=4)
MOE = dict(use_expert_system=True, num_experts=4, experts_per_token=2)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
# Above the ViT's stacked LayerNorm weights (vision_layers x 48 = 96
# elements), which JAX's rule would otherwise quantize, and at most its
# smallest linear (attn_out, 2 x 48 x 48): every projection, ViT linear and
# vision_proj int8, every norm float.
VIT_MIN_SIZE = 4096
QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force",
             "APERTIS_SSM_STEP": "force", "APERTIS_FFN_FUSED": "force"}
# One bf16 rounding of a value is 2^-8 of it; the bf16 comparisons allow
# this many of the largest value (bf16 products and residual adds rounded
# in other places by XLA and by torch).
BF16_ULPS = 4


def _trees(seed=0, **over):
    """(jax config, jax tree, port config, f32 numpy tree): one perturbed
    f32 tree, so norms and biases are off their unit and zero init."""
    kw = dict(BASE, **over)
    jcfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), ApertisConfig(**kw), tree


def _bf16(tree):
    """The tree rounded to bf16 for JAX, and the same values in f32 numpy
    for the port (which rounds them to bf16 exactly again)."""
    jtree = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    return jtree, jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jtree)


def _images(seed, shape=(2, 40, 48, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err, top = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * top, (err, tol * top)


@pytest.mark.parametrize("kind,shape", [("uint8", (2, 48, 64, 3)), ("float01", (2, 20, 24, 3)),
                                        ("float255", (1, 40, 28, 3))])
def test_preprocess_images_matches_jax(kind, shape):
    """Bilinear resize (antialiased where an axis shrinks, as
    ``jax.image.resize``) and ImageNet normalisation, shrinking, growing and
    both: within 5e-5 of JAX's, whose antialias filter weights are computed
    in another order in f32 (1e-7 to 1.3e-5 seen at 48x64 -> 32, 100x120 and
    300x200 -> 224)."""
    rng = np.random.default_rng(1)
    if kind == "uint8":
        img = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        img = rng.uniform(0.0, 1.0 if kind == "float01" else 255.0, shape).astype(np.float32)
    ref = np.asarray(jax_vit.preprocess_images(jnp.asarray(img), 32))
    got = preprocess_images(torch.as_tensor(img), 32).numpy()
    assert got.shape == (shape[0], 3, 32, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_encode_matches_jax(dtype):
    """The vision encoder on one tree: f32 within 1e-5 of the largest value,
    bf16 within BF16_ULPS bf16 roundings of it."""
    _, jtree, cfg, tree = _trees(seed=2)
    if dtype == "bfloat16":
        jtree, tree = _bf16(tree)
    model = from_jax_params(tree, cfg, device="cpu", dtype=getattr(torch, dtype))
    pixels = np.random.default_rng(3).normal(size=(2, 3, 32, 32)).astype(np.float32)
    ref = jax_vit.vit_encode(jtree["vision"], JaxConfig(**BASE), jnp.asarray(pixels))
    with torch.no_grad():
        got = model.vision(torch.as_tensor(pixels))
    assert got.shape == (2, 17, 48) and got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(ref, np.float32),
           1e-5 if dtype == "float32" else BF16_ULPS * 2.0 ** -8)


def test_int8_vit_matches_jax(monkeypatch):
    """The int8 ViT (``quantize_vision=True``): ``ln1`` / ``ln2`` through
    ``ln_quantize`` into ``in_proj`` / ``linear1`` (``pre_q``), the other
    linears w8a8, against JAX's under ``APERTIS_LN_QUANT=force`` and
    ``APERTIS_QUANT_MATMUL=dyn``. Both quantize the same values with the same
    formulas; f32 sums around the int8 products run in other orders, so an
    activation on a rounding boundary may take the next level: within 2e-3
    of the largest value."""
    for key, value in QUANT_ENV.items():
        monkeypatch.setenv(key, value)
    _, jtree, cfg, tree = _trees(seed=4)
    jq = jax_quantize_params(jtree, min_size=VIT_MIN_SIZE, quantize_vision=True)
    tq = quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=VIT_MIN_SIZE,
                         quantize_vision=True)
    assert "in_proj_w_q" in jq["vision"]["layers"] and "w" in jq["vision"]["layers"]["ln1"]
    model = from_jax_params(tq, cfg, device="cpu")
    model.set_modes("dyn", "fatk")
    assert model.vision.layers[0].quantized and model.vision_proj.w_q.dtype == torch.int8
    pixels = np.random.default_rng(5).normal(size=(2, 3, 32, 32)).astype(np.float32)
    ref = jax_vit.vit_encode(jq["vision"], JaxConfig(**BASE), jnp.asarray(pixels))
    ln_quantize.launches = 0
    with torch.no_grad():
        got = model.vision(torch.as_tensor(pixels))
    assert ln_quantize.launches == 0     # the plain version on the CPU
    _close(got.numpy(), np.asarray(ref), 2e-3)


def test_ln_quantize_matches_jax_at_the_vit_layer_norm():
    """The plain ``ln_quantize`` at the ViT's LayerNorm with bias, width 768
    and eps 1e-5, bf16 rows, against the interpret-mode TPU kernel, to the
    JAX package's tolerance (tests/test_pallas_kernels.py:270): a level may
    flip by one on under 1e-3 of the elements, scales within 1e-6."""
    from apertis_llm_tpu.ops.pallas.ln_quant import ln_quantize as jax_ln_quantize
    r = np.random.default_rng(6)
    x = jnp.asarray(r.standard_normal((37, 768)) * 2.0, jnp.bfloat16)
    w = (1.0 + 0.1 * r.standard_normal(768)).astype(np.float32)
    b = (0.1 * r.standard_normal(768)).astype(np.float32)
    q_ref, s_ref = jax_ln_quantize(x, jnp.asarray(w), jnp.asarray(b), eps=1e-5, rms=False)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    q, s = ln_quantize(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    dq = np.abs(q.numpy().astype(int) - np.asarray(q_ref).astype(int))
    assert dq.max() <= 1 and (dq > 0).mean() < 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)


def _ragged(rng, lens, width, vocab):
    ids = np.zeros((len(lens), width), np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(lens):
        ids[row, :n] = rng.integers(4, vocab, n)
        mask[row, :n] = 1
    return ids, mask


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_multimodal_forward_and_prefill_match_jax(family):
    """f32 text logits of ``forward`` and ragged ``prefill`` (the prefix's
    197-style positions counted in the SSM's lengths) and its ``{conv, ssm}``
    cache, within 1e-5 of the largest value; uint8 images of another size
    than the ViT's, so the resize runs."""
    jcfg, jtree, cfg, tree = _trees(seed=7, **(MOE if family == "moe" else {}))
    model = from_jax_params(tree, cfg, device="cpu")
    ids, mask = _ragged(np.random.default_rng(8), [9, 4, 6], 9, cfg.vocab_size)
    img = _images(9, (3, 40, 48, 3))
    ref = jax_model.forward(jtree, jcfg, jnp.asarray(ids), pixel_values=jnp.asarray(img)).logits
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long), pixel_values=torch.as_tensor(img))
    assert got.shape == (3, 9, cfg.vocab_size)
    _close(got.numpy(), np.asarray(ref), 1e-5)
    last = mask.sum(1) - 1
    jpre = jax_model.prefill(jtree, jcfg, jax_model.init_cache(jcfg, 3), jnp.asarray(ids),
                             attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(img),
                             logit_positions=jnp.asarray(last))
    tpre = model.prefill(model.init_cache(3), torch.as_tensor(ids, dtype=torch.long),
                         torch.as_tensor(mask), logit_positions=torch.as_tensor(last),
                         pixel_values=torch.as_tensor(img))
    assert tpre.length == cfg.num_image_tokens + 9 == int(jpre.length)
    _close(tpre.logits.numpy(), np.asarray(jpre.logits), 1e-5)
    for key in ("conv", "ssm"):
        _close(tpre.cache[key].numpy(), np.asarray(jpre.cache[key]), 1e-5)


def _engines(monkeypatch, kind):
    """The JAX and the port's engine on one multimodal tree: f32, bf16, or
    int8 with an int8 ViT (each package's ``quantize_params`` on the same
    f32 tree) and the JAX knobs of the port's one int8 arithmetic."""
    monkeypatch.setenv("APERTIS_SSM_STEP", "force")
    monkeypatch.setenv("APERTIS_FFN_FUSED", "force")
    jcfg, jtree, cfg, tree = _trees(seed=10, **(BF16 if kind == "bf16" else {}))
    dtype = torch.float32
    if kind == "bf16":
        jtree, tree = _bf16(tree)
        dtype = torch.bfloat16
    if kind == "int8":
        for key, value in QUANT_ENV.items():
            monkeypatch.setenv(key, value)
        # The TPU FFN kernel's tanh-form erf flips int8 hidden levels; both
        # engines compute the exact GELU (tests/test_torch_engine.py).
        monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)
        jtree = jax_quantize_params(jtree, min_size=VIT_MIN_SIZE, quantize_vision=True)
        tree = quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=VIT_MIN_SIZE,
                               quantize_vision=True)
    return JaxEngine(jcfg, jtree), InferenceEngine(cfg, from_jax_params(tree, cfg, device="cpu",
                                                                        dtype=dtype),
                                                   quant_matmul="dyn")


@pytest.mark.parametrize("kind", ["float32", "bf16", "int8"])
def test_greedy_generate_with_images_matches_jax_engine(kind, monkeypatch):
    """Greedy generation with uint8 images, token for token against the JAX
    engine: the bucket aligned with the prefix (7 prompt columns, 17 image
    tokens: bucket 32 + 7), the first token from each row's last real text
    position, then the fused decode steps."""
    jax_engine, engine = _engines(monkeypatch, kind)
    ids, mask = _ragged(np.random.default_rng(11), [7, 2, 4], 7, 131)
    img = _images(12, (3, 24, 40, 3))
    kw = dict(max_new_tokens=8, eos_token_id=())
    ref = jax_engine.generate(ids, attention_mask=mask, pixel_values=img,
                              rng=jax.random.PRNGKey(0), **kw)
    ln_quantize.launches = 0
    got = engine.generate(ids, attention_mask=mask, pixel_values=img, **kw)
    assert got.shape == (3, 15)
    np.testing.assert_array_equal(got, ref)


def test_vision_tree_round_trip_and_export(tmp_path):
    """``from_jax_params`` unstacks ``vision.layers`` over ``vision_layers``
    and ``params_tree`` stacks it back, leaf for leaf; the export loads
    through the JAX package's ``load_pretrained`` as the same tree, bit for
    bit; the port's own init builds JAX's names and shapes."""
    jcfg, _, cfg, tree = _trees(seed=13)
    model = from_jax_params(tree, cfg, device="cpu")
    assert len(model.vision.layers) == 2
    back = params_tree(model)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), back))[0]
    assert len(got) == len(flat)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, flat[path])
    save_torch_checkpoint(back, cfg, tmp_path)
    lcfg, ltree = jax_load_pretrained(tmp_path)
    assert lcfg.multimodal and lcfg.vision_layers == 2 and lcfg.vision_embed_dim == 48
    loaded = jax.tree_util.tree_flatten_with_path(ltree)[0]
    assert len(loaded) == len(flat)
    for path, leaf in loaded:
        np.testing.assert_array_equal(np.asarray(leaf), flat[path])
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg))
    assert (jax.tree.map(lambda t: tuple(t.shape), own)
            == jax.tree.map(lambda t: tuple(t.shape), shapes))
    assert count_params(own) == sum(x.size for x in jax.tree.leaves(shapes))


def test_variant_gates_name_the_roadmap():
    """``check_supported`` admits the multimodal selective-SSM model, dense
    and MoE, and MHA with an image prefix; ``check_trainable`` admits
    multimodal training on one rank and refuses it on a mesh of more than
    one, naming ROADMAP.md."""
    check_supported(ApertisConfig(**BASE))
    check_supported(ApertisConfig(**dict(BASE, **MOE)))
    mha = ApertisConfig(**dict(BASE, attention_type="standard_mha"))
    check_supported(mha)
    for cfg in (ApertisConfig(**BASE), mha):
        check_trainable(cfg, device="cpu")
        with pytest.raises(NotImplementedError,
                           match="multimodal training on a mesh.*ROADMAP.md"):
            check_trainable(cfg, device="cpu", mesh_shape=(2, 1, 1, 1))
    check_trainable(ApertisConfig(**dict(BASE, multimodal=False)), device="cpu")
