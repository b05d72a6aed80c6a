"""The port's MHA model with the ViT image prefix vs the JAX package's (CPU).

A 2-layer MHA decoder of width 128 (4 heads of 32) behind a ViT of width 64
(2 layers, 4 heads, 32-pixel images of 8-pixel patches: 17 tokens) and
``vision_proj``, on one perturbed f32 tree handed to both packages. The JAX
side runs its flat-cache decode path (``APERTIS_MHA_STEP=force``), with an
int8 KV cache under ``APERTIS_QUANT_KV=1``, and for int8 weights the port's
one int8 arithmetic (``APERTIS_QUANT_MATMUL=dyn``, ``APERTIS_LN_QUANT=force``,
``APERTIS_FFN_FUSED=force``) with the exact GELU in its FFN kernel. Both
quantize the same f32 tree with their own ``quantize_params``, the ViT too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import attach_qkv_mha
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.quantize import quantize_tied_head as jax_quantize_tied_head
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.quantize import quantize_params

torch.set_num_threads(2)

BASE = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="standard_mha",
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=256, multimodal=True, image_size=32,
            vision_patch_size=8, vision_embed_dim=64, vision_layers=2, vision_heads=4)
NUM_IMG = 17
MHA_ENV = {"APERTIS_MHA_STEP": "force", "APERTIS_FFN_FUSED": "force"}
QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force"}
# Above the ViT's stacked LayerNorm weights (2 x 64), which JAX's rule would
# quantize, and at most its smallest linear (attn_out, 2 x 64 x 64): every
# projection, ViT linear and vision_proj int8, every norm float.
VIT_MIN_SIZE = 4096


def _setenv(monkeypatch, *envs):
    for env in envs:
        for key, value in env.items():
            monkeypatch.setenv(key, value)


def _pair(seed, int8=False, **over):
    """(jax config, jax params, port model) on one perturbed f32 tree; with
    ``int8`` both packages quantize it (the ViT too) and attach the int8
    tied head, and the JAX tree gets its fused QKV stack."""
    kw = dict(BASE, **over)
    jcfg, cfg = JaxConfig(**kw), ApertisConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    if not int8:
        return jcfg, jparams, from_jax_params(tree, cfg, device="cpu")
    jparams = attach_qkv_mha(jax_quantize_tied_head(jax_quantize_params(
        jparams, min_size=VIT_MIN_SIZE, quantize_vision=True)))
    model = from_jax_params(quantize_params(jax.tree.map(torch.from_numpy, tree),
                                            min_size=VIT_MIN_SIZE, quantize_vision=True),
                            cfg, device="cpu")
    model.quantize_tied_head()
    model.set_modes("dyn", "fatk")
    assert model.quantized and model.vision.layers[0].quantized
    return jcfg, jparams, model


def _ragged(rng, lens, width, vocab):
    ids = rng.integers(4, vocab, (len(lens), width)).astype(np.int32)
    mask = (np.arange(width)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids * mask, mask


def _images(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err, top = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * top, (what, err, tol * top)


def _dequant(cache, name):
    c = np.asarray(cache[name])
    if name + "_ps" not in cache:
        return c.astype(np.float32)
    s = np.asarray(cache[name + "_ps"])                  # (nl, B, H, L)
    nl, b, l, d = c.shape
    heads = s.shape[2]
    return (c.reshape(nl, b, l, heads, d // heads).astype(np.float32)
            * np.moveaxis(s, 3, 2)[..., None]).reshape(c.shape)


@pytest.mark.parametrize("weights,kv", [("f32", "f32"), ("int8", "int8"), ("int8", "f32")])
def test_prefill_and_decode_with_images_match_jax(weights, kv, monkeypatch):
    """A ragged prefill behind the image prefix, then five decode steps with
    the engine's bookkeeping (slot num_img + W + i, positions num_img + len
    + i, the prefix's slots valid): logits and the whole cache, dequantized
    for int8, after each. The prefix's K/V fill slots [0, 17). f32: 1e-4 of
    the largest value (f32 sums in other orders); int8: 1e-2, since a value
    on a rounding boundary takes the next level where a sum ran in another
    order (as tests/test_torch_mha.py)."""
    _setenv(monkeypatch, MHA_ENV, *((QUANT_ENV,) if weights == "int8" else ()),
            *(({"APERTIS_QUANT_KV": "1"},) if kv == "int8" else ()))
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)
    jcfg, jparams, model = _pair(seed=1, int8=weights == "int8")
    if weights == "int8":
        model.attach_qkv()
    tol = 1e-4 if weights == "f32" else 1e-2
    steps, width = 5, 12
    ids, mask = _ragged(np.random.default_rng(2), [12, 5, 8], width, 256)
    img = _images(3, (3, 40, 48, 3))
    lens = mask.sum(axis=1)
    cache_len = NUM_IMG + width + steps + 1
    jpre = jax_model.prefill(jparams, jcfg, jax_model.init_cache(jcfg, 3, max_length=cache_len),
                             jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                             pixel_values=jnp.asarray(img), logit_positions=jnp.asarray(lens - 1))
    assert jpre.cache["k"].ndim == 4 and ("k_ps" in jpre.cache) == (kv == "int8")
    tpre = model.prefill(model.init_cache(3, max_length=cache_len, kv_int8=kv == "int8"),
                         torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask),
                         logit_positions=torch.as_tensor(lens - 1),
                         pixel_values=torch.as_tensor(img))
    assert tpre.length == NUM_IMG + width == int(jpre.length)
    assert np.abs(_dequant(tpre.cache, "k")[:, :, :NUM_IMG]).max() > 0
    step = jax.jit(lambda p, c, tok, t, row, pos: jax_model.decode_step(
        p, jcfg, c, tok, t, attn_mask_row=row, positions=pos))
    row = np.zeros((3, cache_len), np.int32)
    row[:, :NUM_IMG] = 1
    row[:, NUM_IMG:NUM_IMG + width] = mask
    jl, jc, tl, tc = jpre.logits, jpre.cache, tpre.logits, tpre.cache
    for i in range(steps + 1):
        _close(tl, jl, tol, f"logits, step {i}")
        for name in ("k", "v"):
            assert tc[name].dtype == (torch.int8 if kv == "int8" else torch.float32)
            _close(_dequant(tc, name), _dequant(jc, name), tol, f"{name}, step {i}")
        if i == steps:
            break
        tok = np.asarray(jl).reshape(3, -1).argmax(axis=-1).astype(np.int32)
        t = NUM_IMG + width + i
        row[:, t] = 1
        jl, jc = step(jparams, jc, jnp.asarray(tok), jnp.asarray(t, jnp.int32),
                      jnp.asarray(row), jnp.asarray(NUM_IMG + lens + i))
        tl, tc = model.decode_step(tc, torch.as_tensor(tok, dtype=torch.long), t=t,
                                   attn_mask_row=torch.as_tensor(row),
                                   positions=torch.as_tensor(NUM_IMG + lens + i))


@pytest.mark.parametrize("int8", [False, True])
def test_greedy_generate_with_images_matches_jax_engine(int8, monkeypatch):
    """Token-exact greedy generation with uint8 images through both engines:
    the bucket grown so that prefix and bucket are a multiple of 8 (17 + 39),
    a cache of 17 + 39 + 10 slots, the decode slots and positions past the
    prefix; f32 weights with an f32 cache, and int8 weights, ViT included,
    with the engines' default int8 cache. Row 1 stops early on an EOS id."""
    _setenv(monkeypatch, MHA_ENV, *((QUANT_ENV, {"APERTIS_QUANT_KV": "1"}) if int8 else ()))
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)
    jcfg, jparams, model = _pair(seed=4, int8=int8)
    jax_engine = JaxEngine(jcfg, jparams)
    engine = InferenceEngine(model.config, model, quant_matmul="dyn")
    assert engine.kv_int8 == int8
    ids, mask = _ragged(np.random.default_rng(5), [7, 2, 4], 7, 256)
    img = _images(6, (3, 24, 40, 3))
    kw = dict(max_new_tokens=10, eos_token_id=())
    free = engine.generate(ids, attention_mask=mask, pixel_values=img, **kw)
    kw["eos_token_id"] = (int(free[1, 12]),)
    ref = jax_engine.generate(ids, attention_mask=mask, pixel_values=img,
                              rng=jax.random.PRNGKey(0), **kw)
    got = engine.generate(ids, attention_mask=mask, pixel_values=img, **kw)
    assert got.shape == ref.shape and got.shape[0] == 3
    np.testing.assert_array_equal(got, ref)
    assert (got[1, 13:] == model.config.pad_token_id).all()


def test_maskless_forward_with_images_takes_flash(monkeypatch):
    """A multimodal MHA ``forward`` without a mask stays causal over prefix
    and text and goes to the flash path where ``flash_eligible`` holds at
    num_img + L (JAX's ``mask_was_none``): 111 text tokens behind 17 image
    tokens are 128 positions, one flash call a layer, logits within 1e-5 of
    JAX's forward. A mask, or text too short for 128 positions in all, takes
    the plain attention."""
    import apertis_llm_torch.ops.kernels.flash_attention as port_flash
    calls = []
    for name in ("flash_attention_fwd", "flash_attention_fwd_f32"):
        real = getattr(port_flash, name)
        monkeypatch.setattr(port_flash, name,
                            lambda *a, _f=real, **k: calls.append(1) or _f(*a, **k))
    jcfg, jparams, model = _pair(seed=7, use_flash_attention=True)
    ids = np.random.default_rng(8).integers(4, 256, (2, 111)).astype(np.int32)
    img = _images(9, (2, 32, 32, 3))
    ref = jax_model.forward(jparams, jcfg, jnp.asarray(ids), pixel_values=jnp.asarray(img)).logits
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long), pixel_values=torch.as_tensor(img))
        assert len(calls) == model.config.num_hidden_layers
        _close(got, ref, 1e-5)
        masked = model(torch.as_tensor(ids, dtype=torch.long),
                       torch.ones((2, 111), dtype=torch.int32), pixel_values=torch.as_tensor(img))
        model(torch.as_tensor(ids[:, :110], dtype=torch.long), pixel_values=torch.as_tensor(img))
    assert len(calls) == model.config.num_hidden_layers
    _close(masked, ref, 1e-5)
