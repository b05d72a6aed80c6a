"""The model variants the port serves beside its presets, against the JAX
package on the CPU: MHA with a MoE FFN, SwiGLU with either mixer, absolute
positions with an untied head (either mixer, and MHA behind the image
prefix), top-1 and top-3 MoE, and MHA at head widths 48 and 320, which the
decode-attention kernel does not take.

One numpy f32 tree (perturbed off its 0/1 init) goes into both packages;
int8 cases quantize it with each package's ``quantize_params(min_size=0)``.
The JAX side serves through its engine's attachments (``InferenceEngine``'s
params: the fat MoE stack, the SSM decode pack, the int8 head, the fused
QKV) under the one int8 arithmetic the port runs everywhere, ``dyn``
(``APERTIS_QUANT_MATMUL=dyn``, ``APERTIS_LN_QUANT=force``), with the fused
decode kernels forced on (``APERTIS_SSM_STEP``, ``APERTIS_FFN_FUSED``,
``APERTIS_MOE_GROUPED`` and, where the flat cache is 128-lane aligned,
``APERTIS_MHA_STEP``), which off the TPU run in interpret mode; the JAX MoE
kernels are given the exact GELU the port computes. At the head widths 48
and 320 JAX keeps its head-major cache and XLA's attention, the path the
port's plain decode attention follows; its cache is compared in the port's
flat layout. On the CPU the port's kernel wrappers take their plain
versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models import convert as jax_convert
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_tpu.training import step as jax_step
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import (
    from_jax_params, infer_config_from_state_dict, load_pretrained, load_torch_state_dict,
    params_tree, save_torch_checkpoint)
from apertis_llm_torch.models.params import init_params
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops.kernels import mha_step
from apertis_llm_torch.training import step as port_step

torch.set_num_threads(2)

BASE = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, ssm_d_state=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, max_position_embeddings=64)
MOE = dict(use_expert_system=True, num_experts=4, experts_per_token=2, intermediate_size=128)
VIT = dict(multimodal=True, image_size=32, vision_patch_size=8, vision_embed_dim=48,
           vision_layers=2, vision_heads=4)
ABS = dict(position_embedding_type="absolute", tie_word_embeddings=False)
VARIANTS = {
    "mha_moe": dict(attention_type="standard_mha", **MOE),
    "swiglu_ssm": dict(attention_type="selective_ssm", use_swiglu=True, intermediate_size=384),
    "swiglu_mha": dict(attention_type="standard_mha", use_swiglu=True, intermediate_size=384),
    "abs_untied_ssm": dict(attention_type="selective_ssm", **ABS),
    "abs_untied_mha": dict(attention_type="standard_mha", **ABS),
    "abs_untied_mha_images": dict(attention_type="standard_mha", **ABS, **VIT),
    "top1": dict(attention_type="selective_ssm", **dict(MOE, experts_per_token=1)),
    "top3": dict(attention_type="selective_ssm", **dict(MOE, experts_per_token=3)),
    "mha_dh48": dict(attention_type="standard_mha", hidden_size=192),
    "mha_dh320": dict(attention_type="standard_mha", hidden_size=640, num_attention_heads=2),
}
SERVE_ENV = {"APERTIS_SSM_STEP": "force", "APERTIS_FFN_FUSED": "force",
             "APERTIS_MOE_GROUPED": "force", "APERTIS_MOE_FUSED": "fatk"}
QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force"}
# f32 weights: 1e-4 of the largest value (f32 sums in other orders through
# two layers and the decode steps). int8 weights: every layer quantizes rows
# and hiddens, and a value on a rounding boundary lands on the next level
# where an f32 sum was taken in another order: 1e-2 of the largest value,
# as the other int8 model tests state it.
F32_TOL, INT8_TOL = 1e-4, 1e-2
# The train step, f32 on both sides (tests/test_torch_training.py's
# tolerances): the loss to a relative 1e-5, each gradient leaf within 1e-4
# of its largest element.
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture
def exact_gelu(monkeypatch):
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)


def _tree(variant, seed=0):
    """(JAX config, port config, perturbed numpy f32 tree)."""
    kw = dict(BASE, **VARIANTS[variant])
    jcfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, ApertisConfig(**kw), tree


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{what}: {err:.3e} vs max {np.abs(ref).max():.3e}"


def _flat_cache(cache, name):
    """A K or V cache as the port's flat (nl, B, L, H * Dh) f32 values:
    dequantized where int8, JAX's head-major (nl, B, H, L, Dh) moved."""
    c = np.asarray(cache[name], np.float32)
    if c.ndim == 5:
        c = np.moveaxis(c, 2, 3).reshape(*c.shape[:2], c.shape[3], -1)
    scales = cache.get(name + "_ps")
    if scales is not None:                                  # (nl, B, H, L)
        s = np.moveaxis(np.asarray(scales), 3, 2)
        nl, b, l, d = c.shape
        c = (c.reshape(nl, b, l, s.shape[-1], -1) * s[..., None]).reshape(nl, b, l, d)
    return c


def _serve_pair(variant, int8, monkeypatch):
    """(JAX config, the JAX engine's attached params, the port model with
    the port engine's attachments under ``quant_matmul="dyn"``)."""
    jcfg, cfg, tree = _tree(variant)
    env = dict(SERVE_ENV, **(QUANT_ENV if int8 else {}))
    if cfg.attention_type == "standard_mha" and mha_step.kernel_takes(cfg.head_dim):
        env["APERTIS_MHA_STEP"] = "force"
    if int8 and cfg.attention_type == "standard_mha":
        env["APERTIS_QUANT_KV"] = "1"
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jparams = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.from_numpy, tree)
    if int8:
        jparams = jax_quantize_params(jparams, min_size=0)
        ttree = quantize_params(ttree, min_size=0)
    model = from_jax_params(ttree, cfg, device="cpu")
    InferenceEngine(cfg, model, quant_matmul="dyn")
    assert model.quantized == int8
    return jcfg, JaxEngine(jcfg, jparams).params, model


@pytest.mark.parametrize("variant,int8", [
    *((v, False) for v in VARIANTS), ("mha_moe", True), ("swiglu_ssm", True),
    ("abs_untied_mha", True)])
def test_variant_serves_as_jax(variant, int8, monkeypatch, exact_gelu):
    """Ragged prefill (three prompts of a 12-wide bucket; for the image
    variant behind a 17-token prefix) and four decode steps with the
    engine's bookkeeping (slot t = prefix + width + i, positions = prefix +
    len + i): logits and the caches after prefill and after each step, and
    the greedy token of every step, against JAX's ``prefill`` and
    ``decode_step`` on the attached params. f32 within F32_TOL, int8 within
    INT8_TOL; the greedy tokens equal."""
    jcfg, jparams, model = _serve_pair(variant, int8, monkeypatch)
    tol = INT8_TOL if int8 else F32_TOL
    rng = np.random.default_rng(9)
    lens = np.array([12, 5, 8])
    ids = rng.integers(4, jcfg.vocab_size, (3, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    num_img = jcfg.num_image_tokens if jcfg.multimodal else 0
    img = (rng.integers(0, 256, (3, 40, 48, 3)).astype(np.uint8) if num_img else None)
    mha = jcfg.attention_type == "standard_mha"
    steps = 4
    cache_len = num_img + 12 + steps + 1
    jpix = {"pixel_values": jnp.asarray(img)} if num_img else {}
    tpix = {"pixel_values": torch.as_tensor(img)} if num_img else {}
    jpre = jax_model.prefill(jparams, jcfg, jax_model.init_cache(jcfg, 3, max_length=cache_len),
                             jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                             logit_positions=jnp.asarray(lens - 1), **jpix)
    cache_kw = dict(max_length=cache_len, kv_int8=int8) if mha else {}
    tpre = model.prefill(model.init_cache(3, **cache_kw), torch.as_tensor(ids, dtype=torch.long),
                         torch.as_tensor(mask), logit_positions=torch.as_tensor(lens - 1),
                         **tpix)
    names = ("k", "v") if mha else ("conv", "ssm")

    def check(tl, jl, tc, jc, what):
        _close(tl, jl, tol, f"{variant} logits, {what}")
        np.testing.assert_array_equal(np.asarray(tl).argmax(-1), np.asarray(jl).argmax(-1))
        for name in names:
            got = _flat_cache(tc, name) if mha else tc[name].numpy()
            ref = _flat_cache(jc, name) if mha else np.asarray(jc[name])
            _close(got, ref, tol, f"{variant} cache {name}, {what}")

    check(tpre.logits[:, 0], jpre.logits[:, 0], tpre.cache, jpre.cache, "prefill")
    step = jax.jit(lambda p, c, tok, t, row, pos: jax_model.decode_step(
        p, jcfg, c, tok, t, attn_mask_row=row, positions=pos))
    row = np.zeros((3, cache_len), np.int32)
    row[:, :num_img] = 1
    row[:, num_img:num_img + 12] = mask
    jcache, tcache = jpre.cache, tpre.cache
    tok = np.array(jnp.argmax(jpre.logits[:, 0], axis=-1), np.int32)
    for i in range(steps):
        t = num_img + 12 + i
        row[:, t] = 1
        pos = num_img + lens + i
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.asarray(t, jnp.int32),
                               jnp.asarray(row), jnp.asarray(pos))
        tlogits, tcache = model.decode_step(tcache, torch.as_tensor(tok, dtype=torch.long),
                                            t=t, attn_mask_row=torch.as_tensor(row),
                                            positions=torch.as_tensor(pos))
        check(tlogits, jlogits, tcache, jcache, f"decode step {i}")
        tok = np.asarray(jlogits).argmax(axis=-1).astype(np.int32)


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "abs_untied_mha_images"])
def test_variant_train_step_matches_jax(variant):
    """One f32 train step of each text variant: the loss (with a MoE
    model's load-balancing and router z-losses) and every parameter's
    gradient against JAX's ``loss_fn`` under ``rng=None`` (no dropout, no
    routing noise), the MoE variants through ``moe_dispatch`` with its
    capacity, as training runs them. Without rotary positions the key
    bias adds the same score to every key of a query, which the softmax
    cancels: its gradient is zero in exact arithmetic, so both sides' must
    be below 1e-6 of the tree's largest gradient instead."""
    jcfg, cfg, tree = _tree(variant, seed=3)
    ids = np.random.default_rng(4).integers(4, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = ids.copy()
    labels[:, -3:] = -100
    (jloss, _), jgrads = jax.value_and_grad(jax_step.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}, None)
    model = from_jax_params(tree, cfg, device="cpu")
    params = dict(model.named_parameters())
    loss, _ = port_step.loss_fn(model, {"input_ids": torch.as_tensor(ids, dtype=torch.long),
                                        "labels": torch.as_tensor(labels, dtype=torch.long)},
                                None)
    grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    largest = max(float(np.abs(np.asarray(leaf)).max()) for leaf in jax.tree.leaves(jgrads))
    for name, g in zip(params, grads):
        parts = name.split(".")
        node = jgrads["layers"] if parts[0] == "layers" else jgrads
        for key in parts[2:] if parts[0] == "layers" else parts:
            node = node[key]
        ref = np.asarray(node)[int(parts[1])] if parts[0] == "layers" else np.asarray(node)
        if name.endswith("attn.k.b") and cfg.position_embedding_type != "rotary":
            assert max(np.abs(ref).max(), g.abs().max()) <= 1e-6 * largest, name
            continue
        _close(g.numpy(), ref, GRAD_TOL, f"{variant} gradient {name}")


@pytest.mark.parametrize("mixer", ["selective_ssm", "standard_mha"])
def test_swiglu_absolute_untied_checkpoint_round_trip(mixer, tmp_path):
    """A SwiGLU model with absolute positions and an untied head written in
    the reference's format by the port: the same state dict JAX's
    ``to_torch_state_dict`` writes for the same tree; JAX's
    ``load_pretrained`` of the directory reads the tree back and its
    forward gives the port's logits (1e-5); the port's ``load_pretrained``
    reads it back from the directory and from the bare weights file, whose
    configuration it infers (absolute positions and their count, the untied
    head, SwiGLU's width), with bit-equal logits."""
    # Heads of 64: the width a bare file's MHA configuration infers.
    kw = dict(BASE, attention_type=mixer, use_swiglu=True, intermediate_size=384, **ABS,
              num_attention_heads=2 if mixer == "standard_mha" else 4)
    cfg = ApertisConfig(**kw)
    tree = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    model = from_jax_params(tree, cfg, device="cpu")
    save_torch_checkpoint(params_tree(model), cfg, tmp_path)
    sd = load_torch_state_dict(tmp_path / "pytorch_model.bin")
    jsd = jax_convert.to_torch_state_dict(jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree),
                                          JaxConfig(**kw))
    assert set(sd) == set(jsd) and "model.abs_pos_embeddings.weight" in sd
    for key, value in jsd.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
    ids = np.random.default_rng(6).integers(4, cfg.vocab_size, (2, 9))
    with torch.no_grad():
        ref = model(torch.as_tensor(ids))
    jcfg, jparams = jax_convert.load_pretrained(tmp_path)
    assert "lm_head" in jparams and "abs_pos" in jparams
    _close(jax_model.forward(jparams, jcfg, jnp.asarray(ids)).logits, ref.numpy(), 1e-5,
           "JAX forward of the written checkpoint")
    bare = infer_config_from_state_dict(sd)
    assert (bare.position_embedding_type, bare.max_position_embeddings) == ("absolute", 64)
    assert not bare.tie_word_embeddings and bare.use_swiglu
    assert bare.swiglu_ffn_dim == cfg.swiglu_ffn_dim
    for path in (tmp_path, tmp_path / "pytorch_model.bin"):
        loaded = load_pretrained(path, device="cpu")
        with torch.no_grad():
            assert torch.equal(loaded(torch.as_tensor(ids)), ref), path
