"""The port's MoE FFN under ``moe_mode="kernel"`` vs the JAX package's
``APERTIS_MOE_FUSED=kernel``, and w4a8 serving of float trees, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Under
``kernel`` both engines attach the per-expert stack
(``models/moe_fuse.py::fuse_moe_decode_params``) in place of the fat stack;
the MoE FFN runs the per-expert kernel (``expert_ffn_dense``, #11) up to
``max(E, moe_dense_threshold_tokens)`` tokens and ``moe_ragged`` above, and
the decode step runs the mixer without its FFN epilogue. The JAX side runs
with ``APERTIS_MOE_FUSED=kernel``, ``APERTIS_MOE_GROUPED=force`` and
``APERTIS_SSM_STEP=force`` (and, for int8, ``APERTIS_QUANT_MATMUL``,
``APERTIS_LN_QUANT=force``, ``APERTIS_FFN_FUSED=force``), set by
monkeypatch; its per-expert kernel interprets itself off the TPU, and its
kernels are given the exact GELU the port computes (the TPU kernels'
tanh-form erf flips int8 levels now and then). On CPU tensors the port's
kernel wrappers take their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models import quantize as jax_quantize
from apertis_llm_tpu.models.moe_fuse import fuse_moe_decode_params as jax_fuse
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops import moe as jax_moe
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_tpu.ops.pallas.quant_matmul import quantize_rows as jax_quantize_rows
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.moe_fuse import fuse_moe_decode_params
from apertis_llm_torch.models.params import init_params
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops import moe as torch_moe
from apertis_llm_torch.ops.kernels import moe_ffn as torch_moe_ffn
from apertis_llm_torch.ops.kernels.moe_ffn import expert_ffn_dense, expert_ffn_dense_reference

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _drop_traces_of_other_settings():
    """This file's tests set ``APERTIS_*`` variables and patch ``_on_tpu``,
    which choose the paths JAX traces; JAX caches those traces by function
    and static arguments, not by the settings, so a later file's test with
    an equal config would reuse them (in one serial process
    ``tests/test_torch_moe.py`` then ran other int8 paths than its own).
    Clear JAX's caches once this file's tests are done."""
    yield
    jax.clear_caches()


BASE = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=8,
            intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128, decode_max_length=64)
MOE = dict(use_expert_system=True, num_experts=4, experts_per_token=2)
FAMILIES = {"dense": {}, "mha": dict(attention_type="standard_mha", num_attention_heads=4),
            "moe": MOE}
KERNEL_ENV = {"APERTIS_MOE_FUSED": "kernel", "APERTIS_MOE_GROUPED": "force",
              "APERTIS_SSM_STEP": "force"}
QUANT_ENV = {"APERTIS_LN_QUANT": "force", "APERTIS_FFN_FUSED": "force"}


@pytest.fixture
def exact_gelu(monkeypatch):
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)


def _t(x):
    """JAX array -> torch tensor of the same values (int8 stays int8, bf16
    stays bf16, the rest f32)."""
    if x.dtype == jnp.int8:
        return torch.from_numpy(np.array(x))
    arr = np.array(jnp.asarray(x, jnp.float32))
    return torch.from_numpy(arr).to(torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)


def _experts(seed, layers=1, e=4, h=64, inter=256):
    """A perturbed f32 expert stack (numpy-made) with a leading layer axis."""
    rng = np.random.default_rng(seed)
    stack = {"ln_w": 1 + 0.1 * rng.normal(size=(layers, e, h)),
             "ln_b": 0.1 * rng.normal(size=(layers, e, h)),
             "w1": 0.05 * rng.normal(size=(layers, e, h, inter)),
             "b1": 0.02 * rng.normal(size=(layers, e, inter)),
             "w2": 0.05 * rng.normal(size=(layers, e, inter, h)),
             "b2": 0.02 * rng.normal(size=(layers, e, h))}
    return {k: jnp.asarray(v, jnp.float32) for k, v in stack.items()}


@pytest.mark.parametrize("int8", [False, True])
def test_fused_stack_is_bit_equal_to_jax(int8):
    """fuse_moe_decode_params on one f32 and one int8 expert stack (two
    layers, perturbed LayerNorm affines) against JAX's, run eagerly: the
    int8 leaves and the scales bit-equal, the folded bias ``b1 + ln_b @ W1``
    within 1e-6 of its largest value (an f32 sum taken in another order)."""
    stack = _experts(1, layers=2)
    if int8:
        for key in ("w1", "w2"):
            stack[key + "_q"], stack[key + "_s"] = jax_quantize.quantize_weight(stack.pop(key))
    ref = jax_fuse(stack)
    got = fuse_moe_decode_params({k: _t(v) for k, v in stack.items()})
    assert set(got) == set(ref) == {"w1f_q", "w1f_s", "b1f", "w2f_q", "w2f_s"}
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, key
        if key == "b1f":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6 * np.abs(r).max(), err_msg=key)
        else:
            np.testing.assert_array_equal(g, r, err_msg=key)


def _dense_inputs(seed, s, inter, h=64, e=4):
    """One layer's per-expert stack (JAX-built) and centred, quantized rows,
    as JAX arrays (the glue of ops/moe.py::moe_dense_fused)."""
    fused = {k: v[0] for k, v in jax_fuse(_experts(seed, h=h, e=e, inter=inter)).items()}
    x = jnp.asarray(np.random.default_rng(seed + 1).normal(size=(s, h)), jnp.float32)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    inv = jnp.where(var > 0, jax.lax.rsqrt(var + 1e-12), 0.0)
    xq, xs = jax_quantize_rows(x - mean)
    b2 = jnp.asarray(0.02 * np.random.default_rng(seed + 2).normal(size=(e, h)), jnp.float32)
    return (xq, xs * inv, fused["w1f_q"], fused["w1f_s"], fused["b1f"], fused["w2f_q"],
            fused["w2f_s"], b2)


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("s,inter", [(37, 256), (16, 192), (5, 128)])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_expert_ffn_dense_plain_version_matches_jax_kernel(act, s, inter, out, exact_gelu):
    """expert_ffn_dense on CPU tensors (#11's plain version) against the
    interpret-mode TPU kernel, (E, S, H) out, at S = 37 (not a multiple of
    32: the TPU kernel pads its row block), 16 and 5, I = 256, 192 and 128.
    Both sides compute the same exact integer products and the same f32
    scalings in the same order, except that the CPU interpreter contracts
    each epilogue's ``(acc * s) * w_s + b`` into one fused multiply-add,
    where the TPU kernel, the CUDA kernel and the plain version round the
    product and the sum apart (with GELU, also another erf). So a hidden
    value on a rounding boundary can land on the next int8 level, which
    moves its (expert, row)'s outputs by up to one level of the hidden times
    W2, about 3e-3 of the largest here: every output within 1e-2 of the
    largest, and at most 2 % of the (expert, row) rows more than 1e-5 of the
    largest apart (bf16: more than one bf16 ulp of it, 2^-7)."""
    args = _dense_inputs(4, s, inter)
    ref = np.asarray(jnp.asarray(jax_moe_ffn.expert_ffn_dense(
        *args, out_dtype=jnp.dtype(out), hidden_act=act), jnp.float32))
    got = expert_ffn_dense(*(_t(a) for a in args), getattr(torch, out), act)
    assert got.dtype == getattr(torch, out) and got.shape == (4, s, 64)
    err, scale = np.abs(got.float().numpy() - ref), np.abs(ref).max()
    assert err.max() <= 1e-2 * scale
    assert (err.max(axis=-1) > (2.0 ** -7 if out == "bfloat16" else 1e-5) * scale).mean() <= 0.02
    assert expert_ffn_dense.launches == 0


def test_expert_ffn_dense_requantizes_over_the_whole_hidden():
    """The plain version quantizes each row's hidden with one scale over all
    of I (not per tile): a row whose hidden has one large column keeps its
    small columns at a coarse level, and the wrapper refuses a tensor that
    is neither on the CPU nor on the card before any launch."""
    args = [_t(a) for a in _dense_inputs(5, 3, 256)]
    w1q = torch.zeros_like(args[2])
    w1q[:, 0, :] = 1
    b1 = torch.zeros_like(args[4])
    b1[:, 255] = 1000.0
    w2q = torch.zeros_like(args[5])
    w2q[:, torch.arange(63), torch.arange(63)] = 1
    w2q[:, 255, 63] = 1
    y = expert_ffn_dense_reference(torch.ones_like(args[0]), torch.full_like(args[1], 0.01), w1q,
                                   torch.ones_like(args[3]), b1, w2q, torch.ones_like(args[6]),
                                   torch.zeros_like(args[7]), torch.float32, "relu")
    # Hidden 0.01 in columns 0-254 and 1000.01 in column 255: one scale
    # 1000.01/127 over the row rounds 0.01 to level 0, where a scale per
    # 128-column tile would keep it at level 127.
    assert y.shape == (4, 3, 64) and not y[:, :, :63].any()
    np.testing.assert_allclose(y[:, :, 63].numpy(), 1000.01, rtol=1e-6)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_dense(*(a.to(**meta) for a in args), torch.float32, "gelu")
    assert expert_ffn_dense.launches == 0


def _tree(family, seed, **over):
    """A perturbed f32 tree as numpy, with its JAX config and the port's."""
    kw = dict(BASE, **FAMILIES[family], **over)
    cfg = ApertisConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: x.numpy() + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        init_params(cfg, torch.Generator().manual_seed(seed), device="cpu"))
    return JaxConfig(**kw), cfg, tree


def _kernel_engines(monkeypatch, seed, int8, quant_matmul="dyn", **over):
    """The JAX engine under APERTIS_MOE_FUSED=kernel and the port's engine
    with moe_mode="kernel" on one f32 or int8 MoE tree (each package
    quantizes the same f32 weights with min_size=0, JAX's eagerly)."""
    env = dict(KERNEL_ENV, **(dict(QUANT_ENV, APERTIS_QUANT_MATMUL=quant_matmul) if int8 else {}))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jcfg, cfg, tree = _tree("moe", seed, **over)
    jparams = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.from_numpy, tree)
    if int8:
        jparams = jax_quantize.quantize_params(jparams, min_size=0)
        ttree = quantize_params(ttree, min_size=0)
    jengine = JaxEngine(jcfg, jparams)
    experts = jengine.params["layers"]["ffn"]["experts"]
    assert "fused" in experts and "fat" not in experts
    engine = InferenceEngine(cfg, from_jax_params(ttree, cfg, device="cpu"),
                             quant_matmul=quant_matmul, moe_mode="kernel")
    return jengine, engine


def _ragged_batch():
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, prompt in enumerate(([1, 5, 9, 33, 70, 4, 18], [2, 8], [7, 3, 99, 41])):
        batch[row, :len(prompt)] = prompt
        mask[row, :len(prompt)] = 1
    return batch, mask


@pytest.mark.parametrize("int8,threshold,quant_matmul", [
    (False, 256, "dyn"), (True, 256, "dyn"), (False, 8, "dyn"), (True, 8, "dyn"),
    (True, 8, "fused")])
def test_kernel_mode_logits_and_tokens_match_jax(int8, threshold, quant_matmul, monkeypatch,
                                                 exact_gelu):
    """A 2-layer top-2-of-4 MoE model, f32 or int8, under moe_mode="kernel"
    against the JAX engine under APERTIS_MOE_FUSED=kernel: ragged prefill of
    3 x 32 tokens (96 rows: the per-expert kernel under the default
    threshold of 256; ``moe_ragged`` under 8, int8 under dyn and dequantized
    under fused) and decode steps of 3 rows (the mixer step without its FFN
    epilogue, then the per-expert kernel). Prefill and four decode steps'
    logits within 1e-2 of the largest (a value on an int8 rounding boundary
    lands on the next level where an f32 sum was taken in another order, and
    JAX builds its per-expert stack under jit, whose divisions by 127 become
    multiplies), then greedy generation token-exact; the port's kernel and
    ``moe_ragged`` calls are counted."""
    jengine, engine = _kernel_engines(monkeypatch, 11, int8, quant_matmul,
                                      moe_dense_threshold_tokens=threshold)
    calls = []
    for name in ("moe_dense_fused", "moe_ragged", "moe_dense_fat_kernel", "moe_grouped_fat"):
        real = getattr(torch_moe, name)
        monkeypatch.setattr(torch_moe, name, lambda *a, _n=name, _f=real: (calls.append(_n),
                                                                            _f(*a))[1])
    jcfg, model = jengine.config, engine.model
    batch, mask = _ragged_batch()
    ids, mask32 = np.pad(batch, ((0, 0), (0, 25))), np.pad(mask, ((0, 0), (0, 25)))
    lens = mask32.sum(axis=1)
    jpre = jax_model.prefill(jengine.params, jcfg, jax_model.init_cache(jcfg, 3),
                             jnp.asarray(ids), attention_mask=jnp.asarray(mask32),
                             logit_positions=jnp.asarray(lens - 1))
    tpre = model.prefill(model.init_cache(3), torch.as_tensor(ids, dtype=torch.long),
                         torch.as_tensor(mask32), logit_positions=torch.as_tensor(lens - 1))

    def close(got, ref, name):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got.numpy() - ref).max() <= 1e-2 * np.abs(ref).max(), name

    close(tpre.logits, jpre.logits, "prefill logits")
    step = jax.jit(lambda p, c, tok: jax_model.decode_step(
        p, jcfg, c, tok, jnp.asarray(0, jnp.int32)))
    jc, tc = jpre.cache, tpre.cache
    tok = np.array(jnp.argmax(jpre.logits[:, 0], axis=-1), np.int32)
    for i in range(4):
        jl, jc = step(jengine.params, jc, jnp.asarray(tok))
        tl, tc = model.decode_step(tc, torch.as_tensor(tok, dtype=torch.long))
        close(tl, jl, f"decode step {i}")
        tok = np.asarray(jl).argmax(axis=-1).astype(np.int32)
    nl = jcfg.num_hidden_layers
    first = "moe_dense_fused" if threshold == 256 else "moe_ragged"
    assert calls == [first] * nl + ["moe_dense_fused"] * nl * 4
    kw = dict(max_new_tokens=8, eos_token_id=())
    ref = jengine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    got = engine.generate(batch, attention_mask=mask, **kw)
    assert got.shape == (3, 15)
    np.testing.assert_array_equal(got, ref)


def test_kernel_mode_buffers_and_launch_counts(monkeypatch):
    """Under moe_mode="kernel" the engine builds the per-expert stack in
    non-persistent buffers and no fat stack; one generate of 3 tokens calls
    the per-expert kernel's wrapper once per layer at prefill and at each of
    the two decode steps, and never the fat, grouped or decode-step moe
    epilogue paths; quant_bits=4 changes nothing for it (the int4 packing
    is the fat stack's), and the default engine keeps building the fat
    stack."""
    cfg = ApertisConfig(**dict(BASE, **MOE))
    tree = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    model = from_jax_params(quantize_params(tree, min_size=0), cfg, device="cpu")
    engine = InferenceEngine(cfg, model, moe_mode="kernel", quant_bits=4)
    experts = model.layers[0].ffn.experts
    assert experts.w1t_q is None and experts.w1t_q4 is None and experts.w1f_q is not None
    assert experts.w1f_q.shape == (4, 128, 256) and experts.w2f_s.shape == (4, 1, 128)
    assert "layers.0.ffn.experts.w1f_q" not in model.state_dict()
    counts = {}
    for name in ("expert_ffn_dense", "expert_ffn_fat", "expert_ffn_grouped"):
        real = getattr(torch_moe, name)
        monkeypatch.setattr(torch_moe, name, lambda *a, _n=name, _f=real: (
            counts.__setitem__(_n, counts.get(_n, 0) + 1), _f(*a))[1])
    ids = np.random.default_rng(3).integers(4, 256, (2, 5)).astype(np.int32)
    engine.generate(ids, max_new_tokens=3, eos_token_id=())
    assert counts == {"expert_ffn_dense": 3 * cfg.num_hidden_layers}
    assert torch_moe_ffn.expert_ffn_dense.launches == 0
    InferenceEngine(cfg, model)
    assert experts.w1t_q is not None and model.layers[0].ffn.moe_mode == "fatk"


@pytest.mark.parametrize("family", ["dense", "mha", "moe"])
def test_quant_bits_4_on_float_trees_matches_jax(family, monkeypatch, exact_gelu):
    """w4a8 serving of a float tree, which the engine used to refuse: the
    JAX engine under APERTIS_QUANT_BITS=4 packs a float MoE tree's fat
    stacks to int4 (H = 128 and I = 256 are multiples of 128) and attaches
    nothing to a dense or MHA float tree; the port's engine with
    quant_bits=4 does the same, and its greedy tokens equal JAX's (the MoE
    decode through the int4 fat kernel, which the JAX side takes on the TPU
    only: ``_on_tpu`` is patched to True, which with these settings changes
    nothing else for a float tree)."""
    env = {"APERTIS_QUANT_BITS": "4", "APERTIS_SSM_STEP": "force", "APERTIS_FFN_FUSED": "force",
           "APERTIS_MHA_STEP": "force", "APERTIS_MOE_GROUPED": "force",
           "APERTIS_MOE_FUSED": "fatk"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if family == "moe":
        monkeypatch.setattr(jax_model, "_on_tpu", lambda: True)
    jcfg, cfg, tree = _tree(family, 12)
    jengine = JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree))
    engine = InferenceEngine(cfg, from_jax_params(tree, cfg, device="cpu"), quant_bits=4)
    ffn, layer0 = jengine.params["layers"]["ffn"], engine.model.layers[0].ffn
    if family == "moe":
        assert "w1t_q4" in ffn["experts"]["fat"] and layer0.experts.w1t_q4 is not None
    else:
        assert "w4" not in ffn and layer0.int4_pack() is None
    batch, mask = _ragged_batch()
    kw = dict(max_new_tokens=6, eos_token_id=())
    ref = jengine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    got = engine.generate(batch, attention_mask=mask, **kw)
    np.testing.assert_array_equal(got, ref)
