"""w4a8 serving of the port vs the JAX package's ``APERTIS_QUANT_BITS=4``,
and the two repairs of this slice (int8 and float at widths that are not
multiples of 128; the dtype in the flash gate), on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs the port's one arithmetic: ``APERTIS_QUANT_MATMUL=dyn``,
``APERTIS_LN_QUANT=force``, ``APERTIS_SSM_STEP=force``,
``APERTIS_FFN_FUSED=force``, for MoE ``APERTIS_MOE_GROUPED=force`` and
``APERTIS_MOE_FUSED=fatk``, for MHA ``APERTIS_MHA_STEP=force`` and
``APERTIS_QUANT_KV=1`` (the port's default int8 KV cache for an int8
model), and ``APERTIS_QUANT_BITS=4`` (all set with
monkeypatch), its Pallas kernels in interpret mode, and its kernels' GELU
given the exact erf the port computes (the TPU kernels' tanh-form erf flips
int8 levels now and then). Off the TPU the JAX MoE FFN takes its XLA fat
GEMMs at small token counts where the TPU takes the fat kernel; the tests
that need the kernel there patch its ``_on_tpu`` test to True (with the
variables above it changes nothing else). On CPU tensors the port's kernel
wrappers take their plain versions.
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
from apertis_llm_tpu.models.moe_fuse import fuse_moe_decode_params_fat as jax_fuse_fat
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops import moe as jax_moe
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_tpu.ops.pallas.ffn_fused import ffn_decode_fused
from apertis_llm_tpu.ops.pallas.quant_matmul import quantize_rows as jax_quantize_rows
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models import apertis as torch_model
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.factory import calculate_model_dimensions
from apertis_llm_torch.models.moe_fuse import fat_bits, fuse_moe_decode_params_fat
from apertis_llm_torch.models.params import count_params, init_params
from apertis_llm_torch.models.quantize import (
    attach_int4_ffn, dequantize_int4, quantize_params, quantize_weight_int4, unpack_int4)
from apertis_llm_torch.ops import attention as attn_ops
from apertis_llm_torch.ops import moe as torch_moe
from apertis_llm_torch.ops.kernels import flash_attention as flash_ops
from apertis_llm_torch.ops.kernels.ffn_fused import (
    ffn_decode_int4, ffn_decode_int4_reference, pick_block_n)
from apertis_llm_torch.ops.kernels.moe_ffn import (
    expert_ffn_fat_int4, expert_ffn_fat_int4_reference, fat_block_n)

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


BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128, decode_max_length=64)
FAMILIES = {"dense": {}, "mha": dict(attention_type="standard_mha"),
            "moe": dict(use_expert_system=True, num_experts=4, experts_per_token=2)}
SERVE_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force",
             "APERTIS_SSM_STEP": "force", "APERTIS_FFN_FUSED": "force",
             "APERTIS_MHA_STEP": "force", "APERTIS_MOE_GROUPED": "force",
             "APERTIS_MOE_FUSED": "fatk", "APERTIS_QUANT_KV": "1"}


@pytest.fixture
def exact_gelu(monkeypatch):
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)


def _t(x):
    """JAX array -> torch tensor of the same values (int8 stays int8)."""
    if x.dtype == jnp.int8:
        return torch.from_numpy(np.array(x))
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _grouped_weight(rng, shape):
    """Weights whose 128-row groups have absmaxes 1 to 30 times apart per
    channel, so that every shift 1, 2, 4 and 8 occurs."""
    *lead, k, n = shape
    w = rng.normal(size=shape)
    spread = 10.0 ** rng.uniform(-1.5, 0.0, size=(*lead, k // 128, 1, n))
    return (w.reshape(*lead, k // 128, 128, n) * spread).reshape(shape).astype(np.float32)


# ---- 1. packing ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 96), (2, 384, 40)])
def test_quantize_weight_int4_is_bit_equal_to_jax(shape):
    """Packed bytes, base scales and shifts equal JAX's, to the bit, plain
    and layer-stacked; the unpacked values and the dequantized weight too."""
    w = _grouped_weight(np.random.default_rng(len(shape)), shape)
    ref = jax_quantize.quantize_weight_int4(jnp.asarray(w))
    got = quantize_weight_int4(torch.from_numpy(w))
    for name, r, g in zip(("w_q4", "w_s", "w_sh"), ref, got):
        assert g.dtype == {"w_q4": torch.int8, "w_s": torch.float32, "w_sh": torch.int8}[name]
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert set(np.unique(got[2].numpy())) == {1, 2, 4, 8}
    for shifts in (None, ref[2]):
        np.testing.assert_array_equal(
            unpack_int4(_t(ref[0]), None if shifts is None else _t(shifts)).numpy(),
            np.asarray(jax_quantize.unpack_int4(ref[0], shifts)))
    np.testing.assert_array_equal(
        dequantize_int4(*(_t(a) for a in ref)).numpy(),
        np.asarray(jax_quantize.dequantize_int4(ref[0], ref[1], ref[2])))
    with pytest.raises(ValueError, match="multiple of 128"):
        quantize_weight_int4(torch.zeros((192, 8)))


def _tree(family, seed=0, **over):
    """A perturbed f32 parameter tree as numpy, with its JAX config and the
    port's. The port's ``init_params`` builds the JAX tree's names, shapes
    and distributions (``tests/test_torch_engine.py``) without JAX's eager
    start-up cost; numpy noise moves every leaf off its init."""
    kw = dict(BASE, **FAMILIES[family], **over)
    cfg = ApertisConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: x.numpy() + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        init_params(cfg, torch.Generator().manual_seed(seed), device="cpu"))
    return JaxConfig(**kw), cfg, tree


def _jax_int8(tree):
    """JAX's quantize_params(min_size=0) of a numpy tree, eagerly: under jit
    XLA turns its divisions by constants into multiplications, which moves
    some scales by an ulp."""
    return jax_quantize.quantize_params(jax.tree.map(jnp.asarray, tree), min_size=0)


def test_attach_int4_ffn_is_bit_equal_to_jax_and_a_no_op_where_jax_is():
    """The tree function and the model method attach JAX's pack to an int8
    dense tree (bit-equal, stacked over layers; non-persistent buffers); no
    pack on a float tree, a MoE tree, or an int8 tree whose hidden size (the
    first FFN contraction) is 192."""
    _, cfg, tree = _tree("dense", 1)
    qtree = quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0)
    ref = jax_quantize.attach_int4_ffn(_jax_int8(tree))
    got = attach_int4_ffn(qtree)
    model = from_jax_params(qtree, cfg, device="cpu")
    assert model.attach_int4_ffn()
    for w in ("w1", "w2"):
        for key in ("w_q4", "w_s", "w_sh", "b"):
            r = np.asarray(ref["layers"]["ffn"]["w4"][w][key])
            np.testing.assert_array_equal(got["layers"]["ffn"]["w4"][w][key].numpy(), r)
        pack = dict(zip(("w1_q4", "w1_sh", "w1_s", "w2_q4", "w2_sh", "w2_s"),
                        model.layers[1].ffn.int4_pack()))
        for key, name in (("w_q4", w + "_q4"), ("w_sh", w + "_sh"), ("w_s", w + "_s")):
            np.testing.assert_array_equal(
                pack[name].numpy(), np.asarray(ref["layers"]["ffn"]["w4"][w][key][1]))
    assert not any("q4" in k for k in model.state_dict())
    assert attach_int4_ffn(got) is got
    for family, over, quant in (("dense", {}, False), ("moe", {}, True),
                                ("dense", dict(hidden_size=192), True)):
        _, cfg_, tree_ = _tree(family, 2, **over)
        t = jax.tree.map(torch.from_numpy, tree_)
        t = quantize_params(t, min_size=0) if quant else t
        j = _jax_int8(tree_) if quant else jax.tree.map(jnp.asarray, tree_)
        assert jax_quantize.attach_int4_ffn(j) is j and attach_int4_ffn(t) is t
        assert not from_jax_params(t, cfg_, device="cpu").attach_int4_ffn()


# ---- 2. the int4 kernels' plain versions ---------------------------------------

@pytest.mark.parametrize("inter", [256, 1536])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_ffn_int4_plain_matches_jax_kernel(inter, act, exact_gelu):
    """ffn_decode_int4 on CPU tensors vs the interpret-mode TPU kernel's int4
    layout (``int4=True``): I = 256 is one hidden tile, I = 1536 two of 768.
    With ReLU both compute the same integer products and f32 scalings: 1e-5
    of the largest output. With GELU (another erf on each side) a hidden
    value can land on the next int8 level: 2e-3 of it."""
    assert pick_block_n(inter) == {256: 256, 1536: 768}[inter]
    rng = np.random.default_rng(inter)
    d = 128
    x = jnp.asarray(0.5 * rng.normal(size=(9, d)), jnp.float32)
    b1 = jnp.asarray(0.02 * rng.normal(size=(inter,)), jnp.float32)
    b2 = jnp.asarray(0.02 * rng.normal(size=(d,)), jnp.float32)
    q1 = jax_quantize.quantize_weight_int4(jnp.asarray(_grouped_weight(rng, (d, inter)) * 0.05))
    q2 = jax_quantize.quantize_weight_int4(jnp.asarray(_grouped_weight(rng, (inter, d)) * 0.05))
    xq, xs = jax_quantize_rows(x)
    ref = np.asarray(ffn_decode_fused(xq, xs, q1[0], q1[1], b1, q2[0], q2[1], b2,
                                      out_dtype=jnp.float32, hidden_act=act, int4=True,
                                      w1_sh=q1[2], w2_sh=q2[2]))
    args = [_t(a) for a in (xq, xs, q1[0], q1[2], q1[1], b1, q2[0], q2[2], q2[1], b2)]
    got = ffn_decode_int4(*args, act, out_dtype=torch.float32)
    tol = 1e-5 if act == "relu" else 2e-3
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()
    assert torch.equal(got, ffn_decode_int4_reference(*args, act, torch.float32))
    assert ffn_decode_int4.launches == 0


def _expert_stack(seed, e=4, h=128, inter=256, unit_affine=False):
    rng = np.random.default_rng(seed)
    stack = {"ln_w": 1 + 0.1 * rng.normal(size=(1, e, h)),
             "ln_b": 0.1 * rng.normal(size=(1, e, h)),
             "w1": 0.05 * rng.normal(size=(1, e, h, inter)),
             "b1": 0.02 * rng.normal(size=(1, e, inter)),
             "w2": 0.05 * rng.normal(size=(1, e, inter, h)),
             "b2": 0.02 * rng.normal(size=(1, e, h))}
    if unit_affine:
        stack["ln_w"], stack["ln_b"] = np.ones((1, e, h)), np.zeros((1, e, h))
    return {k: jnp.asarray(v, jnp.float32) for k, v in stack.items()}


@pytest.mark.parametrize("h,inter,bits", [(128, 256, 4), (128, 192, 8), (64, 256, 8)])
def test_fat_stack_int4_and_its_int8_fallback_match_jax(h, inter, bits):
    """fuse_moe_decode_params_fat(bits=4) on an int8 expert stack with unit
    LayerNorm affines: the int4 fat stack bit-equal to JAX's where H and I
    are multiples of 128, the int8 one where either is not (I = 192, or
    H = 64), as moe_fuse.py:136-142 falls back."""
    assert fat_bits(h, inter, 4) == bits
    stack = _expert_stack(5, h=h, inter=inter, unit_affine=True)
    for key in ("w1", "w2"):
        stack[key + "_q"], stack[key + "_s"] = jax_quantize.quantize_weight(stack.pop(key))
    ref = jax_fuse_fat(stack, bits=4)
    got = fuse_moe_decode_params_fat({k: _t(v) for k, v in stack.items()}, bits=4)
    assert set(got) == set(ref) and ("w1t_q4" in got) == (bits == 4)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)


def _fat_int4_inputs(seed, s):
    stack = _expert_stack(seed)
    fat = {k: v[0] for k, v in jax_fuse_fat(stack, bits=4).items()}
    rng = np.random.default_rng(seed + 1)
    x = jnp.asarray(rng.normal(size=(s, 128)), jnp.float32)
    router = [jnp.asarray(a, jnp.float32) for a in (
        1 + 0.1 * rng.normal(size=128), 0.1 * rng.normal(size=128),
        0.3 * rng.normal(size=(128, 4)), 0.1 * rng.normal(size=4))]
    routing = jax_moe.route(x, *router, 2, layer_norm_eps=1e-12)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    xq, xs = jax_quantize_rows(x - mean)
    xs = xs * jnp.where(var > 0, jax.lax.rsqrt(var + 1e-12), 0.0)
    return xq, xs, jax_moe._combine_weights(routing, 4, jnp.float32), fat, stack, x, routing


@pytest.mark.parametrize("s,act", [(16, "gelu"), (37, "relu")])
def test_fat_int4_plain_matches_jax_kernel(s, act, exact_gelu):
    """expert_ffn_fat_int4 on CPU tensors vs the interpret-mode TPU kernel's
    int4 layout: I = 256 gives two hidden tiles of 128 per expert; the
    tolerances of the int8 layout's test (1e-5 with ReLU, 2e-3 with GELU)."""
    assert fat_block_n(256) == 128
    xq, xs, comb, fat, *_ = _fat_int4_inputs(7, s)
    ref = np.asarray(jax_moe_ffn.expert_ffn_fat(
        xq, xs, comb, fat["w1t_q4"], fat["w1t_s"], fat["b1t"], fat["w2t_q4"], fat["w2t_s"], 4,
        out_dtype=jnp.float32, hidden_act=act, int4=True, w1t_sh=fat["w1t_sh"],
        w2t_sh=fat["w2t_sh"]))
    args = [_t(a) for a in (xq, xs, comb, fat["w1t_q4"], fat["w1t_sh"], fat["w1t_s"],
                            fat["b1t"], fat["w2t_q4"], fat["w2t_sh"], fat["w2t_s"])]
    got = expert_ffn_fat_int4(*args, 4, act)
    tol = 1e-5 if act == "relu" else 2e-3
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()
    assert torch.equal(got, expert_ffn_fat_int4_reference(*args, 4, act))
    assert expert_ffn_fat_int4.launches == 0


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_moe_ragged_matches_jax(int8, act, monkeypatch):
    """moe_ragged over 37 tokens (f32) vs JAX's: the int8 branch under
    ``APERTIS_QUANT_MATMUL=dyn`` for int8 experts, the float branch for f32
    ones. With ReLU the int8 branch computes the same integer products and
    f32 scalings and the float one the same f32 products in another order:
    1e-5 of the largest output. With GELU the int8 hidden is requantized
    from values another erf computed: 2e-3."""
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "dyn")
    *_, stack, x, routing = _fat_int4_inputs(8, 37)
    experts = {k: v[0] for k, v in stack.items()}
    if int8:
        for key in ("w1", "w2"):
            experts[key + "_q"], experts[key + "_s"] = jax_quantize.quantize_weight(
                experts.pop(key))
    ref = np.asarray(jax.jit(jax_moe.moe_ragged, static_argnums=(3, 4))(
        x, routing, experts, act, 1e-12))
    t_routing = torch_moe.RouterOutput(torch.from_numpy(np.asarray(routing.weights)),
                                       torch.from_numpy(np.asarray(routing.indices)).long(),
                                       torch.zeros(()), torch.zeros(()))
    got = torch_moe.moe_ragged(_t(x), t_routing, {k: _t(v) for k, v in experts.items()}, act,
                               1e-12)
    tol = 1e-5 if act == "relu" else 2e-3
    assert got.shape == (37, 128)
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


# ---- 3. the three models under quant_bits=4 ------------------------------------------

def _engines(family, monkeypatch, seed, quant_bits=4, on_tpu=False, **over):
    """The JAX engine under APERTIS_QUANT_BITS and the port's engine with
    ``quant_bits``, on one int8 tree (each package quantizes the same f32
    weights with min_size=0)."""
    for key, value in dict(SERVE_ENV, APERTIS_QUANT_BITS=str(quant_bits)).items():
        monkeypatch.setenv(key, value)
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)
    if on_tpu:
        monkeypatch.setattr(jax_model, "_on_tpu", lambda: True)
    jcfg, cfg, tree = _tree(family, seed, **over)
    jengine = JaxEngine(jcfg, _jax_int8(tree))
    model = from_jax_params(quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
                            cfg, device="cpu")
    return jengine, InferenceEngine(cfg, model, quant_bits=quant_bits, quant_matmul="dyn")


def _ragged_batch():
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, prompt in enumerate(([1, 5, 9, 33, 70, 4, 18], [2, 8], [7, 3, 99, 41])):
        batch[row, :len(prompt)] = prompt
        mask[row, :len(prompt)] = 1
    return batch, mask


def _decode_both(jengine, engine, steps=4):
    """Ragged prefill of the bucketed prompts, then ``steps`` greedy decode
    steps with the engines' bookkeeping; yields both logits after each."""
    jcfg, model = jengine.config, engine.model
    batch, mask = _ragged_batch()
    ids, mask = np.pad(batch, ((0, 0), (0, 25))), np.pad(mask, ((0, 0), (0, 25)))
    lens = mask.sum(axis=1)
    mha = jcfg.attention_type == "standard_mha"
    width = ids.shape[1] + steps + 1
    jcache = jax_model.init_cache(jcfg, 3, max_length=width)   # int8 K/V: APERTIS_QUANT_KV
    jpre = jax_model.prefill(jengine.params, jcfg, jcache, jnp.asarray(ids),
                             attention_mask=jnp.asarray(mask),
                             logit_positions=jnp.asarray(lens - 1))
    tcache = (model.init_cache(3, max_length=width, kv_int8=engine.kv_int8) if mha
              else model.init_cache(3))
    tpre = model.prefill(tcache, torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask),
                         logit_positions=torch.as_tensor(lens - 1))
    yield tpre.logits, jpre.logits
    row = np.zeros((3, width), np.int32)
    row[:, :ids.shape[1]] = mask
    step = jax.jit(lambda p, c, tok, t, r, pos: jax_model.decode_step(
        p, jcfg, c, tok, t, attn_mask_row=r if mha else None, positions=pos if mha else None))
    jc, tc = jpre.cache, tpre.cache
    tok = np.array(jnp.argmax(jpre.logits[:, 0], axis=-1), np.int32)
    for i in range(steps):
        t = ids.shape[1] + i
        row[:, t] = 1
        jl, jc = step(jengine.params, jc, jnp.asarray(tok), jnp.asarray(t, jnp.int32),
                      jnp.asarray(row), jnp.asarray(lens + i))
        if mha:
            tl, tc = model.decode_step(tc, torch.as_tensor(tok, dtype=torch.long), t=t,
                                       attn_mask_row=torch.as_tensor(row),
                                       positions=torch.as_tensor(lens + i))
        else:
            tl, tc = model.decode_step(tc, torch.as_tensor(tok, dtype=torch.long))
        yield tl, jl
        tok = np.asarray(jl).argmax(axis=-1).astype(np.int32)


def _check_attached(family, jengine, engine):
    """Both engines attached their w4a8 decode copies."""
    model = engine.model
    if family == "moe":
        assert "w1t_q4" in jengine.params["layers"]["ffn"]["experts"]["fat"]
        assert model.layers[0].ffn.experts.w1t_q4 is not None
    else:
        assert "w4" in jengine.params["layers"]["ffn"]
        assert model.layers[0].ffn.int4_pack() is not None


@pytest.mark.parametrize("family", ["dense", "mha", "moe"])
def test_w4a8_prefill_and_decode_logits_match_jax(family, monkeypatch):
    """Prefill (int8, w8a8) and four decode steps (int4 FFN or int4 fat
    stack) of both engines' models on ragged prompts: the logits within 1e-2
    of the largest, the int8 decode tests' tolerance (a value on a rounding
    boundary lands on the next int8 level where an f32 sum was taken in
    another order). The MoE prefill of 96 tokens runs the int4 fat kernel
    (the JAX side's TPU dispatch, see the module docstring)."""
    jengine, engine = _engines(family, monkeypatch, seed=3, on_tpu=family == "moe")
    _check_attached(family, jengine, engine)
    for i, (tl, jl) in enumerate(_decode_both(jengine, engine)):
        ref = np.asarray(jl, np.float32)
        assert np.abs(tl.numpy() - ref).max() <= 1e-2 * np.abs(ref).max(), f"step {i}"


@pytest.mark.parametrize("family,threshold", [("dense", 256), ("mha", 256), ("moe", 256),
                                              ("moe", 8)])
def test_w4a8_greedy_generate_matches_jax_engine(family, threshold, monkeypatch):
    """Token-exact greedy w4a8 generation through both engines on ragged
    prompts (bucket 32, 96 prefill rows): dense and MHA decode their FFN
    through the int4 pack; the MoE model prefills through the int4 fat
    kernel under the default threshold and through ``moe_ragged`` under 8,
    and decodes through the int4 fat kernel."""
    jengine, engine = _engines(family, monkeypatch, seed=4, on_tpu=threshold == 256,
                               moe_dense_threshold_tokens=threshold)
    _check_attached(family, jengine, engine)
    calls = []
    real = torch_moe.moe_ragged
    monkeypatch.setattr(torch_moe, "moe_ragged", lambda *a: calls.append(1) or real(*a))
    batch, mask = _ragged_batch()
    kw = dict(max_new_tokens=8, eos_token_id=())
    ref = jengine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    got = engine.generate(batch, attention_mask=mask, **kw)
    assert got.shape == (3, 15)
    np.testing.assert_array_equal(got, ref)
    assert len(calls) == (2 if (family, threshold) == ("moe", 8) else 0)


def test_quant_bits_gates_and_the_moe_presets():
    """quant_bits=4 takes a float model too, as the JAX engine does, and
    attaches no int4 pack to its dense FFN (``tests/test_torch_moe_kernel_
    mode.py`` holds float trees under quant_bits=4 against the JAX engine);
    3 is refused. The 3B MoE preset (hidden 768, 74 layers, 12 heads, experts
    of 3072; 2,860,979,480 parameters in the tree, 2,993,253,888 by the
    factory's count) packs its fat stacks to int4, the 1.5B one (hidden 704)
    stays int8."""
    _, cfg, tree = _tree("dense", 5)
    engine = InferenceEngine(cfg, from_jax_params(tree, cfg, device="cpu"), quant_bits=4)
    assert engine.model.layers[0].ffn.int4_pack() is None
    with pytest.raises(ValueError):
        InferenceEngine(cfg, from_jax_params(tree, cfg, device="cpu"), quant_bits=3)
    dims = calculate_model_dimensions("3B", 32000, use_expert_system=True)
    assert (dims["hidden_size"], dims["num_hidden_layers"], dims["num_attention_heads"],
            dims["intermediate_size"]) == (768, 74, 12, 3072)
    preset = ApertisConfig(vocab_size=32000, attention_type="selective_ssm", ssm_d_state=16,
                           hidden_size=768, num_hidden_layers=74, num_attention_heads=12,
                           intermediate_size=3072, use_expert_system=True, num_experts=8,
                           experts_per_token=2)
    n = count_params(init_params(preset, torch.Generator(), device="meta"))
    assert n == 2_860_979_480
    assert fat_bits(768, 3072, 4) == 4 and fat_block_n(3072) == 128
    assert fat_bits(704, 2816, 4) == 8


# ---- 4. repairs --------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["f32", "int8", "int8 w4"])
def test_width_192_matches_jax_without_the_fused_ffn(weights, monkeypatch):
    """Hidden 192 (a multiple of 64, not of 128) fails the fused FFN's width
    test in both packages: the mixer step runs without its FFN epilogue and
    the FFN through the plain norm and its two linears (w8a8 in int8), so
    the decode FFN kernel is never called; under quant_bits=4 no int4 pack
    is attached (the contraction is not a multiple of 128). Logits within
    1e-4 (f32) or 1e-2 (int8) of the largest, greedy tokens exact."""
    over = dict(hidden_size=192, intermediate_size=384)
    bits = 4 if weights == "int8 w4" else 8
    if weights == "f32":
        for key, value in SERVE_ENV.items():
            monkeypatch.setenv(key, value)
        jcfg, cfg, tree = _tree("dense", 6, **over)
        jengine = JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree))
        engine = InferenceEngine(cfg, from_jax_params(tree, cfg, device="cpu"))
    else:
        jengine, engine = _engines("dense", monkeypatch, 6, quant_bits=bits, **over)
        assert "w4" not in jengine.params["layers"]["ffn"]
        assert engine.model.layers[0].ffn.int4_pack() is None
    assert not engine.model.layers[0].ffn.fused_decode
    calls = []
    for name in ("ffn_decode", "ffn_decode_int8", "ffn_decode_int4"):
        monkeypatch.setattr(torch_model, name, lambda *a, _n=name: calls.append(_n))
    tol = 1e-4 if weights == "f32" else 1e-2
    for i, (tl, jl) in enumerate(_decode_both(jengine, engine)):
        ref = np.asarray(jl, np.float32)
        assert np.abs(tl.numpy() - ref).max() <= tol * np.abs(ref).max(), f"step {i}"
    batch, mask = _ragged_batch()
    kw = dict(max_new_tokens=8, eos_token_id=())
    ref = jengine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    np.testing.assert_array_equal(engine.generate(batch, attention_mask=mask, **kw), ref)
    assert calls == []


def test_flash_gate_takes_the_dtype_on_the_card():
    """The flash gate holds for f32 and bf16 alike from 128 positions on (the
    card has f32 and bf16 kernels), not under 128; the dtype picks the
    kernels: FlashAttention runs the f32 wrappers for f32 q and the bf16
    ones otherwise."""
    cfg = ApertisConfig(**dict(BASE, attention_type="standard_mha", use_flash_attention=True))
    gate = torch_model.flash_eligible
    assert gate(cfg, 256) and gate(cfg, 128) and not gate(cfg, 64)
    assert not gate(cfg.replace(use_flash_attention=False), 256)
    assert flash_ops._kernels(torch.float32) == (
        flash_ops.flash_attention_fwd_f32, flash_ops.flash_attention_dq_f32,
        flash_ops.flash_attention_dkv_f32)
    assert flash_ops._kernels(torch.bfloat16) == (
        flash_ops.flash_attention_fwd, flash_ops.flash_attention_dq,
        flash_ops.flash_attention_dkv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_routes_by_dtype_as_on_the_card(dtype, monkeypatch):
    """An MHA forward() without a mask runs the flash attention in every
    layer and the plain attention never, through the forward wrapper of its
    dtype: the f32 kernel's for f32, the bf16 kernel's for bf16."""
    _, cfg, tree = _tree("mha", 7, use_flash_attention=True)
    model = from_jax_params(tree, cfg, device="cpu", dtype=getattr(torch, dtype))
    calls = []
    for name in ("flash_attention_fwd", "flash_attention_fwd_f32"):
        real = getattr(flash_ops, name)
        monkeypatch.setattr(flash_ops, name,
                            lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    real_mha = attn_ops.mha
    monkeypatch.setattr(attn_ops, "mha", lambda *a, **k: calls.append("plain") or
                        real_mha(*a, **k))
    with torch.no_grad():
        logits = model(torch.randint(4, 131, (2, 128)))
    assert torch.isfinite(logits.float()).all()
    expected = "flash_attention_fwd_f32" if dtype == "float32" else "flash_attention_fwd"
    assert calls == [expected] * cfg.num_hidden_layers
