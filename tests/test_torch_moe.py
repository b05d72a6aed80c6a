"""The port's MoE FFN vs the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs its MoE serving arithmetic: the int8 fat stack (``attach_fused_
decode_params(mode="fat")``, as its engine attaches it), the fat kernel at
small token counts and the grouped kernel above them
(``APERTIS_MOE_GROUPED=force``), and the mixer step's moe epilogue at decode
(``APERTIS_SSM_STEP=force``), its Pallas kernels in interpret mode. The port
has that one arithmetic. The TPU kernels' GELU is a tanh-form erf (|err| <=
3.7e-5, there because Mosaic has no erf) that flips an int8 hidden level now
and then; where GELU runs, the JAX kernels are given the exact GELU the port
computes (``moe_ffn._KERNEL_ACTS``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.moe_fuse import attach_fused_decode_params
from apertis_llm_tpu.models.moe_fuse import fuse_moe_decode_params_fat as jax_fuse_fat
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.quantize import quantize_tied_head as jax_quantize_tied_head
from apertis_llm_tpu.models.quantize import quantize_weight as jax_quantize_weight
from apertis_llm_tpu.models.ssm_fuse import attach_fused_ssm_params
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops import moe as jax_moe
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_tpu.ops.pallas.moe_grouped import expert_ffn_grouped as jax_ffn_grouped
from apertis_llm_tpu.ops.pallas.ssm_step import ssm_decode_step_fused
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.factory import calculate_model_dimensions
from apertis_llm_torch.models.moe_fuse import fuse_moe_decode_params_fat
from apertis_llm_torch.models.params import (
    check_supported, count_params, init_params, quantized_layout)
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops import moe as torch_moe
from apertis_llm_torch.ops.kernels.moe_ffn import (
    expert_ffn_fat, expert_ffn_fat_reference, fat_block_n)
from apertis_llm_torch.ops.kernels.moe_grouped import (
    TILE, expert_ffn_grouped, expert_ffn_grouped_reference)
from apertis_llm_torch.ops.kernels.ssm_step import (
    MixerWeights, RouterWeights, ssm_decode_step, ssm_decode_step_int8)

torch.set_num_threads(2)

MOE = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=8,
           intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
           max_position_embeddings=128, decode_max_length=64,
           use_expert_system=True, num_experts=4, experts_per_token=2)
SERVE_ENV = {"APERTIS_MOE_GROUPED": "force", "APERTIS_SSM_STEP": "force",
             "APERTIS_MOE_FUSED": "fatk"}
QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force",
             "APERTIS_FFN_FUSED": "force"}


@pytest.fixture
def exact_gelu(monkeypatch):
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)


def _t(x):
    """JAX array -> torch tensor of the same values and kind (bf16, int8,
    int32 or f32)."""
    if x.dtype in (jnp.int8, jnp.int32):
        return torch.from_numpy(np.array(x))
    arr = np.asarray(jnp.asarray(x, jnp.float32)).copy()
    return torch.from_numpy(arr).to(torch.bfloat16 if x.dtype == jnp.bfloat16
                                    else torch.float32)


def _assert_int8_close(q, q_ref, name):
    """int8 outputs: at most one level apart on under 1e-3 of the elements
    (tests/test_pallas_kernels.py:270)."""
    dq = np.abs(np.asarray(q).astype(int) - np.asarray(q_ref).astype(int))
    assert dq.max() <= 1 and (dq > 0).mean() < 1e-3, (name, dq.max(), (dq > 0).mean())


def _router_inputs(seed, s=37, h=64, e=8, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, h)).astype(np.float32)
    ln_w = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
    ln_b = (0.1 * rng.normal(size=h)).astype(np.float32)
    rw = (0.3 * rng.normal(size=(h, e))).astype(np.float32)
    rb = (0.1 * rng.normal(size=e)).astype(np.float32)
    if tie:   # experts 3 and 5 share their router column
        rw[:, 5], rb[5] = rw[:, 3], rb[3]
    return x, ln_w, ln_b, rw, rb


@pytest.mark.parametrize("tie", [False, True])
def test_route_matches_jax(tie):
    """route, _top_k_gates and _combine_weights: identical expert indices,
    weights and combine matrices within 1e-6 (the softmax's f32 sums are
    taken in another order)."""
    args = _router_inputs(0, tie=tie)
    ref = jax_moe.route(*(jnp.asarray(a) for a in args), 2, layer_norm_eps=1e-12)
    got = torch_moe.route(*(torch.from_numpy(a) for a in args), 2, layer_norm_eps=1e-12)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights), atol=1e-6)
    assert float(got.lb_loss) == float(got.rz_loss) == 0.0
    for k in (1, 2, 3, 8):
        gates = np.random.default_rng(k).dirichlet(np.ones(8), size=9).astype(np.float32)
        if tie:   # experts 3 and 5 tie above all others: the first index wins
            gates[:, 5] = gates[:, 3] = 1.0
        w_ref, i_ref = jax_moe._top_k_gates(jnp.asarray(gates), k)   # lax.top_k for k > 2
        w, i = torch_moe._top_k_gates(torch.from_numpy(gates), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)
        if tie:
            assert (i[:, 0] == 3).all() and (k == 1 or (i[:, 1] == 5).all())
    comb_ref = jax_moe._combine_weights(ref, 8, jnp.float32)
    comb = torch_moe._combine_weights(got, 8, torch.float32)
    np.testing.assert_allclose(comb.numpy(), np.asarray(comb_ref), atol=1e-6)


def _expert_stack(seed, layers=2, e=4, h=64, inter=256, unit_affine=False):
    rng = np.random.default_rng(seed)
    stack = {
        "ln_w": 1 + 0.1 * rng.normal(size=(layers, e, h)),
        "ln_b": 0.1 * rng.normal(size=(layers, e, h)),
        "w1": 0.05 * rng.normal(size=(layers, e, h, inter)),
        "b1": 0.02 * rng.normal(size=(layers, e, inter)),
        "w2": 0.05 * rng.normal(size=(layers, e, inter, h)),
        "b2": 0.02 * rng.normal(size=(layers, e, h)),
    }
    if unit_affine:
        stack["ln_w"], stack["ln_b"] = np.ones((layers, e, h)), np.zeros((layers, e, h))
    return {k: jnp.asarray(v, jnp.float32) for k, v in stack.items()}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("unit_affine", [True, False])
def test_fat_stack_matches_jax(int8, unit_affine):
    """fuse_moe_decode_params_fat on one f32 or int8 expert stack: bit-equal
    with unit LayerNorm affines; with perturbed ones int8 levels at most one
    apart on under 1e-3 of the elements, scales within 1e-6 relative and the
    folded bias within 1e-6 of its largest value (ln_b @ W1 is an f32 sum
    taken in another order)."""
    stack = _expert_stack(1, unit_affine=unit_affine)
    if int8:
        for key in ("w1", "w2"):
            stack[key + "_q"], stack[key + "_s"] = jax_quantize_weight(stack.pop(key))
    ref = jax_fuse_fat(stack, bits=8)
    got = fuse_moe_decode_params_fat({k: _t(v) for k, v in stack.items()})
    assert set(got) == set(ref) == {"w1t_q", "w1t_s", "b1t", "w2t_q", "w2t_s"}
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, key
        if unit_affine:
            np.testing.assert_array_equal(g, r, err_msg=key)
        elif key.endswith("_q"):
            _assert_int8_close(g, r, key)
        elif key == "b1t":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6 * np.abs(r).max(), err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=key)


def _fat_inputs(seed, s, inter, e=4, h=64):
    """One layer's fat stack (JAX-built) and a routed, centred and quantized
    token batch, as JAX arrays."""
    stack = _expert_stack(seed, layers=1, e=e, h=h, inter=inter)
    fat = {k: v[0] for k, v in jax_fuse_fat(stack, bits=8).items()}
    x, ln_w, ln_b, rw, rb = _router_inputs(seed + 1, s=s, h=h, e=e)
    routing = jax_moe.route(*(jnp.asarray(a) for a in (x, ln_w, ln_b, rw, rb)), 2,
                            layer_norm_eps=1e-12)
    return jnp.asarray(x), routing, fat, stack["b2"][0]


@pytest.mark.parametrize("inter,s,act", [(256, 16, "gelu"), (256, 16, "relu"),
                                         (128, 37, "gelu"), (192, 5, "gelu"),
                                         (256, 5, "relu")])
def test_fat_kernel_matches_jax(inter, s, act, exact_gelu):
    """Plain expert_ffn_fat vs the interpret-mode TPU kernel: I = 256 has two
    hidden tiles of 128 per expert, I = 128 and 192 one tile per expert
    (bn = I), S = 5 and 37 are ragged. With ReLU both sides compute the same
    exact integer products and f32 scalings: 1e-5 of the largest output. With
    GELU an activation computed by another erf can land a hidden value on
    the next int8 level: 2e-3 of it."""
    assert fat_block_n(inter) == {256: 128, 128: 128, 192: 192}[inter]
    x, routing, fat, _ = _fat_inputs(2, s, inter)
    xq, xs = jax_moe_ffn_inputs(x)
    comb = jax_moe._combine_weights(routing, 4, jnp.float32)
    ref = np.asarray(jax_moe_ffn.expert_ffn_fat(
        xq, xs, comb, fat["w1t_q"], fat["w1t_s"], fat["b1t"], fat["w2t_q"], fat["w2t_s"], 4,
        out_dtype=jnp.float32, hidden_act=act))
    got = expert_ffn_fat(*(_t(a) for a in (xq, xs, comb, fat["w1t_q"], fat["w1t_s"],
                                           fat["b1t"], fat["w2t_q"], fat["w2t_s"])), 4, act)
    assert got.dtype == torch.float32 and got.shape == (s, 64)
    tol = 1e-5 if act == "relu" else 2e-3
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()
    assert expert_ffn_fat.launches == 0


def jax_moe_ffn_inputs(x):
    """The JAX glue's centred quantization (ops/moe.py:332-337)."""
    from apertis_llm_tpu.ops.pallas.quant_matmul import quantize_rows

    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    inv = jnp.where(var > 0, jax.lax.rsqrt(var + 1e-12), 0.0)
    xq, xs = quantize_rows(x - mean)
    return xq, xs * inv


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_grouped_kernel_matches_jax(act, exact_gelu):
    """Plain expert_ffn_grouped vs the interpret-mode TPU kernel on rows laid
    out by the port's dispatch, with expert 2 empty: bf16 rows of every live
    tile within one bf16 ulp of the largest (2^-7; with ReLU the f32 values
    agree, so only a rounding on a bf16 boundary could differ), the rows of
    the tiles past the last expert's 0 where the TPU kernel computes them
    for expert E-1."""
    x, _, fat, _ = _fat_inputs(3, 40, 256)
    rng = np.random.default_rng(4)
    idx = np.stack([rng.choice([0, 1, 3], size=2, replace=False) for _ in range(40)])
    dest, emap = torch_moe.grouped_dispatch(torch.from_numpy(idx), 4)
    xq, xs = jax_moe_ffn_inputs(x)
    p = emap.numel() * TILE
    xq_pad = torch.zeros((p, 64), dtype=torch.int8)
    xs_pad = torch.zeros((p, 1))
    xq_pad[dest] = _t(xq).repeat_interleave(2, dim=0)
    xs_pad[dest] = _t(xs).repeat_interleave(2, dim=0)
    live = emap.numpy() >= 0
    assert p == (80 + 4 * TILE) // TILE * TILE and live.sum() == 3 and 2 not in emap.tolist()
    ref = np.asarray(jax_ffn_grouped(
        jnp.asarray(xq_pad.numpy()), jnp.asarray(xs_pad.numpy()),
        jnp.asarray(np.where(live, emap.numpy(), 3)),
        *(fat[k][None] for k in ("w1t_q", "w1t_s", "b1t", "w2t_q", "w2t_s")), 4, 0,
        out_dtype=jnp.bfloat16, hidden_act=act), np.float32)
    got = expert_ffn_grouped(xq_pad, xs_pad, emap, *(_t(fat[k]) for k in (
        "w1t_q", "w1t_s", "b1t", "w2t_q", "w2t_s")), 4, act)
    assert got.dtype == torch.bfloat16 and got.shape == (p, 64)
    rows = np.repeat(live, TILE)
    err = np.abs(got.float().numpy()[rows] - ref[rows]).max()
    assert err <= 2.0 ** -7 * np.abs(ref[rows]).max()
    assert not got[torch.from_numpy(~rows)].any()
    assert expert_ffn_grouped.launches == 0


@pytest.mark.parametrize("glue", ["fat", "grouped"])
def test_prefill_glue_matches_jax(glue, exact_gelu):
    """moe_dense_fat_kernel and moe_grouped_fat (centred quantization,
    dispatch, gather, routing weights, combine @ b2) against the JAX glue on
    the same routed tokens: 1e-3 of the largest output (the centring's mean
    and variance are f32 sums taken in another order, which can move an
    int8 level of x)."""
    x, routing, fat, b2 = _fat_inputs(5, 70, 256)
    if glue == "fat":
        ref = jax_moe.moe_dense_fat_kernel(x, routing, {"b2": b2, "fat": fat}, "gelu", 1e-12)
        fn = torch_moe.moe_dense_fat_kernel
    else:
        stack = {k: v[None] for k, v in fat.items()}
        ref = jax_moe.moe_grouped_fat(x, routing, {"b2": b2}, "gelu", 1e-12, stack, 0)
        fn = torch_moe.moe_grouped_fat
    t_routing = torch_moe.RouterOutput(_t(routing.weights), _t(routing.indices).long(),
                                       None, None)
    got = fn(_t(x), t_routing, {k: _t(v) for k, v in fat.items()}, _t(b2), "gelu", 1e-12)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()


def test_moe_dense_matches_jax_and_bounds_the_int8_paths(exact_gelu):
    """moe_dense, the float all-expert yardstick, against JAX's moe_dense on
    the same f32 experts (1e-5 of the largest output: f32 products summed in
    another order); the port's two int8 paths stay within 5e-2 of it (int8
    rows, experts and hidden, and W2's scale shared across experts)."""
    stack = {k: v[0] for k, v in _expert_stack(12, layers=1).items()}
    x, ln_w, ln_b, rw, rb = _router_inputs(13, s=300, h=64, e=4)
    routing = jax_moe.route(*(jnp.asarray(a) for a in (x, ln_w, ln_b, rw, rb)), 2,
                            layer_norm_eps=1e-12)
    ref = np.asarray(jax_moe.moe_dense(jnp.asarray(x), routing, stack, "gelu", 1e-12))
    t_routing = torch_moe.route(*(torch.from_numpy(a) for a in (x, ln_w, ln_b, rw, rb)), 2,
                                layer_norm_eps=1e-12)
    t_stack = {k: _t(v) for k, v in stack.items()}
    got = torch_moe.moe_dense(torch.from_numpy(x), t_routing, t_stack, "gelu", 1e-12)
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
    fat = fuse_moe_decode_params_fat({k: v[None] for k, v in t_stack.items()})
    fat = {k: v[0] for k, v in fat.items()}
    for path in (torch_moe.moe_dense_fat_kernel, torch_moe.moe_grouped_fat):
        out = path(torch.from_numpy(x), t_routing, fat, t_stack["b2"], "gelu", 1e-12)
        assert np.abs(out.numpy() - ref).max() <= 5e-2 * scale, path.__name__


def _moe_tree(seed, dtype=np.float32, **over):
    """A JAX MoE parameter tree with numpy noise on every leaf, as numpy."""
    cfg = JaxConfig(**dict(MOE, **over))
    rng = np.random.default_rng(seed)
    return cfg, jax.tree.map(
        lambda x: (np.asarray(x, np.float32)
                   + rng.normal(0.0, 0.02, x.shape).astype(np.float32)).astype(dtype),
        jax_init_params(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("layout", ["bf16", "int8"])
@pytest.mark.parametrize("rms", [False, True])
def test_decode_step_moe_epilogue_matches_jax(layout, rms):
    """The plain step's moe epilogue vs ssm_decode_step_fused(ffn_mode="moe")
    in interpret mode, 40 rows: the mixer outputs as in
    tests/test_torch_kernels.py (2e-3 and 2^-7 of the largest value), x_q to
    the int8 tolerance, x_s to one bf16 ulp (the absmax of a bf16-rounded
    row), the combine weights within 1e-3: the f32 FFN input is rounded to
    bf16 before the router reads it, and where that rounding flips (the x_s
    tolerance's reason) a logit moves by 2^-8 of one of its terms. The
    router's norm is a LayerNorm under RMSNorm pre-norms too."""
    cfg, tree = _moe_tree(6, dtype=jnp.bfloat16, use_rmsnorm=rms)
    params = jax.tree.map(jnp.asarray, tree)
    if layout == "int8":
        params = jax_quantize_params(params, min_size=0)
    fused = attach_fused_ssm_params(params, cfg)["layers"]["attn"]["fused"]
    assert ("inx_wq" in fused) == (layout == "int8") and "router_w" in fused
    rng = np.random.default_rng(7)
    b, d, c = 40, cfg.hidden_size, cfg.ssm_d_inner
    h = jnp.asarray(rng.normal(0, 1.0, (b, d)), jnp.bfloat16)
    conv = jnp.asarray(rng.normal(0, 0.5, (b, 3, c)), jnp.bfloat16)
    ssm = jnp.asarray(rng.normal(0, 0.5, (b, c)), jnp.float32)
    ref = ssm_decode_step_fused(h, conv, ssm, fused, 1, cfg.layer_norm_eps, rms,
                                ffn_mode="moe")
    lay = jax.tree.map(lambda v: _t(v[1]), params["layers"])
    a, f = lay["attn"], lay["ffn"]
    pre, pre2 = a["pre_norm"], f["pre_norm"]
    proj = (lambda k: a[k]["w_q"]) if layout == "int8" else (lambda k: a[k]["w"])
    scales = (tuple(a[k]["w_s"] for k in ("in_proj_x", "in_proj_z", "x_param_proj", "out_proj"))
              if layout == "int8" else ())
    w = MixerWeights(pre["scale"] if rms else pre["w"], None if rms else pre["b"],
                     proj("in_proj_x"), proj("in_proj_z"), a["conv"]["w"], a["conv"]["b"],
                     proj("x_param_proj"), a["dt_proj"]["w"], a["dt_proj"]["b"], a["A_log"],
                     a["D"], proj("out_proj"), *scales)
    ffn_norm = (pre2["scale"], None) if rms else (pre2["w"], pre2["b"])
    router = RouterWeights(f["router_ln"]["w"], f["router_ln"]["b"], f["router"]["w"],
                           f["router"]["b"])
    got = ssm_decode_step(_t(h), _t(conv), _t(ssm), w, cfg.layer_norm_eps,
                          ffn_norm=ffn_norm, router=router)
    assert len(got) == len(ref) == 6
    for name, g, r in zip(("h_out", "x_proj", "ssm"), got, ref):
        r = np.asarray(jnp.asarray(r, jnp.float32))
        tol = 2e-3 if name == "ssm" else 2.0 ** -7
        assert np.abs(g.float().numpy() - r).max() <= tol * np.abs(r).max(), name
    assert got[3].dtype == torch.int8 and got[4].shape == (b, 1) and got[5].shape == (b, 4)
    _assert_int8_close(got[3].numpy(), ref[3], "x_q")
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=2.0 ** -7)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), atol=1e-3)
    assert ((got[5] > 0).sum(dim=1) == 2).all()
    assert ssm_decode_step.launches == ssm_decode_step_int8.launches == 0


def _model_pair(monkeypatch, seed, int8, **over):
    """(jax config, JAX params with the fat stack, the mixer's fused pack and,
    int8, the int8 tied head, torch model) on one perturbed f32 tree."""
    for key, value in {**SERVE_ENV, **(QUANT_ENV if int8 else {})}.items():
        monkeypatch.setenv(key, value)
    cfg, tree = _moe_tree(seed, **over)
    jparams = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.from_numpy, tree)
    if int8:
        jparams = jax_quantize_tied_head(jax_quantize_params(jparams, min_size=0))
        ttree = quantize_params(ttree, min_size=0)
    jparams = attach_fused_ssm_params(attach_fused_decode_params(jparams, mode="fat"), cfg)
    model = from_jax_params(ttree, ApertisConfig(**dict(MOE, **over)), device="cpu")
    if int8:
        model.quantize_tied_head()
        model.set_modes("dyn", "fatk")
    model.attach_moe_fat()     # as InferenceEngine attaches it
    assert model.quantized == int8
    return cfg, jparams, model


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("threshold", [256, 8, 2])
def test_prefill_and_decode_logits_match_jax(int8, threshold, monkeypatch, exact_gelu):
    """Ragged prefill of 3 x 16 tokens (48 rows: the fat kernel under the
    default threshold of 256, the grouped kernel under 8 and 2) and six
    decode steps, through the moe epilogue and the fat kernel (3 rows up to
    the threshold; under 2 the step runs without its epilogue and the FFN
    as over full sequences, 3 <= E tokens: the fat kernel), against the JAX
    model on the same weights: logits, and the {conv, ssm} cache after
    prefill, within 1e-2 of their largest value. Every MoE layer quantizes
    x per row and the hidden per tile; where an f32 sum is taken in another
    order a value on a rounding boundary lands on the next int8 level, and
    one such flip moves these logits by up to about 0.5 % of their largest
    value."""
    cfg, jparams, model = _model_pair(monkeypatch, 8, int8,
                                      moe_dense_threshold_tokens=threshold)
    rng = np.random.default_rng(9)
    lens = np.array([16, 9, 3])
    ids = rng.integers(4, cfg.vocab_size, (3, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    jpre = jax_model.prefill(jparams, cfg, jax_model.init_cache(cfg, 3, max_length=64),
                             jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                             logit_positions=jnp.asarray(lens - 1))
    tpre = model.prefill(model.init_cache(3), torch.as_tensor(ids, dtype=torch.long),
                         torch.as_tensor(mask), logit_positions=torch.as_tensor(lens - 1))

    def close(got, ref, name):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-2 * np.abs(ref).max(), name

    close(tpre.logits, jpre.logits, "prefill logits")
    for key in ("conv", "ssm"):
        close(tpre.cache[key], jpre.cache[key], key)
    step = jax.jit(lambda p, c, tok: jax_model.decode_step(
        p, cfg, c, tok, jnp.asarray(0, jnp.int32)))
    jcache, tcache = jpre.cache, tpre.cache
    tok = np.array(jnp.argmax(jpre.logits[:, 0], axis=-1), np.int32)
    for i in range(6):
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tok))
        tlogits, tcache = model.decode_step(tcache, torch.as_tensor(tok, dtype=torch.long))
        close(tlogits, jlogits, f"decode step {i}")
        tok = np.asarray(jlogits).argmax(axis=-1).astype(np.int32)


@pytest.mark.parametrize("threshold", [256, 8])
def test_int8_greedy_generate_matches_jax_engine(threshold, monkeypatch, exact_gelu):
    """Greedy int8 serving through both engines, token-exact: prompts
    bucketed to 32 give 96 prefill rows, through the fat kernel under the
    default threshold and through the grouped kernel under 8; every decode
    step runs the moe epilogue and the fat kernel (3 rows <= 8)."""
    for key, value in {**SERVE_ENV, **QUANT_ENV}.items():
        monkeypatch.setenv(key, value)
    over = dict(moe_dense_threshold_tokens=threshold)
    cfg, tree = _moe_tree(10, **over)
    jax_engine = JaxEngine(cfg, jax_quantize_params(jax.tree.map(jnp.asarray, tree),
                                                    min_size=0))
    assert "fat" in jax_engine.params["layers"]["ffn"]["experts"]
    assert "router_w" in jax_engine.params["layers"]["attn"]["fused"]
    model = from_jax_params(quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
                            ApertisConfig(**dict(MOE, **over)), device="cpu")
    engine = InferenceEngine(ApertisConfig(**dict(MOE, **over)), model, quant_matmul="dyn")
    assert model.lm_head is not None and model.layers[0].ffn.experts.w1t_q is not None
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, prompt in enumerate(([1, 5, 9, 33, 70, 4, 18], [2, 8], [7, 3, 99, 41])):
        batch[row, :len(prompt)] = prompt
        mask[row, :len(prompt)] = 1
    kw = dict(max_new_tokens=8, eos_token_id=())
    ref = jax_engine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    got = engine.generate(batch, attention_mask=mask, **kw)
    assert got.shape == (3, 15)
    np.testing.assert_array_equal(got, ref)


def test_moe_model_dispatch_and_fat_buffers(monkeypatch):
    """Which kernel runs at which token count once the fat stack is attached
    as the engine attaches it, on CPU tensors (plain versions, no launches);
    the fat stack is a non-persistent buffer that follows the expert
    weights, outside the parameters from_jax_params fills; a decode batch
    past the threshold runs the step without its epilogue and the FFN as
    over full sequences."""
    cfg = ApertisConfig(**dict(MOE, moe_dense_threshold_tokens=8))
    model = from_jax_params(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                            cfg, device="cpu")
    experts = model.layers[0].ffn.experts
    assert experts.w1t_q is None and experts.attached_fat() is None
    model.attach_moe_fat()
    names = {n for n, _ in model.named_parameters()}
    assert "layers.0.ffn.w_noise" in names and not any("w1t" in n for n in names)
    assert "layers.0.ffn.experts.w1t_q" not in model.state_dict()
    calls = []
    for name in ("moe_dense_fat_kernel", "moe_grouped_fat"):
        fn = getattr(torch_moe, name)
        monkeypatch.setattr(torch_moe, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    with torch.no_grad():
        model(torch.randint(4, 256, (1, 8)))
        model(torch.randint(4, 256, (1, 9)))
        model.decode_step(model.init_cache(9), torch.randint(4, 256, (9,)))
    assert calls == ["moe_dense_fat_kernel"] * 2 + ["moe_grouped_fat"] * 4
    q = experts.w1t_q
    assert q is not None and q.dtype == torch.int8 and q.shape == (128, 4 * 256)
    with torch.no_grad():
        experts.w1.mul_(2.0)
    assert experts.fat()["w1t_q"] is not q
    assert expert_ffn_fat.launches == expert_ffn_grouped.launches == 0


def test_unsupported_moe_configs_raise_and_preset_is_accepted():
    """top-k other than 2 and MoE with MHA or SwiGLU are accepted; the 1.5B
    MoE preset (hidden 704, which is not a multiple of 128) is accepted in
    int8; widths that are not multiples of 16 are refused, naming
    ROADMAP.md, and a tree whose experts are int8 while the mixer is float
    is refused."""
    for over in (dict(experts_per_token=1), dict(experts_per_token=3),
                 dict(attention_type="standard_mha"), dict(use_swiglu=True)):
        check_supported(ApertisConfig(**dict(MOE, **over)))
    dims = calculate_model_dimensions("1.5B", 32000, use_expert_system=True)
    preset = ApertisConfig(
        vocab_size=32000, attention_type="selective_ssm", ssm_d_state=16,
        hidden_size=dims["hidden_size"], num_hidden_layers=dims["num_hidden_layers"],
        num_attention_heads=dims["num_attention_heads"],
        intermediate_size=dims["intermediate_size"], use_expert_system=True,
        num_experts=8, experts_per_token=2)
    assert (preset.hidden_size, preset.intermediate_size) == (704, 2816)
    check_supported(preset, quantized=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_supported(ApertisConfig(**dict(MOE, hidden_size=120, num_attention_heads=8)),
                        quantized=True)
    tree = init_params(ApertisConfig(**MOE), torch.Generator(), device="cpu")
    assert not quantized_layout(tree)
    assert quantized_layout(quantize_params(tree, min_size=0))
    mixed = quantize_params(tree, min_size=0)
    mixed["layers"]["attn"] = tree["layers"]["attn"]
    with pytest.raises(NotImplementedError):
        quantized_layout(mixed)


@pytest.mark.parametrize("size", ["small", "1.5B"])
def test_moe_init_params_builds_jax_names_and_shapes(size):
    """The MoE tree has the JAX init's names and shapes (the 1.5B preset on
    the meta device: shapes only)."""
    if size == "small":
        kw, device = dict(MOE, use_rmsnorm=True), "cpu"
    else:
        dims = calculate_model_dimensions("1.5B", 32000, use_expert_system=True)
        kw = dict(vocab_size=32000, attention_type="selective_ssm", ssm_d_state=16,
                  hidden_size=dims["hidden_size"], num_hidden_layers=dims["num_hidden_layers"],
                  num_attention_heads=dims["num_attention_heads"],
                  intermediate_size=dims["intermediate_size"], use_expert_system=True,
                  num_experts=8, experts_per_token=2)
        device = "meta"
    ref = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), JaxConfig(**kw)))
    tree = init_params(ApertisConfig(**kw), torch.Generator(), device=device)

    def shapes(t, prefix=""):
        out = {}
        for key, value in t.items():
            if isinstance(value, dict):
                out.update(shapes(value, f"{prefix}{key}/"))
            else:
                out[prefix + key] = tuple(value.shape)
        return out

    assert shapes(tree) == shapes(ref)
    if size == "1.5B":
        assert count_params(tree) == 1_439_851_028
    else:
        experts = tree["layers"]["ffn"]["experts"]
        assert float(experts["ln_w"].min()) == float(experts["ln_w"].max()) == 1.0
        assert not tree["layers"]["ffn"]["w_noise"].any()


def test_moe_wrappers_refuse_non_cuda_devices():
    """A tensor that is not on the CPU goes to the kernel or raises: the meta
    device has no kernel, so both MoE wrappers raise before any launch."""
    i8, f32 = dict(dtype=torch.int8, device="meta"), dict(dtype=torch.float32, device="meta")
    w = (torch.empty((64, 512), **i8), torch.empty((1, 512), **f32),
         torch.empty((512,), **f32), torch.empty((512, 64), **i8), torch.empty((1, 64), **f32))
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_fat(torch.empty((4, 64), **i8), torch.empty((4, 1), **f32),
                       torch.empty((4, 4), **f32), *w, 4)
    with pytest.raises(ValueError, match="CUDA"):
        expert_ffn_grouped(torch.empty((128, 64), **i8), torch.empty((128, 1), **f32),
                           torch.empty((1,), dtype=torch.int32, device="meta"), *w, 4)
    assert expert_ffn_fat.launches == expert_ffn_grouped.launches == 0
    # The plain versions are what CPU tensors get.
    x, routing, fat, _ = _fat_inputs(11, 6, 128)
    xq, xs = jax_moe_ffn_inputs(x)
    args = [_t(a) for a in (xq, xs, jax_moe._combine_weights(routing, 4, jnp.float32),
                            fat["w1t_q"], fat["w1t_s"], fat["b1t"], fat["w2t_q"],
                            fat["w2t_s"])]
    assert torch.equal(expert_ffn_fat(*args, 4), expert_ffn_fat_reference(*args, 4))
    emap = torch.tensor([0, -1], dtype=torch.int32)
    gargs = [torch.zeros((256, 64), dtype=torch.int8), torch.ones((256, 1)), emap] + args[3:]
    assert torch.equal(expert_ffn_grouped(*gargs, 4), expert_ffn_grouped_reference(*gargs, 4))
