"""``InferenceEngine.stream`` and ``dtype=`` against the JAX engine, and the
f32 forms' plain versions against the JAX kernels in f32.

Greedy ``stream`` must give the JAX engine's ``stream`` tokens, and the
port's ``generate`` tokens up to the EOS, for 2-layer dense selective-SSM,
MoE and MHA models in f32 and int8, and a multimodal one with an image. The
JAX side runs its fused decode paths, as the other engine tests set them
(``APERTIS_SSM_STEP``, ``APERTIS_FFN_FUSED``, ``APERTIS_MHA_STEP`` forced;
int8: ``APERTIS_QUANT_MATMUL=dyn``, ``APERTIS_LN_QUANT=force``; MoE:
``APERTIS_MOE_GROUPED=force``, ``APERTIS_MOE_FUSED=fatk``), with the exact
GELU in its kernels. The decode kernels' f32 forms serve f32 trees on the
card; their plain versions, which the CPU runs, are held here against the
JAX kernels in interpret mode on f32 packs where tests/test_torch_kernels.py
and tests/test_torch_mha.py do not hold them already (those cover #4 with
f32 weights, #4 int8 with f32 biases and output, and #9 in f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.ssm_fuse import attach_fused_ssm_params
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_tpu.ops.pallas.ssm_step import ssm_decode_step_fused
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine, cast_model
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops.kernels import ffn_fused, ln_quant, mha_step, ssm_step
from apertis_llm_torch.ops.kernels.ssm_step import MixerWeights, RouterWeights

torch.set_num_threads(2)

SSM = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
           max_position_embeddings=128, decode_max_length=64)
MOE = dict(SSM, vocab_size=256, num_attention_heads=8, use_expert_system=True, num_experts=4,
           experts_per_token=2)
MHA = dict(SSM, vocab_size=256, attention_type="standard_mha")
MM = dict(SSM, multimodal=True, image_size=32, vision_patch_size=16, vision_embed_dim=64,
          vision_layers=1, vision_heads=2)
KINDS = {"dense": SSM, "moe": MOE, "mha": MHA}
SERVE_ENV = {"APERTIS_SSM_STEP": "force", "APERTIS_FFN_FUSED": "force",
             "APERTIS_MHA_STEP": "force", "APERTIS_MOE_GROUPED": "force",
             "APERTIS_MOE_FUSED": "fatk"}
QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force",
             "APERTIS_QUANT_KV": "1"}


@pytest.fixture()
def serving(monkeypatch):
    """The JAX engine's fused decode paths with the exact GELU in its
    kernels; returns a function that adds the int8 variables."""
    for key, value in SERVE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)

    def int8():
        for key, value in QUANT_ENV.items():
            monkeypatch.setenv(key, value)
    return int8


def _tree(kw, seed):
    """A perturbed f32 JAX tree (numpy) of config ``kw``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), JaxConfig(**kw)))


def _engines(kw, seed, int8=False, dtype=None):
    """The JAX and the port's engine on one tree; with ``int8`` each package
    quantizes it (``min_size=0``)."""
    tree = _tree(kw, seed)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.from_numpy, tree)
    if int8:
        jtree = jax_quantize_params(jtree, min_size=0)
        ttree = quantize_params(ttree, min_size=0)
    config = ApertisConfig(**kw)
    model = from_jax_params(ttree, config, device="cpu")
    return (JaxEngine(JaxConfig(**kw), jtree, dtype=dtype),
            InferenceEngine(config, model, quant_matmul="dyn", dtype=dtype))


PROMPT = np.array([[1, 5, 9, 33, 70, 4, 18, 2, 8]], np.int32)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind", ["dense", "moe", "mha"])
def test_greedy_stream_matches_jax_stream_and_generate(kind, int8, serving):
    """Ten greedy tokens of ``stream`` equal the JAX engine's ``stream`` and
    the port's ``generate``; then with one of them as the EOS id the stream
    stops at it, and with ``min_new_tokens`` past it runs on as JAX's does."""
    if int8:
        serving()
    jax_engine, engine = _engines(KINDS[kind], seed=3, int8=int8)
    kw = dict(max_new_tokens=10, eos_token_id=())
    free = list(engine.stream(PROMPT, **kw))
    assert free == list(jax_engine.stream(PROMPT, rng=jax.random.PRNGKey(0), **kw))
    assert free == engine.generate(PROMPT, **kw)[0, PROMPT.shape[1]:].tolist()
    eos = free[4]
    stop = free.index(eos) + 1
    kw["eos_token_id"] = eos
    assert list(engine.stream(PROMPT, **kw)) == free[:stop]
    kw["min_new_tokens"] = stop + 2
    long = list(engine.stream(PROMPT, **kw))
    assert long == list(jax_engine.stream(PROMPT, rng=jax.random.PRNGKey(0), **kw))
    assert long[:stop] == free[:stop] and len(long) >= stop + 2


def test_stream_with_an_image_matches_jax(serving):
    """A multimodal selective-SSM model: the image prefix before the prompt,
    the bucket aligned so that prefix and bucket are a multiple of 8."""
    jax_engine, engine = _engines(MM, seed=5)
    image = np.random.default_rng(6).integers(0, 256, (1, 40, 48, 3)).astype(np.uint8)
    kw = dict(max_new_tokens=6, eos_token_id=())
    got = list(engine.stream(PROMPT, pixel_values=image, **kw))
    assert got == list(jax_engine.stream(PROMPT, pixel_values=image,
                                         rng=jax.random.PRNGKey(0), **kw))
    assert got == engine.generate(PROMPT, pixel_values=image, **kw)[0, PROMPT.shape[1]:].tolist()


def test_stream_repetition_penalty_and_sampling(serving):
    """The penalty reads the prompt and the streamed tokens (the device-side
    history) as ``generate``'s does; sampling draws from the generator, so
    one seed gives one stream."""
    jax_engine, engine = _engines(SSM, seed=4)
    kw = dict(max_new_tokens=8, eos_token_id=(), repetition_penalty=1.8)
    got = list(engine.stream(PROMPT, **kw))
    assert got == list(jax_engine.stream(PROMPT, rng=jax.random.PRNGKey(0), **kw))
    assert got == engine.generate(PROMPT, **kw)[0, PROMPT.shape[1]:].tolist()
    kw = dict(max_new_tokens=8, eos_token_id=(), do_sample=True, temperature=1.3, top_k=20)
    runs = [list(engine.stream(PROMPT, generator=torch.Generator().manual_seed(s), **kw))
            for s in (1, 1, 2)]
    assert runs[0] == runs[1] and len(runs[0]) == 8
    with pytest.raises(ValueError, match="one prompt"):
        next(engine.stream(np.concatenate([PROMPT, PROMPT])))


@pytest.mark.parametrize("int8", [False, True])
def test_dtype_casts_every_floating_leaf_as_jax(int8, serving):
    """``dtype="bfloat16"``: every floating parameter takes JAX's cast leaf
    bit for bit, an int8 tree's scales rounded through bf16 and held in f32;
    int8 weights stay; greedy tokens equal the JAX engine's."""
    if int8:
        serving()
    jax_engine, engine = _engines(SSM, seed=7, int8=int8, dtype="bfloat16")
    flat = dict(jax.tree_util.tree_leaves_with_path(jax_engine.params))
    names = {"/".join(str(getattr(k, "key", k)) for k in path): v for path, v in flat.items()}
    checked = 0
    for name, p in engine.model.named_parameters():
        parts = name.split(".")
        if parts[0] != "layers" or parts[-1] not in ("w_s", "w", "b", "A_log", "D"):
            continue
        key = "/".join(["layers", *parts[2:]])
        ref = names.get(key)
        if ref is None:
            continue
        ref = np.asarray(jnp.asarray(ref[int(parts[1])], jnp.float32))
        want = torch.float32 if parts[-1] == "w_s" else torch.bfloat16
        assert p.dtype == want, name
        np.testing.assert_array_equal(p.detach().float().numpy(), ref, err_msg=name)
        checked += 1
    assert checked >= 10 and (not int8 or engine.model.quantized)
    kw = dict(max_new_tokens=6, eos_token_id=())
    ref = jax_engine.generate(PROMPT, rng=jax.random.PRNGKey(0), **kw)
    np.testing.assert_array_equal(engine.generate(PROMPT, **kw), ref)


def test_cast_model_keeps_int8_and_scales():
    """int8 weights stay int8; ``w_s``, ``w1_s``, ``w2_s`` hold their values
    rounded through the dtype in f32; every other float goes to the dtype."""
    tree = quantize_params(jax.tree.map(torch.from_numpy, _tree(MOE, 1)), min_size=0)
    model = from_jax_params(tree, ApertisConfig(**MOE), device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cast_model(model, torch.bfloat16)
    for name, p in model.named_parameters():
        old = before[name]
        if old.dtype == torch.int8:
            assert torch.equal(p, old), name
        elif name.split(".")[-1] in ("w_s", "w1_s", "w2_s"):
            assert p.dtype == torch.float32
            assert torch.equal(p, old.to(torch.bfloat16).float()), name
        else:
            assert p.dtype == torch.bfloat16 and torch.equal(p, old.to(torch.bfloat16)), name


# ---- the f32 forms' plain versions vs the JAX kernels in f32 ------------------

def _t(x):
    if x.dtype == jnp.int8:
        return torch.from_numpy(np.array(x))
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _f32_layer(kw, seed, int8):
    cfg = JaxConfig(**kw)
    params = jax.tree.map(jnp.asarray, _tree(kw, seed))
    if int8:
        params = jax_quantize_params(params, min_size=0)
    return cfg, params, attach_fused_ssm_params(params, cfg)["layers"]["attn"]["fused"]


def _mixer(params, layer, rms, int8):
    a = jax.tree.map(lambda x: x[layer], params["layers"]["attn"])
    pre = a["pre_norm"]
    key = "w_q" if int8 else "w"
    scales = (tuple(_t(a[k]["w_s"]) for k in ("in_proj_x", "in_proj_z", "x_param_proj",
                                             "out_proj")) if int8 else ())
    return MixerWeights(
        _t(pre["scale"] if rms else pre["w"]), None if rms else _t(pre["b"]),
        _t(a["in_proj_x"][key]), _t(a["in_proj_z"][key]), _t(a["conv"]["w"]),
        _t(a["conv"]["b"]), _t(a["x_param_proj"][key]), _t(a["dt_proj"]["w"]),
        _t(a["dt_proj"]["b"]), _t(a["A_log"]), _t(a["D"]), _t(a["out_proj"][key]), *scales)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ffn_mode,rms", [("none", False), ("dense", False), ("dense", True),
                                          ("moe", False)])
def test_f32_decode_step_matches_jax_fused_kernel(ffn_mode, rms, int8):
    """The step on an f32 tree (f32 projections, or int8 ones beside f32
    norms, conv and dt weights, f32 rows and conv cache) vs the interpret-
    mode TPU kernel on the same f32 pack, 6 rows: f32 outputs within 1e-4
    of their largest value (int8: 2^-7, where a row's quantization rounds
    the other way), the FFN input (rounded through bf16 in every layout,
    ssm_step.py:186) within one bf16 ulp, int8 outputs to the JAX package's
    int8 tolerance, the combine weights within 1e-3."""
    kw = dict(MOE if ffn_mode == "moe" else SSM, use_rmsnorm=rms)
    cfg, params, fused = _f32_layer(kw, 13, int8)
    rng = np.random.default_rng(14)
    b, d, c = 6, cfg.hidden_size, cfg.ssm_d_inner
    h = jnp.asarray(rng.normal(0, 1.0, (b, d)), jnp.float32)
    conv = jnp.asarray(rng.normal(0, 0.5, (b, 3, c)), jnp.float32)
    ssm = jnp.asarray(rng.normal(0, 0.5, (b, c)), jnp.float32)
    ref = ssm_decode_step_fused(h, conv, ssm, fused, 1, cfg.layer_norm_eps, rms,
                                ffn_mode=ffn_mode)
    f = jax.tree.map(lambda x: _t(x[1]), params["layers"]["ffn"])
    ffn_norm = router = None
    if ffn_mode != "none":
        pre2 = f["pre_norm"]
        ffn_norm = (pre2["scale"], None) if rms else (pre2["w"], pre2["b"])
    if ffn_mode == "moe":
        router = RouterWeights(f["router_ln"]["w"], f["router_ln"]["b"], f["router"]["w"],
                               f["router"]["b"])
    got = ssm_step.ssm_decode_step(_t(h), _t(conv), _t(ssm), _mixer(params, 1, rms, int8),
                                   cfg.layer_norm_eps, ffn_norm=ffn_norm, router=router)
    assert len(got) == len(ref)
    tol = 2.0 ** -7 if int8 else 1e-4
    for name, g, r in zip(("h_out", "x_proj", "ssm"), got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float32, name
        assert np.abs(g.numpy() - r).max() <= tol * np.abs(r).max(), name
    if ffn_mode == "dense" and not int8:
        assert got[3].dtype == torch.bfloat16
        r = np.asarray(jnp.asarray(ref[3], jnp.float32))
        assert np.abs(got[3].float().numpy() - r).max() <= 2.0 ** -7 * np.abs(r).max()
    elif ffn_mode != "none":
        dq = np.abs(got[3].numpy().astype(int) - np.asarray(ref[3]).astype(int))
        assert dq.max() <= 1 and (dq > 0).mean() < 1e-2
        np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=2.0 ** -7)
    if ffn_mode == "moe":
        np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), atol=1e-3)
    assert ssm_step.ssm_decode_step_f32.launches == ssm_step.ssm_decode_step_int8_f32.launches == 0


def test_f32_forms_take_plain_path_on_cpu():
    """Every f32 form runs its plain version on CPU tensors and counts no
    launch; the Hopper layouts' test (all bf16) decides which form a card
    step takes."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=g)
    w = torch.ones(64)
    q, s = ln_quant.ln_quantize(x, w, torch.zeros(64), 1e-5)
    q2, s2 = ln_quant.ln_quantize_f32(x, w, torch.zeros(64), 1e-5)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    w1, w2 = torch.randn(64, 128, generator=g), torch.randn(128, 64, generator=g)
    out = ffn_fused.ffn_decode_f32(x, w1, torch.zeros(128), w2, torch.zeros(64), "gelu")
    assert torch.equal(out, ffn_fused.ffn_decode(x, w1, torch.zeros(128), w2, torch.zeros(64)))
    qv = torch.randn(2, 64, generator=g)
    kv = torch.randn(2, 5, 64, generator=g)
    bias = torch.zeros(2, 5)
    ctx = mha_step.mha_decode_ctx_f32(qv, kv, kv, qv, qv, bias, 32)
    assert torch.equal(ctx, mha_step.mha_decode_ctx(qv, kv, kv, qv, qv, bias, 32))
    for fn in (ln_quant.ln_quantize_f32, ffn_fused.ffn_decode_f32, ffn_fused.ffn_decode_int8_f32,
               mha_step.mha_decode_ctx_f32, mha_step.mha_decode_ctx_int8_f32,
               ssm_step.ssm_decode_step_f32, ssm_step.ssm_decode_step_int8_f32):
        assert fn.launches == 0, fn.__name__
    _, params, _ = _f32_layer(SSM, 2, False)
    mixer = _mixer(params, 0, False, False)
    h, conv = torch.randn(2, 128, generator=g), torch.randn(2, 3, 64, generator=g)
    assert not ssm_step.hopper_layout(h, conv, mixer)
    bf = MixerWeights(*(t.to(torch.bfloat16) if t is not None else None for t in mixer))
    assert ssm_step.hopper_layout(h.bfloat16(), conv.bfloat16(), bf)
    assert not ssm_step.hopper_layout(h.bfloat16(), conv, bf)
