"""The port at widths that are not multiples of 4 or 16, and at more experts
than a warp's lanes, held against the JAX package on the CPU.

The JAX kernels take any hidden width D, mixer width C (heads x d_state)
and MoE intermediate width I: the decode step (#3,
``ssm_step.py::ssm_decode_step_fused``) pads only rows, the fat expert FFN
(#10) takes a tile of the whole I where I is not a multiple of 128, and the
step's moe epilogue routes over any number of experts. The port serves the
same configurations: ``check_supported`` admits them, the wrappers launch
their kernels at those widths on the card (here, on CPU tensors, their plain
versions run), and a MoE model decodes every step through the step's moe
epilogue whatever its number of experts.

Sizes: 2 layers, hidden 45 (3 heads of d_state 5: C = 15, dt rank 3),
intermediate 90 (90 % 16 = 10), 4 and 40 experts, top-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.moe_fuse import attach_fused_decode_params
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.quantize import quantize_tied_head as jax_quantize_tied_head
from apertis_llm_tpu.models.ssm_fuse import attach_fused_ssm_params
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_tpu.ops.pallas.ssm_step import ssm_decode_step_fused
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models import apertis as torch_model
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.params import check_supported
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops.kernels import _build, moe_ffn, moe_grouped, ssm_step
from apertis_llm_torch.ops.kernels.ssm_step import MixerWeights, RouterWeights

torch.set_num_threads(2)

ODD = dict(vocab_size=256, hidden_size=45, num_hidden_layers=2, num_attention_heads=3,
           ssm_d_state=5, intermediate_size=90, attention_type="selective_ssm",
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


def _tree(seed, dtype=np.float32, **over):
    """A JAX parameter tree at the odd widths with numpy noise on every leaf."""
    cfg = JaxConfig(**dict(ODD, **over))
    rng = np.random.default_rng(seed)
    return cfg, jax.tree.map(
        lambda x: (np.asarray(x, np.float32)
                   + rng.normal(0.0, 0.02, x.shape).astype(np.float32)).astype(dtype),
        jax_init_params(jax.random.PRNGKey(seed), cfg))


def _t(x):
    """JAX array -> torch tensor of the same values and kind."""
    if x.dtype in (jnp.int8, jnp.int32):
        return torch.from_numpy(np.array(x))
    arr = np.asarray(jnp.asarray(x, jnp.float32)).copy()
    return torch.from_numpy(arr).to(torch.bfloat16 if x.dtype == jnp.bfloat16
                                    else torch.float32)


class _FakeLibrary:
    """Records each C entry point a wrapper calls, with its arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 64 if name.endswith("_scratch") else 0
        return entry


def test_odd_widths_are_admitted_and_reach_the_kernels(monkeypatch):
    """``check_supported`` admits the odd widths and 40 experts (no width
    branch is left), and each wrapper, given tensors that take the card's
    path (``meta`` tensors, its checks of device and alignment passed),
    plans and calls its kernel's entry point at D 693, C 165, I 2790 and E
    40: no width check refuses them."""
    for over in ({}, dict(num_experts=40), dict(hidden_size=693, num_attention_heads=11,
                                                ssm_d_state=15, intermediate_size=2790)):
        check_supported(ApertisConfig(**dict(ODD, **over)), quantized=True)
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "check_tensor", lambda *a: None)
    monkeypatch.setattr(_build, "check_aligned", lambda *a: None)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("Stream", (), {"cuda_stream": 0})())
    d, heads, n, k, r, e, inter = 693, 11, 15, 4, 44, 40, 2790
    c = heads * n

    def m(*shape, dt=torch.bfloat16):
        return torch.empty(shape, dtype=dt, device="meta")

    i8, f32 = torch.int8, torch.float32
    w = MixerWeights(m(d), m(d), m(d, c, dt=i8), m(d, c, dt=i8), m(c, k), m(c),
                     m(c, r + 2 * c, dt=i8), m(r, heads), m(heads), m(heads, n), m(c),
                     m(c, d, dt=i8), m(1, c, dt=f32), m(1, c, dt=f32), m(1, r + 2 * c, dt=f32),
                     m(1, d, dt=f32))
    router = RouterWeights(m(d), m(d), m(d, e), m(e))
    for rows in (4, 64):
        ssm_step.ssm_decode_step(m(rows, d), m(rows, k - 1, c), m(rows, c, dt=f32), w, 1e-5,
                                 (m(d), m(d)), None, router)
    moe_ffn.expert_ffn_fat(m(5, d, dt=i8), m(5, 1, dt=f32), m(5, e, dt=f32),
                           m(d, e * inter, dt=i8), m(1, e * inter, dt=f32), m(e * inter, dt=f32),
                           m(e * inter, d, dt=i8), m(1, d, dt=f32), e)
    moe_ffn.expert_ffn_dense(m(5, d, dt=i8), m(5, 1, dt=f32), m(8, d, inter, dt=i8),
                             m(8, 1, inter, dt=f32), m(8, inter, dt=f32), m(8, inter, d, dt=i8),
                             m(8, 1, d, dt=f32), m(8, d, dt=f32))
    moe_grouped.expert_ffn_grouped(m(256, d, dt=i8), m(256, 1, dt=f32),
                                   m(2, dt=torch.int32), m(d, 8 * inter, dt=i8),
                                   m(1, 8 * inter, dt=f32), m(8 * inter, dt=f32),
                                   m(8 * inter, d, dt=i8), m(1, d, dt=f32), 8)
    entries = [name for name, _ in lib.calls if not name.endswith("_scratch")]
    assert entries == ["apertis_ssm_decode_step_int8"] * 2 + [
        "apertis_expert_ffn_fat", "apertis_expert_ffn_dense", "apertis_expert_ffn_grouped"]
    step_args = [args for name, args in lib.calls if name == "apertis_ssm_decode_step_int8"]
    assert all(args[32:40] == (rows, d, c, k, r, heads, n, e)
               for rows, args in zip((4, 64), step_args))
    fat_args = dict(lib.calls)["apertis_expert_ffn_fat"]
    assert fat_args[13:18] == (5, d, e * inter, e, inter)    # rows, H, E*I, E and bn = I


def _epilogue_calls(monkeypatch):
    """Record, for each ``ssm_decode_step`` the model makes, whether it asked
    for the moe epilogue (a router)."""
    calls = []
    step = torch_model.ssm_decode_step

    def spy(*args, **kwargs):
        calls.append(kwargs.get("router") is not None)
        return step(*args, **kwargs)
    monkeypatch.setattr(torch_model, "ssm_decode_step", spy)
    return calls


@pytest.mark.parametrize("experts,int8", [(4, True), (40, False)])
def test_odd_width_model_matches_jax(experts, int8, monkeypatch, exact_gelu):
    """The 2-layer model at hidden 45, C 15 and I 90 with 4 or 40 experts,
    int8 and float (each case costs some 10 s of JAX compiles), the fat
    stack attached as the engines attach it: ragged prefill of 3 x 12
    tokens and four decode steps against the JAX model (its Pallas kernels
    interpreted) on the same weights, logits within 1e-2 of their largest
    value (the MoE tolerance of tests/test_torch_moe.py: a flipped int8 level
    of the expert input or hidden moves a logit by up to about 0.5 % of the
    largest). Every port decode step runs the step's moe epilogue."""
    for key, value in {**SERVE_ENV, **(QUANT_ENV if int8 else {})}.items():
        monkeypatch.setenv(key, value)
    cfg, tree = _tree(20 + experts, num_experts=experts)
    jparams = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.from_numpy, tree)
    if int8:
        jparams = jax_quantize_tied_head(jax_quantize_params(jparams, min_size=0))
        ttree = quantize_params(ttree, min_size=0)
    jparams = attach_fused_ssm_params(attach_fused_decode_params(jparams, mode="fat"), cfg)
    model = from_jax_params(ttree, ApertisConfig(**dict(ODD, num_experts=experts)),
                            device="cpu")
    if int8:
        model.quantize_tied_head()
        model.set_modes("dyn", "fatk")
    model.attach_moe_fat()
    calls = _epilogue_calls(monkeypatch)
    rng = np.random.default_rng(21)
    lens = np.array([12, 7, 3])
    ids = rng.integers(4, cfg.vocab_size, (3, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < lens[:, None]).astype(np.int32)
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
    for i in range(4):
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tok))
        tlogits, tcache = model.decode_step(tcache, torch.as_tensor(tok, dtype=torch.long))
        close(tlogits, jlogits, f"decode step {i}")
        tok = np.asarray(jlogits).argmax(axis=-1).astype(np.int32)
    assert len(calls) == 4 * ODD["num_hidden_layers"] and all(calls)


def kernel_top2(logits, top_k_lanes=32):
    """The selection of ``csrc/ssm_step.cu::warp_top2_combine`` over one
    row: lane l holds experts l, l + 32, ...; each lane keeps its first
    largest gate, the warp the least index among the lanes that hold the
    maximum; then the same with the first choice masked."""
    e = logits.shape[0]

    def pick(gates):
        best = []
        for lane in range(top_k_lanes):
            w, i = -np.inf, e
            for j in range(lane, e, top_k_lanes):
                if gates[j] > w:
                    w, i = gates[j], j
            best.append((w, i))
        m = max(w for w, _ in best)
        return m, min(i for w, i in best if w == m)

    w1, i1 = pick(logits)
    masked = logits.copy()
    masked[i1] = -np.inf
    w2, i2 = pick(masked)
    return i1, i2


@pytest.mark.parametrize("tie", ["none", "first", "second"])
def test_epilogue_combine_over_40_experts_matches_jax(tie):
    """The moe epilogue over 40 experts at hidden 45 (bf16 layout), 24 rows:
    the plain step's combine weights against ``ssm_decode_step_fused``
    (ffn_mode "moe", interpreted) within 1e-3 (the f32 FFN input is rounded
    to bf16 before the router reads it, tests/test_torch_moe.py), the same
    two experts in every row, and ties broken to the lower index as JAX
    breaks them: with ``tie``, two experts share their router column and a
    bias that makes them the top two ("first") or the runners-up behind a
    third ("second"). The kernel's lane-strided selection
    (:func:`kernel_top2`) picks the same experts."""
    e = 40
    cfg, tree = _tree(31, dtype=jnp.bfloat16, num_experts=e)
    if tie != "none":
        router = tree["layers"]["ffn"]["router"]
        router["w"][:, :, 33] = router["w"][:, :, 17]
        router["b"][:, 17] = router["b"][:, 33] = 2.0
        if tie == "second":
            router["b"][:, 5] = 4.0
    params = jax.tree.map(jnp.asarray, tree)
    fused = attach_fused_ssm_params(params, cfg)["layers"]["attn"]["fused"]
    rng = np.random.default_rng(32)
    b, d, c = 24, cfg.hidden_size, cfg.ssm_d_inner
    h = jnp.asarray(rng.normal(0, 1.0, (b, d)), jnp.bfloat16)
    conv = jnp.asarray(rng.normal(0, 0.5, (b, 3, c)), jnp.bfloat16)
    ssm = jnp.asarray(rng.normal(0, 0.5, (b, c)), jnp.float32)
    ref = ssm_decode_step_fused(h, conv, ssm, fused, 1, cfg.layer_norm_eps, False,
                                ffn_mode="moe")
    lay = jax.tree.map(lambda v: _t(v[1]), params["layers"])
    a, f = lay["attn"], lay["ffn"]
    w = MixerWeights(a["pre_norm"]["w"], a["pre_norm"]["b"], a["in_proj_x"]["w"],
                     a["in_proj_z"]["w"], a["conv"]["w"], a["conv"]["b"], a["x_param_proj"]["w"],
                     a["dt_proj"]["w"], a["dt_proj"]["b"], a["A_log"], a["D"], a["out_proj"]["w"])
    router = RouterWeights(f["router_ln"]["w"], f["router_ln"]["b"], f["router"]["w"],
                           f["router"]["b"])
    got = ssm_step.ssm_decode_step(_t(h), _t(conv), _t(ssm), w, cfg.layer_norm_eps,
                                   ffn_norm=(f["pre_norm"]["w"], f["pre_norm"]["b"]),
                                   router=router)
    comb, comb_ref = got[5].numpy(), np.asarray(ref[5])
    assert comb.shape == (b, e)
    np.testing.assert_allclose(comb, comb_ref, atol=1e-3)
    np.testing.assert_array_equal(comb > 0, comb_ref > 0)
    assert ((comb > 0).sum(axis=1) == 2).all()
    if tie == "first":
        assert (comb[:, 17] > 0).all() and (comb[:, 33] > 0).all()
        np.testing.assert_array_equal(comb[:, 17], comb[:, 33])
    if tie == "second":
        assert (comb[:, 5] > 0).all() and (comb[:, 17] > 0).all() and (comb[:, 33] == 0).all()
    # The kernel's selection over the plain router's logits of the FFN input
    # n2 (from the f32 residual sum, which the plain step returns for f32 h).
    hsum = ssm_step.ssm_decode_step_reference(_t(h).float(), _t(conv), _t(ssm), w,
                                              cfg.layer_norm_eps)[0]
    n2 = torch.nn.functional.layer_norm(
        hsum, (d,), f["pre_norm"]["w"].float(), f["pre_norm"]["b"].float(),
        cfg.layer_norm_eps).to(torch.bfloat16).float()
    rn = torch.nn.functional.layer_norm(n2, (d,), router.ln_w.float(), router.ln_b.float(),
                                        cfg.layer_norm_eps)
    logits = (rn @ router.w.float() + router.b.float()).numpy()
    for row in range(b):
        i1, i2 = kernel_top2(logits[row])
        assert set(np.flatnonzero(comb[row])) == {i1, i2}, row
    if tie != "none":
        tied = logits.copy()
        tied[:, 33] = tied[:, 17]
        for row in range(b):
            assert kernel_top2(tied[row]) == ((17, 33) if tie == "first" else (5, 17))
