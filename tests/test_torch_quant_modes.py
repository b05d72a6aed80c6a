"""The port's selectable int8 arithmetic (``quant_matmul``) vs the JAX
package's ``APERTIS_QUANT_MATMUL``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On CPU
tensors the port's kernel wrappers take their plain versions:
``quant_matmul_reference`` (the weight-only kernel, #6) and
``quant_matmul_dyn_fused_reference`` (the block-quantizing kernel, #8) are
held against JAX's Pallas kernels in interpret mode, as
``tests/test_quant_matmul.py`` and ``tests/test_quantize.py`` run them.

The model tests serve one int8 tree (each package quantizes the same f32
weights with ``min_size=0``) through both engines, the JAX one with
``APERTIS_QUANT_MATMUL`` set to the port's ``quant_matmul`` and the settings
of the existing int8 tests (``APERTIS_LN_QUANT=force``,
``APERTIS_SSM_STEP=force``, ``APERTIS_FFN_FUSED=force``,
``APERTIS_MHA_STEP=force``, ``APERTIS_QUANT_KV=1``), by monkeypatch. Off the
TPU JAX's ``_linear`` turns ``pallas`` into ``weightonly``
(models/apertis.py:126-128), so the ``pallas`` tests patch
``apertis.py::_on_tpu`` to return True inside
``pltpu.force_tpu_interpret_mode()``. What else that patch flips, and why it
changes nothing here: ``:105`` (the int4 ``w_q4`` linear; no tree here has
one, and it takes ``auto``/``dyn`` only), ``:184`` (``_maybe_ln_quant``;
it takes ``auto``/``dyn`` only, and ``APERTIS_LN_QUANT=force`` already
engages it there), ``:564`` and ``:1194`` (the MoE fat kernel and its decode
hoist; the models here are dense and MHA, without experts).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models import quantize as jax_quantize
from apertis_llm_tpu.ops.pallas import quant_matmul as jax_qm
from apertis_llm_tpu.ops.pallas.quant_matmul import quant_matmul as jax_quant_matmul
from apertis_llm_tpu.ops.pallas.quant_matmul import (
    quant_matmul_dyn_fused as jax_quant_matmul_dyn_fused)
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models import apertis as torch_model
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.params import init_params
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops import quant as torch_quant
from apertis_llm_torch.ops.kernels import quant_matmul as qm
from apertis_llm_torch.ops.kernels.quant_matmul import (
    quant_matmul, quant_matmul_dyn_fused, quant_matmul_dyn_fused_reference,
    quant_matmul_reference)

torch.set_num_threads(2)

BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=128, decode_max_length=64)
FAMILIES = {"dense": {}, "mha": dict(attention_type="standard_mha")}
SERVE_ENV = {"APERTIS_LN_QUANT": "force", "APERTIS_SSM_STEP": "force",
             "APERTIS_FFN_FUSED": "force", "APERTIS_MHA_STEP": "force",
             "APERTIS_QUANT_KV": "1"}
BF16_ULP = 2.0 ** -7


def _operands(seed, m, k, n, dtype):
    """x (M, K) in ``dtype``, int8 weight and scales from JAX's
    quantize_weight, and a bias, as JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.normal(size=(m, k)), jdt)
    w_q, w_s = jax_quantize.quantize_weight(jnp.asarray(0.05 * rng.normal(size=(k, n)),
                                                        jnp.float32))
    b = jnp.asarray(0.1 * rng.normal(size=(n,)), jdt)
    tdt = getattr(torch, dtype)

    def as_t(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(tdt)

    return (x, w_q, w_s, b), (as_t(x), torch.from_numpy(np.array(w_q)),
                              torch.from_numpy(np.array(w_s)), as_t(b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(17, 608, 2432), (4, 64, 96), (37, 600, 300)])
def test_weight_only_plain_version_matches_jax_kernel(dtype, m, k, n):
    """quant_matmul on CPU tensors (#6's plain version) against the
    interpret-mode TPU kernel, without and with a bias, at the JAX test's
    (17, 608, 2432), a small shape and K = 600 (not a multiple of 512, so the
    TPU kernel pads a second K block): the products are exact in f32 and only
    the order of the f32 sums differs (the TPU kernel adds per 512-wide K
    block), so bf16 results are within one bf16 ulp of the largest (2^-7)
    and f32 ones within 1e-5 of it."""
    (jx, wq, ws, jb), (x, twq, tws, b) = _operands(m * n + k, m, k, n, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_quant_matmul(jx, wq, ws)
    tol = BF16_ULP if dtype == "bfloat16" else 1e-5
    for bias in (None, b):
        got = quant_matmul(x, twq, tws, bias)
        want = np.asarray(jnp.asarray(ref if bias is None else ref + jb, jnp.float32))
        assert got.dtype == x.dtype and got.shape == (m, n)
        assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()
    assert quant_matmul.launches == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(513, 2432, 1024), (37, 600, 300), (64, 256, 128),
                                   (5, 1100, 44)])
def test_block_quantizing_plain_version_matches_jax_kernel(dtype, m, k, n):
    """quant_matmul_dyn_fused on CPU tensors (#8's plain version) against
    the TPU kernel (which interprets itself off the TPU), at the JAX test's
    (513, 2432, 1024), at K = 600 and 1100 (partial last 512-wide blocks),
    at K = 256 (one block of K) and at N = 44, without and with the bias
    (added in the output type). Both take the per-block scale as a multiply
    by 1/127 and the levels by a true division, so the int8 levels and the
    int32 block sums agree. The CPU interpreter contracts the kernel's
    ``acc += block * s`` into one fused multiply-add, where the TPU kernel,
    the CUDA kernel and the plain version round the product and the sum
    apart, so the f32 sums may differ in their last bits over the K blocks:
    f32 results within 1e-6 of the largest, bf16 ones within one bf16 ulp of
    it (2^-7, a sum next to a rounding boundary)."""
    (jx, wq, ws, jb), (x, twq, tws, b) = _operands(m + k * n, m, k, n, dtype)
    ref = jax_quant_matmul_dyn_fused(jx, wq, ws)
    tol = BF16_ULP if dtype == "bfloat16" else 1e-6
    for bias in (None, b):
        got = quant_matmul_dyn_fused(x, twq, tws, bias)
        want = np.asarray(jnp.asarray(ref if bias is None else ref + jb, jnp.float32))
        assert got.dtype == x.dtype and got.shape == (m, n)
        assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()
    assert quant_matmul_dyn_fused.launches == 0


def test_block_quantization_keeps_each_512_block_scale():
    """The plain version's scales are per row and 512-wide K block: x whose
    second block is 1000 times smaller than its first keeps that block's
    precision, where one scale per row would round it to zero levels."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 1024)).astype(np.float32)
    x[:, 512:] *= 1e-3
    w = np.zeros((1024, 2), np.float32)
    w[512:, 0] = 1.0
    got = quant_matmul_dyn_fused_reference(torch.from_numpy(x), torch.from_numpy(w).to(torch.int8),
                                           torch.ones(1, 2))
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 512:].sum(1), atol=1e-3)
    assert not got[:, 1].any()


def _tree(family, seed, **over):
    """A perturbed f32 tree as numpy, with its JAX config and the port's."""
    kw = dict(BASE, **FAMILIES[family], **over)
    cfg = ApertisConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: x.numpy() + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        init_params(cfg, torch.Generator().manual_seed(seed), device="cpu"))
    return JaxConfig(**kw), cfg, tree


def _engines(family, mode, monkeypatch, seed):
    """The JAX engine under APERTIS_QUANT_MATMUL=mode and the port's engine
    with quant_matmul=mode on one int8 tree; JAX's quantizer runs eagerly
    (under jit XLA turns its divisions by constants into multiplications).
    Also returns the JAX products its ``_linear`` traced, by name."""
    for key, value in dict(SERVE_ENV, APERTIS_QUANT_MATMUL=mode).items():
        monkeypatch.setenv(key, value)
    if mode == "pallas":
        monkeypatch.setattr(jax_model, "_on_tpu", lambda: True)
    traced = []
    for name in ("quant_matmul", "quant_matmul_dyn_fused", "quant_matmul_dyn_xla"):
        real = getattr(jax_qm, name)
        monkeypatch.setattr(jax_qm, name, lambda *a, _n=name, _f=real: (traced.append(_n),
                                                                          _f(*a))[1])
    jcfg, cfg, tree = _tree(family, seed)
    jparams = jax_quantize.quantize_params(jax.tree.map(jnp.asarray, tree), min_size=0)
    assert "w_q4" not in jparams["layers"]["ffn"]["w1"] and not jcfg.use_expert_system
    jengine = JaxEngine(jcfg, jparams)
    model = from_jax_params(quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
                            cfg, device="cpu")
    return jengine, InferenceEngine(cfg, model, quant_matmul=mode), traced


def _interpret(mode):
    return pltpu.force_tpu_interpret_mode() if mode == "pallas" else contextlib.nullcontext()


def _ragged_batch():
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, prompt in enumerate(([1, 5, 9, 33, 70, 4, 18], [2, 8], [7, 3, 99, 41])):
        batch[row, :len(prompt)] = prompt
        mask[row, :len(prompt)] = 1
    return batch, mask


@pytest.mark.parametrize("family", ["dense", "mha"])
@pytest.mark.parametrize("mode", ["weightonly", "pallas", "fused"])
def test_int8_models_match_jax_under_each_mode(family, mode, monkeypatch):
    """A 2-layer int8 selective-SSM or MHA model under ``quant_matmul`` =
    weightonly, pallas or fused against the JAX engine under the same
    APERTIS_QUANT_MATMUL: the prefill logits of the ragged prompts
    (bucketed to 32 positions) within 1e-2 of the largest (the int8 tests'
    tolerance: the decode kernels' row quantizations may land a value on the
    next level where an f32 sum was taken in another order; the mode's own
    products are within 1e-5 of JAX's), then greedy generation through both
    engines token-exact. The JAX side traced the mode's product only (for
    weightonly, none of its kernels)."""
    jengine, engine, traced = _engines(family, mode, monkeypatch, seed=7)
    batch, mask = _ragged_batch()
    ids, mask32 = np.pad(batch, ((0, 0), (0, 25))), np.pad(mask, ((0, 0), (0, 25)))
    lens = mask32.sum(axis=1)
    jcfg, model = jengine.config, engine.model
    width = ids.shape[1] + 2
    mha = family == "mha"
    with _interpret(mode):
        jpre = jax_model.prefill(jengine.params, jcfg, jax_model.init_cache(jcfg, 3, max_length=width),
                                 jnp.asarray(ids), attention_mask=jnp.asarray(mask32),
                                 logit_positions=jnp.asarray(lens - 1))
        kw = dict(max_new_tokens=8, eos_token_id=())
        ref = jengine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    cache = model.init_cache(3, max_length=width, kv_int8=True) if mha else model.init_cache(3)
    tpre = model.prefill(cache, torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask32),
                         logit_positions=torch.as_tensor(lens - 1))
    want = np.asarray(jpre.logits, np.float32)
    assert np.abs(tpre.logits.numpy() - want).max() <= 1e-2 * np.abs(want).max()
    got = engine.generate(batch, attention_mask=mask, **kw)
    assert got.shape == (3, 15)
    np.testing.assert_array_equal(got, ref)
    kernel = {"pallas": "quant_matmul", "fused": "quant_matmul_dyn_fused"}.get(mode)
    assert set(traced) == ({kernel} if kernel else set())


def _count(monkeypatch):
    """Count the calls of each int8 product's wrapper (on CPU tensors each
    runs its plain version) and of ``ln_quantize``."""
    calls = {}
    for name in ("quant_matmul", "quant_matmul_dyn_fused", "quant_matmul_dyn_pre_q"):
        real = getattr(qm, name)
        monkeypatch.setattr(qm, name, lambda *a, _n=name, _f=real: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a))[1])
    real_lnq = torch_model.ln_quantize
    monkeypatch.setattr(torch_model, "ln_quantize", lambda *a: (
        calls.__setitem__("ln_quantize", calls.get("ln_quantize", 0) + 1), real_lnq(*a))[1])
    return calls


@pytest.mark.parametrize("family", ["dense", "mha"])
@pytest.mark.parametrize("mode", ["dyn", "weightonly", "pallas", "fused"])
def test_each_mode_routes_through_its_product(family, mode, monkeypatch):
    """Which wrapper an int8 model's linears call in each mode, counted over
    one generate of 3 tokens (one prefill, two decode steps): the prefill's
    six projections a layer (the SSM mixer's four or MHA's q, k, v, o, and
    the FFN pair) and the int8 head at prefill and at each decode step take
    the mode's product (weightonly: plain torch, no wrapper); the int8 MHA
    decode's fused QKV and o stay on the w8a8 product in every mode; the
    int8 pre-norms fuse their row quantization (``ln_quantize``) under dyn
    only."""
    cfg = ApertisConfig(**dict(BASE, **FAMILIES[family]))
    tree = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    model = from_jax_params(quantize_params(tree, min_size=0), cfg, device="cpu")
    engine = InferenceEngine(cfg, model, quant_matmul=mode)
    calls = _count(monkeypatch)
    ids = np.random.default_rng(2).integers(4, 131, (2, 5)).astype(np.int32)
    engine.generate(ids, max_new_tokens=3, eos_token_id=())
    nl, steps = cfg.num_hidden_layers, 2
    own = 6 * nl + 1 + steps
    pre_q = 2 * nl * steps if family == "mha" else 0
    expected = {"dyn": {"quant_matmul_dyn_pre_q": own + pre_q,
                        "ln_quantize": (1 if family == "mha" else 2) * nl},
                "weightonly": {"quant_matmul_dyn_pre_q": pre_q},
                "pallas": {"quant_matmul": own, "quant_matmul_dyn_pre_q": pre_q},
                "fused": {"quant_matmul_dyn_fused": own, "quant_matmul_dyn_pre_q": pre_q}}[mode]
    assert calls == {k: v for k, v in expected.items() if v}
    assert quant_matmul.launches == quant_matmul_dyn_fused.launches == 0


def test_weight_only_linear_and_mode_dispatch():
    """``linear_int8`` per mode on one input: weightonly is ``x @ (w_q * w_s)``
    with the weight dequantized in x's dtype; pallas is #6 and fused #8,
    each plus the bias; auto is #6 (``resolve_mode``) on rows not quantized
    already; an
    unknown mode raises, as do unknown engine and model arguments;
    ``moe_mode="0"`` (no serving stack) is accepted."""
    (_, _, _, _), (x, wq, ws, b) = _operands(5, 9, 64, 40, "bfloat16")
    wo = torch_quant.linear_int8(x, wq, ws, b, "weightonly")
    assert torch.equal(wo, x @ (wq.to(torch.bfloat16) * ws.to(torch.bfloat16)) + b)
    assert torch.equal(torch_quant.linear_int8(x, wq, ws, b, "pallas"),
                       quant_matmul_reference(x, wq, ws) + b)
    assert torch.equal(torch_quant.linear_int8(x, wq, ws, b, "fused"),
                       quant_matmul_dyn_fused_reference(x, wq, ws) + b)
    assert torch.equal(torch_quant.linear_int8(x, wq, ws, b, "dyn"),
                       torch_quant.linear_dyn(x, wq, ws, b))
    assert torch.equal(torch_quant.linear_int8(x, wq, ws, b, "auto"),
                       quant_matmul_reference(x, wq, ws) + b)
    with pytest.raises(ValueError):
        torch_quant.linear_int8(x, wq, ws, b, "xla")
    cfg = ApertisConfig(**BASE)
    model = from_jax_params(init_params(cfg, torch.Generator(), device="cpu"), cfg, device="cpu")
    for kw in (dict(quant_matmul="autox"), dict(quant_matmul="xla"), dict(moe_mode="fatt"),
               dict(moe_mode="1")):
        with pytest.raises(ValueError):
            InferenceEngine(cfg, model, **kw)
        with pytest.raises(ValueError):
            torch_model.ApertisForCausalLM(cfg, device="cpu", **kw)
    InferenceEngine(cfg, model, moe_mode="0")
    assert torch_model.ApertisForCausalLM(cfg, device="cpu", moe_mode="0").moe_mode == "0"
    meta = dict(device="meta")
    for fn in (quant_matmul, quant_matmul_dyn_fused):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.empty((4, 64), dtype=torch.bfloat16, **meta),
               torch.empty((64, 40), dtype=torch.int8, **meta), torch.empty((1, 40), **meta))
    assert quant_matmul.launches == quant_matmul_dyn_fused.launches == 0
