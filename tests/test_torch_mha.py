"""The port's MHA model vs the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages. The JAX side runs its flat-cache decode path
(``APERTIS_MHA_STEP=force``, the decode-attention kernel in interpret mode,
with the defaults ``APERTIS_MHA_LNQ=xla`` and ``APERTIS_MHA_QKV=1``), with an
int8 KV cache under ``APERTIS_QUANT_KV=1``; int8 weights add the one int8
arithmetic of the port (``APERTIS_QUANT_MATMUL=dyn``, ``APERTIS_LN_QUANT=
force``, ``APERTIS_FFN_FUSED=force``), and the JAX FFN kernel is given the
exact GELU the port computes (its tanh-form erf flips int8 hidden levels now
and then). The flash kernel runs under ``pltpu.force_tpu_interpret_mode()``,
as ``tests/test_pallas_kernels.py`` runs it. On the CPU the port's kernel
wrappers take their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.inference.engine import InferenceEngine as JaxEngine
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import attach_qkv_mha
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.quantize import quantize_tied_head as jax_quantize_tied_head
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops import attention as jax_attn
from apertis_llm_tpu.ops import rope as jax_rope
from apertis_llm_tpu.ops.pallas import flash_attention as jax_flash
from apertis_llm_tpu.ops.pallas import mha_step as jax_mha_step
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.factory import calculate_model_dimensions
from apertis_llm_torch.models.params import (
    check_supported, count_params, init_params, quantized_layout)
from apertis_llm_torch.models.quantize import fuse_qkv, quantize_params
from apertis_llm_torch.ops import attention as attn_ops
from apertis_llm_torch.ops.kernels.flash_attention import flash_attention_fwd
from apertis_llm_torch.ops.kernels.mha_step import (
    NEG, mha_decode_ctx, mha_decode_ctx_int8, quantize_heads)
from apertis_llm_torch.ops.rope import apply_rope, rope_tables

torch.set_num_threads(2)

BASE = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, attention_type="standard_mha",
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=64)
MHA_ENV = {"APERTIS_MHA_STEP": "force", "APERTIS_FFN_FUSED": "force"}
QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force"}
BF16_ULP = 2.0 ** -7     # one bf16 ulp relative to the largest value


def _setenv(monkeypatch, *envs):
    for env in envs:
        for key, value in env.items():
            monkeypatch.setenv(key, value)


def _tree(seed=0, **over):
    """A perturbed f32 JAX tree as numpy (biases and norms off their 0/1
    init), with its JAX config and the port's."""
    kw = dict(BASE, **over)
    jcfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, ApertisConfig(**kw), tree


def _pair(seed=0, int8=False, **over):
    """(jax config, jax params, torch model) on one set of weights; with
    ``int8`` both packages quantize it (``min_size=0``) and attach the int8
    tied head, and the JAX tree gets its fused QKV stack."""
    jcfg, cfg, tree = _tree(seed, **over)
    jparams = jax.tree.map(jnp.asarray, tree)
    if not int8:
        return jcfg, jparams, from_jax_params(tree, cfg, device="cpu")
    jparams = attach_qkv_mha(jax_quantize_tied_head(jax_quantize_params(jparams, min_size=0)))
    model = from_jax_params(quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
                            cfg, device="cpu")
    model.quantize_tied_head()
    assert model.quantized and "qkv" in jparams["layers"]["attn"]
    return jcfg, jparams, model


def _ragged(rng, lens, width, vocab):
    ids = rng.integers(4, vocab, (len(lens), width)).astype(np.int32)
    mask = (np.arange(width)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids * mask, mask


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), what


# ---- 1-2. RoPE, the bias and the plain attention ----------------------------

def test_rope_matches_jax():
    """(B, L) and (L,) positions, f32, 1e-6."""
    rng = np.random.default_rng(0)
    cos, sin = rope_tables(128, 64)
    jcos, jsin = jax_rope.rope_tables(128, 64)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    x = rng.standard_normal((3, 7, 128)).astype(np.float32)
    for pos in (rng.integers(0, 64, (3, 7)), np.arange(7)):
        got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cos, sin)
        ref = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcos, jsin)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_and_plain_attention_match_jax(dtype):
    """Causal x padding bias with right-padded rows (bit-equal, -inf where
    both add), then the plain attention under it: f32 1e-5, bf16 outputs
    one bf16 ulp of the largest value (f32 sums in another order)."""
    rng = np.random.default_rng(1)
    _, mask = _ragged(rng, [9, 4, 1], 9, 100)
    bias = attn_ops.build_bias(torch.from_numpy(mask), 9)
    jbias = jax_model._build_bias(jnp.asarray(mask), 9, 0)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    assert np.isneginf(bias.numpy()).any()
    q, k, v = (rng.standard_normal((3, 4, 9, 32)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v))
    tol = 1e-5 if dtype == "float32" else BF16_ULP
    for tb, jb in ((bias, jbias), (None, None)):
        got = attn_ops.mha(tq, tk, tv, bias=tb)
        ref = jax_attn.mha(jq, jk, jv, bias=jb)
        assert got.dtype == tq.dtype
        _close(got.float(), np.asarray(ref, np.float32), tol)


# ---- 3. the decode-attention kernel's plain version -------------------------

def _decode_inputs(rng, b, heads, head_dim, l, dtype):
    d = heads * head_dim
    t = lambda *s: rng.standard_normal(s).astype(np.float32)      # noqa: E731
    q, k_new, v_new = t(b, d), t(b, d), t(b, d)
    k, v = t(b, l, d), t(b, l, d)
    valid = rng.integers(0, 2, (b, l)) > 0           # ragged rows
    valid[:, 0] = True
    valid[:, l - 3] = False                          # the stale slot
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    cast = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))   # noqa: E731
    jcast = lambda a: jnp.asarray(a, jnp.dtype(dtype))                # noqa: E731
    port = (cast(q), cast(k), cast(v), cast(k_new), cast(v_new), torch.from_numpy(bias))
    jax_in = (jcast(q), jcast(k)[None], jcast(v)[None], jcast(k_new), jcast(v_new),
              jnp.asarray(bias))
    return port, jax_in


@pytest.mark.parametrize("head_dim,heads", [(32, 4), (64, 2), (128, 2), (64, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ctx_matches_jax_kernel(head_dim, heads, dtype):
    """The plain ``mha_decode_ctx`` against the JAX kernel, float cache:
    f32 1e-5; bf16 one bf16 ulp of the largest value."""
    rng = np.random.default_rng(head_dim + heads)
    port, jin = _decode_inputs(rng, 4, heads, head_dim, 24, dtype)
    got = mha_decode_ctx(*port, head_dim)
    ref = jax_mha_step.mha_decode_ctx(*jin, 0, head_dim=head_dim)
    assert got.dtype == port[0].dtype
    _close(got.float(), np.asarray(ref, np.float32), 1e-5 if dtype == "float32" else BF16_ULP)


@pytest.mark.parametrize("head_dim,heads", [(32, 4), (64, 6)])
def test_decode_ctx_int8_cache_matches_jax_kernel(head_dim, heads):
    """int8 cache: ``quantize_heads`` bit-equal to JAX's (levels and
    scales), then the plain ``mha_decode_ctx_int8`` against the JAX kernel
    with per-(head, slot) scales (f32, 1e-5: the int8 scores are exact on
    both sides; the softmax sums run in another order)."""
    rng = np.random.default_rng(7)
    port, jin = _decode_inputs(rng, 3, heads, head_dim, 20, "float32")
    q, k, v, k_new, v_new, bias = port
    kq, ks = quantize_heads(k, head_dim)
    vq, vs = quantize_heads(v, head_dim)
    jkq, jks = jax_mha_step.quantize_heads(jin[1][0], head_dim)
    jvq, jvs = jax_mha_step.quantize_heads(jin[2][0], head_dim)
    for a, b in ((kq, jkq), (ks, jks), (vq, jvq), (vs, jvs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ks_t, vs_t = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    got = mha_decode_ctx_int8(q, kq, vq, k_new, v_new, bias, ks_t, vs_t, head_dim)
    ref = jax_mha_step.mha_decode_ctx(
        jin[0], jnp.asarray(kq.numpy())[None], jnp.asarray(vq.numpy())[None], jin[3], jin[4],
        jin[5], 0, head_dim=head_dim, ks_stack=jnp.asarray(ks_t.numpy())[None],
        vs_stack=jnp.asarray(vs_t.numpy())[None])
    _close(got, ref, 1e-5)


# ---- 4. the flash kernel's plain version -------------------------------------

@pytest.mark.parametrize("length", [128, 300])
def test_flash_fwd_matches_jax_kernel(length):
    """The plain ``flash_attention_fwd`` against JAX's ``_flash_fwd`` in
    interpret mode with blocks of 128 (300 pads its last block), causal:
    ``out`` and ``lse`` in f32, 1e-5 (the blocked online softmax sums in
    another order)."""
    rng = np.random.default_rng(length)
    q, k, v = (rng.standard_normal((1, 2, length, 32)).astype(np.float32) for _ in range(3))
    out, lse = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    with pltpu.force_tpu_interpret_mode():
        ref, res = jax_flash._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        True, None, 128, 128)
    _close(out, ref, 1e-5)
    _close(lse, res[4], 1e-5)
    assert lse.shape == (1, 2, length) and lse.dtype == torch.float32


# ---- 5. the parameter tree ---------------------------------------------------

def _shapes(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_shapes(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = tuple(value.shape)
    return out


@pytest.mark.parametrize("size,attn_dropout", [("small", 0.0), ("small", 0.1), ("1.5B", 0.0)])
def test_init_params_mha_tree(size, attn_dropout):
    """The JAX init's names and shapes; q/k/v/o biases only when attention
    dropout is 0 (the 1.5B tree is built on the meta device: shapes only)."""
    kw, device = dict(BASE, attention_probs_dropout_prob=attn_dropout), "cpu"
    if size == "1.5B":
        dims = calculate_model_dimensions("1.5B", 32000)
        kw.update(vocab_size=32000, hidden_size=dims["hidden_size"],
                  num_hidden_layers=dims["num_hidden_layers"],
                  num_attention_heads=dims["num_attention_heads"],
                  intermediate_size=dims["intermediate_size"], max_position_embeddings=4096)
        device = "meta"
    ref = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), JaxConfig(**kw)))
    tree = init_params(ApertisConfig(**kw), torch.Generator(), device=device)
    assert _shapes(tree) == _shapes(ref)
    assert ("b" in tree["layers"]["attn"]["q"]) == (attn_dropout == 0.0)
    if size == "1.5B":
        assert count_params(tree) == 1_497_970_944


# ---- 6. full-sequence forward --------------------------------------------------

@pytest.mark.parametrize("case", ["mask", "mask, no q/k/v/o biases", "flash"])
def test_forward_logits_match_jax(case):
    """With a padding mask (plain attention under the bias), also for a tree
    without q/k/v/o biases (attention dropout 0.1, which eval ignores), and
    without a mask at L = 128 with ``use_flash_attention`` (the port's flash
    path, plain on the CPU; JAX's flash gate needs a TPU, so it runs XLA
    attention, which agrees in f32): 1e-5 of the largest logit."""
    flash = case == "flash"
    jcfg, jparams, model = _pair(seed=3, use_flash_attention=flash, max_position_embeddings=128,
                                 attention_probs_dropout_prob=0.1 if "no q" in case else 0.0)
    assert (model.layers[0].attn.q.b is None) == ("no q" in case)
    rng = np.random.default_rng(4)
    ids, mask = _ragged(rng, [128, 100] if flash else [13, 9, 4], 128 if flash else 13,
                        jcfg.vocab_size)
    ref = jax_model.forward(jparams, jcfg, jnp.asarray(ids),
                            attention_mask=None if flash else jnp.asarray(mask)).logits
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long),
                    None if flash else torch.as_tensor(mask))
    _close(got, ref, 1e-5)


def test_forward_takes_flash_only_without_a_mask(monkeypatch):
    """The flash path runs where the gate holds and there is no mask; a
    mask, a short sequence or the flag off take the plain attention. The
    f32 model runs the f32 forward's wrapper (the bf16 one is counted too)."""
    import apertis_llm_torch.ops.kernels.flash_attention as port_flash
    calls = []
    for name in ("flash_attention_fwd", "flash_attention_fwd_f32"):
        real = getattr(port_flash, name)
        monkeypatch.setattr(port_flash, name,
                            lambda *a, _f=real, **k: calls.append(1) or _f(*a, **k))
    _, cfg, tree = _tree(seed=5, use_flash_attention=True, max_position_embeddings=128)
    model = from_jax_params(tree, cfg, device="cpu")
    ids = torch.randint(4, 256, (1, 128), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(ids)
        assert len(calls) == cfg.num_hidden_layers
        model(ids, torch.ones((1, 128), dtype=torch.int32))
        model(ids[:, :127])
        model.config = dataclasses.replace(cfg, use_flash_attention=False)
        model(ids)
    assert len(calls) == cfg.num_hidden_layers


# ---- 7. prefill and decode -------------------------------------------------------

def _decode_both(jcfg, jparams, model, kv_int8, steps=5):
    """Ragged prefill, then ``steps`` decode steps with the engine's
    bookkeeping (slot t = width + i, positions = lens + i, t != positions for
    the padded rows); yields the logits and caches of both after each."""
    rng = np.random.default_rng(9)
    ids, mask = _ragged(rng, [12, 5, 8], 12, jcfg.vocab_size)
    lens = mask.sum(axis=1)
    cache_len = 12 + steps + 1
    jpre = jax_model.prefill(jparams, jcfg, jax_model.init_cache(jcfg, 3, max_length=cache_len),
                             jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                             logit_positions=jnp.asarray(lens - 1))
    assert jpre.cache["k"].ndim == 4 and ("k_ps" in jpre.cache) == kv_int8
    tpre = model.prefill(model.init_cache(3, max_length=cache_len, kv_int8=kv_int8),
                         torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask),
                         logit_positions=torch.as_tensor(lens - 1))
    yield tpre.logits, jpre.logits, tpre.cache, jpre.cache
    step = jax.jit(lambda p, c, tok, t, row, pos: jax_model.decode_step(
        p, jcfg, c, tok, t, attn_mask_row=row, positions=pos))
    row = np.zeros((3, cache_len), np.int32)
    row[:, :12] = mask
    jcache, tcache = jpre.cache, tpre.cache
    tok = np.array(jnp.argmax(jpre.logits[:, 0], axis=-1), np.int32)
    for i in range(steps):
        t = 12 + i
        row[:, t] = 1
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.asarray(t, jnp.int32),
                               jnp.asarray(row), jnp.asarray(lens + i))
        tlogits, tcache = model.decode_step(tcache, torch.as_tensor(tok, dtype=torch.long),
                                            t=t, attn_mask_row=torch.as_tensor(row),
                                            positions=torch.as_tensor(lens + i))
        yield tlogits, jlogits, tcache, jcache
        tok = np.asarray(jlogits).argmax(axis=-1).astype(np.int32)


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
def test_prefill_and_decode_match_jax(weights, kv, monkeypatch):
    """Prefill and five decode steps from right-padded prompts: logits and
    the whole cache (dequantized for int8) after each. f32 weights: 1e-4 of
    the largest value (f32 sums in other orders, over six attention passes).
    int8 weights: each step quantizes the normed rows, the context and the
    FFN input and hidden, and an int8 cache quantizes every K/V head; a value
    on a rounding boundary lands on the next level where an f32 sum was taken
    in another order, so the tolerance is 1e-2 of the largest value (as for
    the int8 SSM decode)."""
    _setenv(monkeypatch, MHA_ENV, *((QUANT_ENV,) if weights == "int8" else ()),
            *(({"APERTIS_QUANT_KV": "1"},) if kv == "int8" else ()))
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)
    jcfg, jparams, model = _pair(seed=6, int8=weights == "int8")
    if weights == "int8":
        model.attach_qkv()
    tol = 1e-4 if weights == "f32" else 1e-2
    for i, (tl, jl, tc, jc) in enumerate(_decode_both(jcfg, jparams, model, kv == "int8")):
        _close(tl, jl, tol, f"logits, step {i}")
        assert set(tc) == set(jc)
        for name in ("k", "v"):
            assert tc[name].dtype == (torch.int8 if kv == "int8" else torch.float32)
            _close(_dequant(tc, name), _dequant(jc, name), tol, f"{name}, step {i}")


# ---- 8. the fused QKV projection ---------------------------------------------------

def test_fused_qkv_is_bit_equal_to_split_projections():
    """The int8 decode with the fused QKV product gives the same logits, to
    the bit, as with three products; a partial bias set is not fused."""
    _, cfg, tree = _tree(seed=10)
    qtree = quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0)
    rng = np.random.default_rng(11)
    ids, mask = _ragged(rng, [9, 4], 9, cfg.vocab_size)
    outs = []
    for fused in (False, True):
        model = from_jax_params(qtree, cfg, device="cpu")
        if fused:
            model.attach_qkv()
            assert model.layers[0].attn.fused_qkv()[0].shape == (128, 384)
        cache = model.init_cache(2, max_length=16, kv_int8=True)
        pre = model.prefill(cache, torch.as_tensor(ids, dtype=torch.long),
                            torch.as_tensor(mask), logit_positions=torch.tensor([8, 3]))
        tok = pre.logits[:, 0].argmax(-1)
        logits = [model.decode_step(cache, tok, t=9 + i, positions=torch.tensor([9, 4]) + i)[0]
                  for i in range(3)]
        outs.append(torch.stack(logits))
    assert torch.equal(outs[0], outs[1])
    attn = qtree["layers"]["attn"]
    parts = [{"w_q": attn[n]["w_q"][0], "w_s": attn[n]["w_s"][0], "b": attn[n]["b"][0]}
             for n in ("q", "k", "v")]
    assert fuse_qkv(parts)["b"].shape == (384,)
    parts[1]["b"] = None
    assert fuse_qkv(parts) is None
    model = from_jax_params(qtree, cfg, device="cpu")
    model.layers[0].attn.k.b = None
    model.attach_qkv()
    assert model.layers[0].attn.fused_qkv() is None
    assert model.layers[1].attn.fused_qkv() is not None


# ---- 9. greedy generation through both engines ------------------------------------

def _ragged_batch():
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, prompt in enumerate(([1, 5, 9, 33, 70, 4, 18], [2, 8], [7, 3, 99, 41])):
        batch[row, :len(prompt)] = prompt
        mask[row, :len(prompt)] = 1
    return batch, mask


@pytest.mark.parametrize("int8,kv_int8", [(False, None), (True, None), (False, True)])
def test_greedy_generate_matches_jax_engine(int8, kv_int8, monkeypatch):
    """Token-exact greedy generation on ragged prompts with an EOS id: f32
    weights with an f32 cache, int8 weights with an int8 cache (the engines'
    defaults for an int8 model: fused QKV, int8 head), and f32 weights with
    the int8 cache asked for (``kv_int8=True``; ``APERTIS_QUANT_KV=1`` in
    JAX)."""
    int8_kv = int8 if kv_int8 is None else kv_int8
    _setenv(monkeypatch, MHA_ENV, *((QUANT_ENV,) if int8 else ()),
            *(({"APERTIS_QUANT_KV": "1"},) if int8_kv else ()))
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)
    jcfg, jparams, model = _pair(seed=12, int8=int8)
    cfg = model.config
    jax_engine, engine = JaxEngine(jcfg, jparams), InferenceEngine(cfg, model, kv_int8)
    assert engine.kv_int8 == int8_kv
    assert (model.layers[0].attn.fused_qkv() is not None) == int8
    batch, mask = _ragged_batch()
    kw = dict(max_new_tokens=10, eos_token_id=())
    free = engine.generate(batch, attention_mask=mask, **kw)
    eos = int(free[1, 9])            # a token row 1 emits, so that it stops early
    kw["eos_token_id"] = (eos,)
    ref = jax_engine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    got = engine.generate(batch, attention_mask=mask, **kw)
    np.testing.assert_array_equal(got, ref)
    assert (got[1, 10:] == cfg.pad_token_id).all()


# ---- 10. gates -------------------------------------------------------------------

def test_gates_and_position_limit():
    """MHA is accepted; MHA with MoE, SwiGLU and absolute positions are not;
    a mixed MHA tree raises; generation past max_position_embeddings raises."""
    check_supported(ApertisConfig(**BASE))
    check_supported(ApertisConfig(**BASE), quantized=True)
    for over in (dict(use_expert_system=True), dict(use_swiglu=True),
                 dict(position_embedding_type="absolute")):
        with pytest.raises(NotImplementedError):
            check_supported(ApertisConfig(**dict(BASE, **over)))
    _, cfg, tree = _tree(seed=13)
    qtree = quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0)
    assert quantized_layout(qtree) and not quantized_layout(tree)
    qtree["layers"]["attn"]["o"] = tree["layers"]["attn"]["o"]
    with pytest.raises(NotImplementedError):
        quantized_layout(qtree)
    engine = InferenceEngine(cfg, from_jax_params(tree, cfg, device="cpu"))
    prompt = np.array([[1, 5, 9]], np.int32)
    assert engine.generate(prompt, max_new_tokens=32, eos_token_id=()).shape == (1, 35)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        engine.generate(prompt, max_new_tokens=33)
