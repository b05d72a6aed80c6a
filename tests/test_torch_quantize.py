"""The port's int8 quantization and int8 arithmetic vs the JAX package's.

``quantize_params`` / ``quantize_tied_head`` must give the JAX package's int8
weights bit for bit and its scales exactly; the plain ``ln_quantize`` must
match the JAX kernel (interpret mode) to the JAX package's own tolerance;
``quantize_rows`` and the w8a8 linear match ``quant_matmul.py``. The last
tests pin the entry points' default device and the refusal of mixed trees.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models import quantize as jax_quantize
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.ops.pallas.ln_quant import ln_quantize as jax_ln_quantize
from apertis_llm_tpu.ops.pallas.quant_matmul import quant_matmul_dyn_xla
from apertis_llm_tpu.ops.pallas.quant_matmul import quantize_rows as jax_quantize_rows
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models import quantize as torch_quantize
from apertis_llm_torch.models.apertis import ApertisForCausalLM
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.params import init_params
from apertis_llm_torch.ops.kernels.ln_quant import ln_quantize
from apertis_llm_torch.ops.quant import linear_dyn, quantize_rows

torch.set_num_threads(2)

BASE = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            attention_type="selective_ssm", ssm_d_state=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=64)


def _tree(seed=0, dtype=np.float32, **over):
    """A perturbed JAX parameter tree as numpy arrays."""
    jcfg = JaxConfig(**dict(BASE, **over))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32)
                   + rng.normal(0.0, 0.02, x.shape).astype(np.float32)).astype(dtype),
        jax_init_params(jax.random.PRNGKey(seed), jcfg))


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()), tree)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


def _assert_trees_equal(got, ref):
    """Same names; int8 leaves bit-equal; float leaves equal."""
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        r = np.asarray(r)
        g = got[name].numpy()
        assert g.dtype == (np.int8 if r.dtype == np.int8 else np.float32), name
        np.testing.assert_array_equal(g, r.astype(g.dtype), err_msg=name)


@pytest.mark.parametrize("min_size", [0, 1024, 1 << 16])
def test_quantize_params_matches_jax(min_size):
    """min_size counts the elements of the layer-stacked weight: 0 and 1024
    take all six projections of this small model, the default 1 << 16 only
    the two FFN weights (2 x 128 x 256 each), a mixed tree. The skip lists
    keep embed, norms, dt_proj and conv float in every case."""
    tree = _tree()
    ref = jax_quantize.quantize_params(jax.tree.map(jnp.asarray, tree), min_size=min_size)
    got = torch_quantize.quantize_params(_to_torch(tree), min_size=min_size)
    _assert_trees_equal(got, ref)
    layers = _flat(got["layers"])
    n_int8 = sum(1 for k in layers if k.endswith("w_q"))
    assert n_int8 == (6 if min_size <= 1024 else 2)
    for skipped in ("attn/dt_proj/w", "attn/conv/w", "attn/pre_norm/w", "ffn/pre_norm/w"):
        assert skipped in layers and layers[skipped].dtype == torch.float32


def test_quantize_tied_head_and_tree_is_quantized_match_jax():
    tree = _tree(seed=1)
    jq = jax_quantize.quantize_params(jax.tree.map(jnp.asarray, tree), min_size=0)
    tq = torch_quantize.quantize_params(_to_torch(tree), min_size=0)
    assert torch_quantize.tree_is_quantized(tq) and jax_quantize.tree_is_quantized(jq)
    assert not torch_quantize.tree_is_quantized(_to_torch(tree))
    ref = jax_quantize.quantize_tied_head(jq)
    got = torch_quantize.quantize_tied_head(tq)
    assert got["lm_head"]["w_q"].shape == (128, 131)
    _assert_trees_equal(got, ref)
    assert torch_quantize.quantize_tied_head(got) is got      # attached once


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rms", [False, True])
def test_ln_quantize_matches_jax_kernel(rms, dtype):
    """Plain ``ln_quantize`` vs the interpret-mode TPU kernel on 37 ragged
    rows with a zero row. The JAX package's own tolerance
    (tests/test_pallas_kernels.py:270): an element on a rounding boundary may
    flip by one level (|dq| <= 1, under 1e-3 of the elements flip) and the
    scales agree to 1e-6 relative."""
    r = np.random.default_rng(0)
    x = (r.standard_normal((37, 256)) * 2.0).astype(np.float32)
    x[5] = 0.0
    w = (1.0 + 0.1 * r.standard_normal(256)).astype(np.float32)
    b = (0.05 * r.standard_normal(256)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    q_ref, s_ref = jax_ln_quantize(jx, jnp.asarray(w), None if rms else jnp.asarray(b),
                                   eps=1e-5, rms=rms)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q, s = ln_quantize(tx, torch.from_numpy(w), None if rms else torch.from_numpy(b), 1e-5)
    assert q.dtype == torch.int8 and q.shape == (37, 256) and s.shape == (37, 1)
    dq = np.abs(q.numpy().astype(int) - np.asarray(q_ref).astype(int))
    assert dq.max() <= 1 and (dq > 0).mean() < 1e-3, dq.max()
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)
    assert ln_quantize.launches == 0


def test_quantize_rows_and_linear_dyn_match_jax():
    """``quantize_rows`` is bit-equal to the JAX function; the w8a8 linear
    agrees with ``quant_matmul_dyn_xla`` to f32 rounding (both sum the same
    exact int32 products and apply the same two scale multiplies)."""
    r = np.random.default_rng(3)
    x = (r.standard_normal((2, 7, 128)) * 1.5).astype(np.float32)
    w = (r.standard_normal((128, 48)) * 0.05).astype(np.float32)
    q_ref, s_ref = jax_quantize_rows(jnp.asarray(x))
    q, s = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    wq, ws = jax_quantize.quantize_weight(jnp.asarray(w))
    ref = np.asarray(quant_matmul_dyn_xla(jnp.asarray(x), wq, ws))
    got = linear_dyn(torch.from_numpy(x), torch.from_numpy(np.asarray(wq)),
                     torch.from_numpy(np.asarray(ws)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_mixed_tree_is_refused():
    """A tree with some projections int8 and others float is refused
    (the JAX package would serve it through its unfused path)."""
    tq = torch_quantize.quantize_params(_to_torch(_tree()), min_size=0)
    w = tq["layers"]["ffn"]["w2"]
    tq["layers"]["ffn"]["w2"] = {"w": w["w_q"].float() * w["w_s"], "b": w["b"]}
    with pytest.raises(NotImplementedError, match="all int8 or all float"):
        from_jax_params(tq, ApertisConfig(**BASE), device="cpu")


@pytest.mark.parametrize("entry", ["ApertisForCausalLM", "from_jax_params", "init_params"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With no CUDA device and no device named, the entry points raise
    instead of building on the CPU; ``device="cpu"`` builds there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = ApertisConfig(**BASE)
    tree = _to_torch(_tree())
    build = {
        "ApertisForCausalLM": lambda **kw: ApertisForCausalLM(config, **kw),
        "from_jax_params": lambda **kw: from_jax_params(tree, config, **kw),
        "init_params": lambda **kw: init_params(config, torch.Generator(), **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    built = build(device="cpu")
    leaf = built["embed"]["tok"] if isinstance(built, dict) else built.embed.tok
    assert leaf.device.type == "cpu"

