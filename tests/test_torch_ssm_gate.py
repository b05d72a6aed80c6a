"""Shapes the SSM decode step (kernel #3) takes, held against the gate
``check_supported``, and a MoE model with more experts than a warp has
lanes, against the JAX package, on the CPU.

On the card, ``models/apertis.py`` calls ``ssm_decode_step`` on every SSM
decode step: a shape the gate admits must reach the kernel, not a
``ValueError`` inside ``generate``. The gate and the kernel take every
hidden and mixer width, as the JAX kernel does. A model with 40 experts
decodes every step through the step's moe epilogue, whose router takes any
number of experts, as the JAX kernel's does: both packages take the same
route to the same logits.
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
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.quantize import quantize_tied_head as jax_quantize_tied_head
from apertis_llm_tpu.models.ssm_fuse import attach_fused_ssm_params
from apertis_llm_tpu.ops import activations as jax_activations
from apertis_llm_tpu.ops.pallas import moe_ffn as jax_moe_ffn
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models import apertis as torch_model
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.params import check_supported
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops.kernels import ssm_step
from apertis_llm_torch.ops.kernels.ssm_step import MixerWeights

torch.set_num_threads(2)

SSM = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=8,
           intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
           max_position_embeddings=128, decode_max_length=64)
MANY = dict(SSM, intermediate_size=128, use_expert_system=True, num_experts=40,
            experts_per_token=2)
SERVE_ENV = {"APERTIS_MOE_GROUPED": "force", "APERTIS_SSM_STEP": "force",
             "APERTIS_MOE_FUSED": "fatk"}
QUANT_ENV = {"APERTIS_QUANT_MATMUL": "dyn", "APERTIS_LN_QUANT": "force",
             "APERTIS_FFN_FUSED": "force"}


def _step_args(d, heads, n, r=8, k=4):
    """CPU tensors of the step's shapes at hidden width d and heads x n."""
    c = heads * n
    z = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)   # noqa: E731
    w = MixerWeights(z(d), z(d), z(d, c), z(d, c), z(c, k), z(c), z(c, r + 2 * c), z(r, heads),
                     z(heads), z(heads, n), z(c), z(c, d))
    return (z(3, d), z(3, k - 1, c), torch.zeros((3, c)), w, 1e-5, None, None, None)


def test_every_admitted_ssm_width_reaches_the_step_kernel():
    """Every hidden width D and mixer width C (heads x d_state), multiples of
    4 or not, is admitted by ``check_supported`` and passes the step
    launch's width checks (on CPU tensors it then stops at the device
    check), so the model decodes through #3 on the card at each of them."""
    admitted = []
    for d, heads, n in ((128, 8, 16), (120, 4, 12), (132, 6, 2), (128, 4, 6), (126, 6, 16),
                        (130, 2, 16), (126, 7, 4), (120, 3, 5), (120, 5, 6)):
        cfg = ApertisConfig(**dict(SSM, hidden_size=d, num_attention_heads=heads,
                                   ssm_d_state=n))
        check_supported(cfg)
        check_supported(cfg, quantized=True)
        admitted.append((d, heads, n))
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            ssm_step._launch_step("apertis_ssm_decode_step", *_step_args(d, heads, n))
    assert len(admitted) == 9


@pytest.fixture
def exact_gelu(monkeypatch):
    monkeypatch.setitem(jax_moe_ffn._KERNEL_ACTS, "gelu", jax_activations.gelu)


def _tree(seed):
    cfg = JaxConfig(**MANY)
    rng = np.random.default_rng(seed)
    return cfg, jax.tree.map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
        jax_init_params(jax.random.PRNGKey(seed), cfg))


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


@pytest.mark.parametrize("int8", [False, True])
def test_many_experts_decode_with_the_epilogue_matches_jax(int8, monkeypatch, exact_gelu):
    """A 2-layer SSM MoE model with 40 experts (more than a warp's 32
    lanes): ragged prefill of 3 x 12 tokens and four decode steps of 3 rows
    against the JAX model (whose step runs its moe epilogue over the 40
    experts) on the same weights, the fat stack attached as the engines
    attach it: logits within 1e-2 of their largest value, the MoE tolerance
    of tests/test_torch_moe.py (a flipped int8 level of the FFN input moves a
    logit by up to about 0.5 % of the largest). Every port step runs the moe
    epilogue, as the JAX step does."""
    for key, value in {**SERVE_ENV, **(QUANT_ENV if int8 else {})}.items():
        monkeypatch.setenv(key, value)
    cfg, tree = _tree(16)
    jparams = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.from_numpy, tree)
    if int8:
        jparams = jax_quantize_tied_head(jax_quantize_params(jparams, min_size=0))
        ttree = quantize_params(ttree, min_size=0)
    jparams = attach_fused_ssm_params(attach_fused_decode_params(jparams, mode="fat"), cfg)
    experts = jparams["layers"]["attn"]["fused"]["router_w"].shape[-1]
    assert experts == 40 > 32
    model = from_jax_params(ttree, ApertisConfig(**MANY), device="cpu")
    if int8:
        model.quantize_tied_head()
    model.attach_moe_fat()
    calls = _epilogue_calls(monkeypatch)
    rng = np.random.default_rng(17)
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
    step = jax.jit(lambda p, c, tok: jax_model.decode_step(
        p, cfg, c, tok, jnp.asarray(0, jnp.int32)))
    jcache, tcache = jpre.cache, tpre.cache
    tok = np.array(jnp.argmax(jpre.logits[:, 0], axis=-1), np.int32)
    for i in range(4):
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tok))
        tlogits, tcache = model.decode_step(tcache, torch.as_tensor(tok, dtype=torch.long))
        close(tlogits, jlogits, f"decode step {i}")
        tok = np.asarray(jlogits).argmax(axis=-1).astype(np.int32)
    assert len(calls) == 4 * MANY["num_hidden_layers"] and all(calls)


def test_many_experts_greedy_generate_matches_jax_engine(monkeypatch, exact_gelu):
    """Greedy int8 serving of the 40-expert model through both engines,
    token-exact: both engines' decode steps run the moe epilogue."""
    for key, value in {**SERVE_ENV, **QUANT_ENV}.items():
        monkeypatch.setenv(key, value)
    cfg, tree = _tree(18)
    jax_engine = JaxEngine(cfg, jax_quantize_params(jax.tree.map(jnp.asarray, tree),
                                                    min_size=0))
    model = from_jax_params(quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0),
                            ApertisConfig(**MANY), device="cpu")
    engine = InferenceEngine(ApertisConfig(**MANY), model)
    calls = _epilogue_calls(monkeypatch)
    batch = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), np.int32)
    for row, prompt in enumerate(([1, 5, 9, 33, 70, 4, 18], [2, 8], [7, 3, 99, 41])):
        batch[row, :len(prompt)] = prompt
        mask[row, :len(prompt)] = 1
    kw = dict(max_new_tokens=6, eos_token_id=())
    ref = jax_engine.generate(batch, attention_mask=mask, rng=jax.random.PRNGKey(0), **kw)
    got = engine.generate(batch, attention_mask=mask, **kw)
    assert got.shape == (3, 13)
    np.testing.assert_array_equal(got, ref)
    assert calls and all(calls)
