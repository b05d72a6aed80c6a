"""Each kernel's plain PyTorch version vs the JAX kernel and the JAX plain path.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds each
one against its plain version there. Here the plain versions are pinned to the
JAX package: the scan against the XLA ``ssm_mix`` and the interpret-mode
``gated_scan_2d``; the decode step and the FFN against the interpret-mode
``ssm_decode_step_fused`` and ``ffn_decode_fused``, in the bf16 and the int8
weight layouts. The last tests check the device dispatch: CPU tensors take
the plain path and launch nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.models.quantize import quantize_weight as jax_quantize_weight
from apertis_llm_tpu.models.ssm_fuse import attach_fused_ssm_params
from apertis_llm_tpu.ops import ssm as jax_ssm
from apertis_llm_tpu.ops.pallas.ffn_fused import ffn_decode_fused
from apertis_llm_tpu.ops.pallas.quant_matmul import quantize_rows as jax_quantize_rows
from apertis_llm_tpu.ops.pallas.ssm_step import ssm_decode_step_fused
from apertis_llm_torch.ops import ssm as torch_ssm
from apertis_llm_torch.ops.kernels.ffn_fused import (
    ffn_decode, ffn_decode_int8, ffn_decode_int8_reference, ffn_decode_reference,
    pick_block_n)
from apertis_llm_torch.ops.kernels.ln_quant import ln_quantize
from apertis_llm_torch.ops.kernels.ssm_scan import (
    selective_scan_fwd, selective_scan_fwd_reference)
from apertis_llm_torch.ops.kernels.ssm_step import (
    MixerWeights, ssm_decode_step, ssm_decode_step_int8, ssm_decode_step_reference)

torch.set_num_threads(2)


def _scan_inputs(seq_len, masked, seed=7):
    rng = np.random.default_rng(seed)
    b, h, n = 2, 3, 8
    delta = rng.uniform(0.01, 2.0, (b, seq_len, h)).astype(np.float32)
    a_cont = -rng.uniform(0.1, 1.5, (h, n)).astype(np.float32)
    bt = rng.normal(size=(b, seq_len, h, n)).astype(np.float32)
    ct = rng.normal(size=(b, seq_len, h, n)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(seq_len)[None, :]
                < np.asarray([seq_len, seq_len - 37])[:, None]).astype(np.int32)
    return delta, a_cont, bt, ct, mask


@pytest.mark.parametrize("seq_len", [130, 700])
@pytest.mark.parametrize("masked", [False, True])
def test_scan_matches_jax(seq_len, masked, monkeypatch):
    """L = 130 and 700 are not multiples of the TPU kernel's 128/512 tiles."""
    delta, a_cont, bt, ct, mask = _scan_inputs(seq_len, masked)
    j_mask = None if mask is None else jnp.asarray(mask)
    jargs = (jnp.asarray(delta), jnp.asarray(a_cont), jnp.asarray(bt), jnp.asarray(ct))
    monkeypatch.setenv("APERTIS_SSM_KERNEL", "xla")
    y_xla, h_xla = jax_ssm.ssm_mix(*jargs, seq_mask=j_mask)
    monkeypatch.setenv("APERTIS_SSM_KERNEL", "pallas")
    with pltpu.force_tpu_interpret_mode():
        y_pal, h_pal = jax_ssm.ssm_mix(*jargs, seq_mask=j_mask)

    y, h_last = torch_ssm.ssm_mix(
        *(torch.from_numpy(a) for a in (delta, a_cont, bt, ct)),
        seq_mask=None if mask is None else torch.from_numpy(mask))
    assert y.shape == (2, seq_len, 24) and h_last.dtype == torch.float32
    for y_ref, h_ref in ((y_xla, h_xla), (y_pal, h_pal)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(h_ref), rtol=2e-5, atol=2e-5)


def _bf16_layer(rms, seed=0):
    """A bf16 JAX parameter tree (perturbed) and its fused-step pack."""
    config = JaxConfig(
        vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        use_rmsnorm=rms, max_position_embeddings=64)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x, np.float32)
                   + rng.normal(0.0, 0.05, x.shape).astype(np.float32)).astype(jnp.bfloat16),
        jax_init_params(jax.random.PRNGKey(seed), config))
    params = jax.tree.map(jnp.asarray, params)
    return config, params, attach_fused_ssm_params(params, config)["layers"]["attn"]["fused"]


def _t(x):
    """JAX array -> torch tensor of the same values (bf16 stays bf16, int8
    stays int8)."""
    if x.dtype == jnp.int8:
        return torch.from_numpy(np.array(x))
    arr = np.asarray(jnp.asarray(x, jnp.float32))
    return torch.from_numpy(arr.copy()).to(torch.bfloat16 if x.dtype == jnp.bfloat16
                                           else torch.float32)


def _mixer_weights(params, layer, rms):
    a = jax.tree.map(lambda x: x[layer], params["layers"]["attn"])
    pre = a["pre_norm"]
    return MixerWeights(
        _t(pre["scale"] if rms else pre["w"]), None if rms else _t(pre["b"]),
        _t(a["in_proj_x"]["w"]), _t(a["in_proj_z"]["w"]), _t(a["conv"]["w"]),
        _t(a["conv"]["b"]), _t(a["x_param_proj"]["w"]), _t(a["dt_proj"]["w"]),
        _t(a["dt_proj"]["b"]), _t(a["A_log"]), _t(a["D"]), _t(a["out_proj"]["w"]))


@pytest.mark.parametrize("ffn_mode", ["none", "dense"])
@pytest.mark.parametrize("rms", [False, True])
def test_decode_step_matches_jax_fused_kernel(ffn_mode, rms):
    """Plain decode step vs the interpret-mode fused TPU kernel on a bf16
    pack. f32 outputs agree to 2e-3 of their largest value (the tolerance of
    tests/test_ssm_step.py); bf16 outputs to one bf16 ulp of it (2^-7)."""
    config, params, fused = _bf16_layer(rms)
    rng = np.random.default_rng(11)
    b, d, c = 5, config.hidden_size, config.ssm_d_inner
    h = jnp.asarray(rng.normal(0, 1.0, (b, d)), jnp.bfloat16)
    conv = jnp.asarray(rng.normal(0, 0.5, (b, 3, c)), jnp.bfloat16)
    ssm = jnp.asarray(rng.normal(0, 0.5, (b, c)), jnp.float32)
    layer = 1
    ref = ssm_decode_step_fused(h, conv, ssm, fused, layer, config.layer_norm_eps,
                                rms, ffn_mode=ffn_mode)
    ffn_norm = None
    if ffn_mode == "dense":
        pre2 = jax.tree.map(lambda x: x[layer], params["layers"]["ffn"]["pre_norm"])
        ffn_norm = (_t(pre2["scale"]), None) if rms else (_t(pre2["w"]), _t(pre2["b"]))
    got = ssm_decode_step_reference(
        _t(h), _t(conv), _t(ssm), _mixer_weights(params, layer, rms),
        config.layer_norm_eps, ffn_norm=ffn_norm)
    assert len(got) == len(ref) == (4 if ffn_mode == "dense" else 3)
    for name, g, r in zip(("h_out", "x_proj", "ssm", "ffn_in"), got, ref):
        r = np.asarray(jnp.asarray(r, jnp.float32))
        assert g.dtype == (torch.float32 if name == "ssm" else torch.bfloat16), name
        tol = 2e-3 if name == "ssm" else 2.0 ** -7
        err = np.abs(g.float().numpy() - r).max()
        assert err <= tol * np.abs(r).max(), (name, err)


def _mixer_weights_int8(qparams, layer, rms):
    """The int8 layer of a ``quantize_params(min_size=0)`` tree as the port's
    weights: the JAX int8 leaves and scales as they are."""
    a = jax.tree.map(lambda x: x[layer], qparams["layers"]["attn"])
    pre = a["pre_norm"]
    return MixerWeights(
        _t(pre["scale"] if rms else pre["w"]), None if rms else _t(pre["b"]),
        _t(a["in_proj_x"]["w_q"]), _t(a["in_proj_z"]["w_q"]), _t(a["conv"]["w"]),
        _t(a["conv"]["b"]), _t(a["x_param_proj"]["w_q"]), _t(a["dt_proj"]["w"]),
        _t(a["dt_proj"]["b"]), _t(a["A_log"]), _t(a["D"]), _t(a["out_proj"]["w_q"]),
        *(_t(a[k]["w_s"]) for k in ("in_proj_x", "in_proj_z", "x_param_proj", "out_proj")))


def _assert_int8_close(q, q_ref, name):
    """int8 outputs: the JAX package's tolerance for its quantizing kernels
    (tests/test_pallas_kernels.py:270): an element on a rounding boundary may
    flip by one level, under 1e-3 of the elements."""
    dq = np.abs(q.numpy().astype(int) - np.asarray(q_ref).astype(int))
    assert dq.max() <= 1 and (dq > 0).mean() < 1e-3, (name, dq.max(), (dq > 0).mean())


@pytest.mark.parametrize("ffn_mode", ["none", "dense"])
@pytest.mark.parametrize("rms", [False, True])
def test_int8_decode_step_matches_jax_fused_kernel(ffn_mode, rms):
    """Plain int8 decode step vs the interpret-mode fused TPU kernel on the
    int8 pack of a ``quantize_params(min_size=0)`` tree, 40 rows. f32 and
    bf16 outputs as in the bf16 test (2e-3 and 2^-7 of the largest value);
    ``x_q`` to the int8 tolerance; ``x_s`` to one bf16 ulp (2^-7 relative):
    it is the absmax of a bf16-rounded row over 127, so a flipped bf16
    rounding upstream moves it by one bf16 step."""
    config, params, _ = _bf16_layer(rms, seed=2)
    qparams = jax_quantize_params(params, min_size=0)
    fused = attach_fused_ssm_params(qparams, config)["layers"]["attn"]["fused"]
    assert "inx_wq" in fused
    rng = np.random.default_rng(12)
    b, d, c = 40, config.hidden_size, config.ssm_d_inner
    h = jnp.asarray(rng.normal(0, 1.0, (b, d)), jnp.bfloat16)
    conv = jnp.asarray(rng.normal(0, 0.5, (b, 3, c)), jnp.bfloat16)
    ssm = jnp.asarray(rng.normal(0, 0.5, (b, c)), jnp.float32)
    layer = 1
    ref = ssm_decode_step_fused(h, conv, ssm, fused, layer, config.layer_norm_eps,
                                rms, ffn_mode=ffn_mode)
    ffn_norm = None
    if ffn_mode == "dense":
        pre2 = jax.tree.map(lambda x: x[layer], params["layers"]["ffn"]["pre_norm"])
        ffn_norm = (_t(pre2["scale"]), None) if rms else (_t(pre2["w"]), _t(pre2["b"]))
    w = _mixer_weights_int8(qparams, layer, rms)
    assert w.quantized and w.inx_w.dtype == torch.int8
    got = ssm_decode_step(_t(h), _t(conv), _t(ssm), w, config.layer_norm_eps,
                          ffn_norm=ffn_norm)
    assert len(got) == len(ref) == (5 if ffn_mode == "dense" else 3)
    for name, g, r in zip(("h_out", "x_proj", "ssm"), got, ref):
        r = np.asarray(jnp.asarray(r, jnp.float32))
        tol = 2e-3 if name == "ssm" else 2.0 ** -7
        err = np.abs(g.float().numpy() - r).max()
        assert err <= tol * np.abs(r).max(), (name, err)
    if ffn_mode == "dense":
        assert got[3].dtype == torch.int8 and got[4].shape == (b, 1)
        _assert_int8_close(got[3], ref[3], "x_q")
        np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=2.0 ** -7)
    assert ssm_decode_step.launches == ssm_decode_step_int8.launches == 0


@pytest.mark.parametrize("inter", [256, 1536])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_int8_ffn_matches_jax_fused_kernel(inter, act):
    """Plain int8 FFN vs the interpret-mode TPU kernel with the int8 layout.
    I = 256 is one hidden tile, I = 1536 two tiles of 768 (each requantized
    with its own per-row scale). With ReLU both sides compute the same
    exact integer products and f32 scalings: 1e-5 of the largest output.
    With GELU the TPU kernel's tanh-form erf (|err| <= 3.7e-5) can flip a
    hidden value's int8 level, one hidden step of one weight: 2e-3 of it."""
    assert pick_block_n(inter) == {256: 256, 1536: 768}[inter]
    r = np.random.default_rng(4)
    s_, d = 9, 128
    x = (r.standard_normal((s_, d)) * 0.5).astype(np.float32)
    w1 = (r.standard_normal((d, inter)) * 0.05).astype(np.float32)
    w2 = (r.standard_normal((inter, d)) * 0.05).astype(np.float32)
    b1 = (r.standard_normal((inter,)) * 0.02).astype(np.float32)
    b2 = (r.standard_normal((d,)) * 0.02).astype(np.float32)
    xq, xs = jax_quantize_rows(jnp.asarray(x))
    (w1q, w1s), (w2q, w2s) = jax_quantize_weight(jnp.asarray(w1)), jax_quantize_weight(jnp.asarray(w2))
    ref = np.asarray(ffn_decode_fused(xq, xs, w1q, w1s, jnp.asarray(b1), w2q, w2s,
                                      jnp.asarray(b2), out_dtype=jnp.float32,
                                      hidden_act=act))
    got = ffn_decode_int8(*(_t(a) for a in (xq, xs, w1q, w1s, jnp.asarray(b1), w2q, w2s,
                                            jnp.asarray(b2))), act, out_dtype=torch.float32)
    tol = 1e-5 if act == "relu" else 2e-3
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()
    assert ffn_decode_int8.launches == 0


def _ffn_inputs(dtype, seed=3, s=5, d=128, inter=256):
    r = np.random.default_rng(seed)
    w1 = (r.standard_normal((d, inter)) * 0.05).astype(np.float32)
    b1 = (r.standard_normal((inter,)) * 0.02).astype(np.float32)
    w2 = (r.standard_normal((inter, d)) * 0.05).astype(np.float32)
    b2 = (r.standard_normal((d,)) * 0.02).astype(np.float32)
    x = (r.standard_normal((s, d)) * 0.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = [jnp.asarray(a, dtype) for a in (w1, b1, w2, b2)]
    return jx, jw


@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
def test_ffn_matches_jax_fused_kernel(weights):
    """bf16-layout FFN (no quantization) vs the interpret-mode TPU kernel.
    With f32 weights the hidden is not rounded and the tolerance (1e-4 of the
    largest output) absorbs the TPU kernel's tanh-form erf (|err| <= 3.7e-5);
    with bf16 weights a flipped bf16 rounding of a hidden value is allowed
    (one bf16 ulp of the largest output, 2^-7)."""
    dtype = jnp.float32 if weights == "float32" else jnp.bfloat16
    jx, (w1, b1, w2, b2) = _ffn_inputs(dtype)
    ref = np.asarray(ffn_decode_fused(jx, None, w1, None, b1, w2, None, b2,
                                      out_dtype=jnp.float32, block_n=128))
    got = ffn_decode_reference(_t(jx), _t(w1), _t(b1), _t(w2), _t(b2),
                               "gelu", out_dtype=torch.float32)
    tol = 1e-4 if weights == "float32" else 2.0 ** -7
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


def test_cpu_tensors_take_plain_path():
    """On CPU tensors every wrapper returns its plain version's result and
    launches no kernel."""
    counters = (selective_scan_fwd, ssm_decode_step, ffn_decode)
    before = [f.launches for f in counters]
    delta, a_cont, bt, ct, mask = _scan_inputs(33, True)
    args = [torch.from_numpy(a) for a in (delta, a_cont, bt, ct)]
    m = torch.from_numpy(mask)
    for got, ref in zip(selective_scan_fwd(*args, m), selective_scan_fwd_reference(*args, m)):
        assert torch.equal(got, ref)

    config, params, _ = _bf16_layer(rms=False)
    w = _mixer_weights(params, 0, False)
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32)).to(torch.bfloat16)
    conv = torch.zeros((3, 3, 64), dtype=torch.bfloat16)
    ssm = torch.zeros((3, 64), dtype=torch.float32)
    norm = (w.norm_w, w.norm_b)
    for got, ref in zip(ssm_decode_step(h, conv, ssm, w, 1e-12, norm),
                        ssm_decode_step_reference(h, conv, ssm, w, 1e-12, norm)):
        assert torch.equal(got, ref)

    jx, jw = _ffn_inputs(jnp.bfloat16)
    ffn_args = [_t(jx)] + [_t(a) for a in jw]
    assert torch.equal(ffn_decode(*ffn_args), ffn_decode_reference(*ffn_args))
    assert [f.launches for f in counters] == before == [0, 0, 0]


def test_decode_step_writes_state_in_place():
    """``ssm_out=ssm_state`` updates the state in place with the same values
    that a separate output gets, and returns that tensor."""
    config, params, _ = _bf16_layer(rms=False)
    w = _mixer_weights(params, 0, False)
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32)).to(torch.bfloat16)
    conv = torch.from_numpy(rng.normal(size=(3, 3, 64)).astype(np.float32)).to(torch.bfloat16)
    ssm = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    norm = (w.norm_w, w.norm_b)
    ref = ssm_decode_step(h, conv, ssm, w, 1e-12, norm)
    got = ssm_decode_step(h, conv, ssm, w, 1e-12, norm, ssm_out=ssm)
    assert got[2] is ssm and torch.equal(ssm, ref[2])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert ssm_decode_step.launches == 0


def test_int8_cpu_tensors_take_plain_path():
    """The int8 wrappers and ``ln_quantize`` on CPU tensors return their
    plain versions' results and launch nothing."""
    r = np.random.default_rng(6)
    xq, xs = jax_quantize_rows(jnp.asarray(r.standard_normal((3, 128)), jnp.float32))
    (w1q, w1s) = jax_quantize_weight(jnp.asarray(r.standard_normal((128, 256)) * 0.05))
    (w2q, w2s) = jax_quantize_weight(jnp.asarray(r.standard_normal((256, 128)) * 0.05))
    args = [_t(a) for a in (xq, xs, w1q, w1s)] + [torch.zeros(256)] + \
        [_t(a) for a in (w2q, w2s)] + [torch.zeros(128)]
    assert torch.equal(ffn_decode_int8(*args), ffn_decode_int8_reference(*args))
    config, params, _ = _bf16_layer(rms=True)
    w = _mixer_weights_int8(jax_quantize_params(params, min_size=0), 0, True)
    h = torch.from_numpy(r.normal(size=(3, 128)).astype(np.float32)).to(torch.bfloat16)
    conv = torch.zeros((3, 3, 64), dtype=torch.bfloat16)
    ssm = torch.zeros((3, 64), dtype=torch.float32)
    norm = (w.norm_w, None)
    for got, ref in zip(ssm_decode_step_int8(h, conv, ssm, w, 1e-12, norm),
                        ssm_decode_step_reference(h, conv, ssm, w, 1e-12, norm)):
        assert torch.equal(got, ref)
    q, s = ln_quantize(h, w.norm_w, None, 1e-12)
    assert q.dtype == torch.int8 and s.shape == (3, 1)
    assert ssm_decode_step_int8.launches == ffn_decode_int8.launches == 0
    assert ln_quantize.launches == 0


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is not on the CPU goes to the kernel or raises; the meta
    device has no kernel, so the wrappers raise before any launch."""
    x = torch.empty((2, 128), dtype=torch.bfloat16, device="meta")
    w = torch.empty((128, 256), dtype=torch.bfloat16, device="meta")
    b1 = torch.empty((256,), dtype=torch.bfloat16, device="meta")
    w2 = torch.empty((256, 128), dtype=torch.bfloat16, device="meta")
    b2 = torch.empty((128,), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ffn_decode(x, w, b1, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_fwd(torch.empty((1, 4, 2), device="meta"),
                           torch.empty((2, 3), device="meta"),
                           torch.empty((1, 4, 2, 3), device="meta"),
                           torch.empty((1, 4, 2, 3), device="meta"))
    i8 = dict(dtype=torch.int8, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ffn_decode_int8(torch.empty((2, 128), **i8), torch.empty((2, 1), **f32),
                        torch.empty((128, 256), **i8), torch.empty((1, 256), **f32), b1,
                        torch.empty((256, 128), **i8), torch.empty((1, 128), **f32), b2)
    with pytest.raises(ValueError, match="CUDA"):
        ln_quantize(x, b2, None, 1e-12)
    assert ffn_decode.launches == 0 and selective_scan_fwd.launches == 0
    assert ffn_decode_int8.launches == 0 and ln_quantize.launches == 0
