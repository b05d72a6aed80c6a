"""The port's backward kernels' plain versions vs the JAX package's VJPs (CPU).

Inputs and cotangents are made with numpy from a seed and handed to both
packages. The JAX side differentiates ``ops/ssm.py::ssm_mix`` with
``APERTIS_SSM_KERNEL=pallas`` (``gated_scan_2d`` and its custom VJP, whose
reverse scan is ``selective_scan_pallas``'s core) and ``flash_attention``
(blocks of 128), both under ``pltpu.force_tpu_interpret_mode()``, as
``tests/test_pallas_kernels.py`` runs them. On the CPU the port's
``SelectiveScan`` and ``FlashAttention`` take the plain versions of their
kernels (``selective_scan_bwd_reference``, ``flash_attention_dq_reference``,
``flash_attention_dkv_reference``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from apertis_llm_tpu.ops import ssm as jax_ssm
from apertis_llm_tpu.ops.pallas import flash_attention as jax_flash
from apertis_llm_torch.ops import ssm as port_ssm
from apertis_llm_torch.ops.kernels.flash_attention import (
    FlashAttention, flash_attention_dkv_f32, flash_attention_dkv_reference,
    flash_attention_dq_f32, flash_attention_dq_reference, flash_attention_fwd_f32,
    flash_attention_fwd_reference)
from apertis_llm_torch.ops.kernels.ssm_scan import (
    selective_scan_bwd, selective_scan_bwd_reference, selective_scan_bwd_smem,
    selective_scan_fwd_reference)

torch.set_num_threads(2)

# f32 on both sides; the JAX kernel scans by a Hillis-Steele ladder and
# reduces over N and (B, L) in other orders than the port's step-by-step
# loop, so each gradient agrees to 1e-4 of its largest value (the JAX
# package's own Pallas-vs-XLA gradient check allows 2e-4).
GRAD_TOL = 1e-4


def _close(got, ref, tol, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: {err:.3e} vs {np.abs(ref).max():.3e}"


def _scan_inputs(seed, b=2, l=150, h=3, n=8, masked=False):
    rng = np.random.default_rng(seed)
    delta = rng.uniform(0.01, 2.0, (b, l, h)).astype(np.float32)
    a_cont = -rng.uniform(0.1, 1.5, (h, n)).astype(np.float32)
    bt = rng.normal(size=(b, l, h, n)).astype(np.float32)
    ct = rng.normal(size=(b, l, h, n)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(l)[None, :] < np.asarray([l, l - 37])[:, None]).astype(np.int32)
    gy = rng.normal(size=(b, l, h * n)).astype(np.float32)
    g_last = rng.normal(size=(b, h, n)).astype(np.float32)
    return delta, a_cont, bt, ct, mask, gy, g_last


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_h_last", [False, True])
def test_scan_grads_match_jax_vjp(monkeypatch, masked, with_h_last):
    """``ssm_mix``'s gradients (``d_delta``, ``dA``, ``dB``, ``dC``) through
    the port's ``SelectiveScan`` against ``jax.grad`` through the JAX
    ``ssm_mix`` on its Pallas path, at L = 150 (not a multiple of 128), with
    and without a mask and an ``h_last`` cotangent."""
    delta, a_cont, bt, ct, mask, gy, g_last = _scan_inputs(1, masked=masked)
    g_last = g_last if with_h_last else np.zeros_like(g_last)

    monkeypatch.setenv("APERTIS_SSM_KERNEL", "pallas")

    def jax_loss(d, a, b, c):
        y, hl = jax_ssm.ssm_mix(d, a, b, c, seq_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(y * gy) + jnp.sum(hl * g_last)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(x) for x in (delta, a_cont, bt, ct)))

    args = [torch.tensor(x, requires_grad=True) for x in (delta, a_cont, bt, ct)]
    y, hl = port_ssm.ssm_mix(*args, seq_mask=None if mask is None else torch.from_numpy(mask))
    loss = (y * torch.from_numpy(gy)).sum()
    if with_h_last:
        loss = loss + (hl * torch.from_numpy(g_last)).sum()
    got = torch.autograd.grad(loss, args)
    for name, g, r in zip(("d_delta", "dA", "dB", "dC"), got, ref):
        _close(g.numpy(), r, GRAD_TOL, name)
    if masked:
        # A masked step takes no gradient through delta or B.
        pad = mask == 0
        assert np.all(got[0].numpy()[pad] == 0) and np.all(got[2].numpy()[pad] == 0)


def test_scan_bwd_reference_is_the_forward_gradient():
    """The plain backward equals autograd through the plain forward (in
    float64, where the two compute the same sums: exact up to rounding)."""
    delta, a_cont, bt, ct, _, gy, g_last = _scan_inputs(2, l=41, masked=False)
    mask = torch.from_numpy((np.arange(41)[None, :] < np.asarray([41, 20])[:, None])
                            .astype(np.int32))
    args = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
            for x in (delta, a_cont, bt, ct)]
    gy_t, gl_t = torch.tensor(gy, dtype=torch.float64), torch.tensor(g_last, dtype=torch.float64)
    y, hl, hs = selective_scan_fwd_reference(*args, mask, torch.float64, want_h=True)
    ref = torch.autograd.grad((y * gy_t).sum() + (hl * gl_t).sum(), args)
    got = selective_scan_bwd_reference(*(a.detach() for a in args[:2]), args[3].detach(), mask,
                                       hs.detach(), gy_t, gl_t)
    order = (0, 1, 2, 3)      # d_delta, dA, dB, dC
    for i in order:
        _close(got[i].numpy(), ref[i].numpy(), 1e-12, f"grad {i}")


def test_ssm_mix_keeps_states_only_for_a_gradient(monkeypatch):
    """Serving (no grad) runs the forward without its f32 states; with an
    input that requires grad the forward writes them for the backward."""
    calls = []
    real = port_ssm.selective_scan_fwd

    def spy(*a, want_h=False, **k):
        calls.append(want_h)
        return real(*a, want_h=want_h, **k)

    monkeypatch.setattr(port_ssm, "selective_scan_fwd", spy)
    delta, a_cont, bt, ct, _, _, _ = _scan_inputs(3, l=9)
    args = [torch.from_numpy(x) for x in (delta, a_cont, bt, ct)]
    with torch.no_grad():
        port_ssm.ssm_mix(*args)
    port_ssm.ssm_mix(*args)                      # nothing requires grad
    args[2].requires_grad_(True)
    port_ssm.ssm_mix(*args)
    assert calls == [False, False, True]


def _flash_inputs(seed, b=1, h=2, l=300, d=32):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(4))
    return q, k, v, g


def test_flash_grads_match_jax_vjp():
    """``FlashAttention``'s dQ, dK and dV against ``jax.grad`` through the
    JAX ``flash_attention`` (interpret mode, blocks of 128, L = 300 pads its
    last block), causal."""
    q, k, v, g = _flash_inputs(4)

    def jax_loss(q_, k_, v_):
        return jnp.sum(jax_flash.flash_attention(q_, k_, v_, True, None, 128, 128) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    args = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = FlashAttention.apply(*args)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), args)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        _close(a.numpy(), r, GRAD_TOL, name)


def test_flash_bwd_reference_is_the_forward_gradient():
    """The plain dQ and dK/dV from the forward's LSE equal autograd through
    the plain forward (f32: the same products, summed in other orders)."""
    q, k, v, g = (torch.from_numpy(x) for x in _flash_inputs(5, l=70))
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = flash_attention_fwd_reference(*args)
    ref = torch.autograd.grad((out * g).sum(), args)
    delta = (out.detach() * g).sum(-1)
    dq = flash_attention_dq_reference(q, k, v, g, lse.detach(), delta)
    dk, dv = flash_attention_dkv_reference(q, k, v, g, lse.detach(), delta)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _close(a.numpy(), r.numpy(), GRAD_TOL, name)


@pytest.mark.parametrize("n", [12, 48])
def test_scan_grads_match_jax_vjp_at_any_d_state(monkeypatch, n):
    """``ssm_mix``'s gradients at an ``ssm_d_state`` that is not a power of
    two (12, 48: the shared-memory head sum of the card's backward), masked
    and with an ``h_last`` cotangent, against ``jax.grad`` through the JAX
    ``gated_scan_2d`` in interpret mode, which takes any N: 1e-4 of each
    gradient's largest value, as at N = 8."""
    delta, a_cont, bt, ct, mask, gy, g_last = _scan_inputs(6, l=70, h=2, n=n, masked=True)
    monkeypatch.setenv("APERTIS_SSM_KERNEL", "pallas")

    def jax_loss(d, a, b, c):
        y, hl = jax_ssm.ssm_mix(d, a, b, c, seq_mask=jnp.asarray(mask))
        return jnp.sum(y * gy) + jnp.sum(hl * g_last)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(x) for x in (delta, a_cont, bt, ct)))
    args = [torch.tensor(x, requires_grad=True) for x in (delta, a_cont, bt, ct)]
    y, hl = port_ssm.ssm_mix(*args, seq_mask=torch.from_numpy(mask))
    loss = (y * torch.from_numpy(gy)).sum() + (hl * torch.from_numpy(g_last)).sum()
    for name, g, r in zip(("d_delta", "dA", "dB", "dC"), torch.autograd.grad(loss, args), ref):
        _close(g.numpy(), r, GRAD_TOL, name)


@pytest.mark.parametrize("d", [64, 128])
def test_f32_flash_forward_and_grads_match_jax(d):
    """The f32 form of the flash kernels (the plain versions, which the f32
    wrappers run on CPU tensors): the output, the LSE and dQ, dK, dV of f32
    q, k, v at head widths 64 and 128 (L = 200 pads JAX's last block of
    128) against the JAX kernel's f32 forward and its VJP in interpret mode,
    1e-4 of each largest value (GRAD_TOL; f32 on both sides, the same
    products summed in other orders)."""
    q, k, v, g = _flash_inputs(7, l=200, d=d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def jax_loss(q_, k_, v_):
        return jnp.sum(jax_flash.flash_attention(q_, k_, v_, True, None, 128, 128) * g)

    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_lse = jax_flash._fwd(jq, jk, jv, scale=d ** -0.5, causal=True,
                                          block_q=128, block_k=128)
        ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_attention_fwd_f32(tq, tk, tv)
    assert out.dtype == lse.dtype == torch.float32
    _close(out.numpy(), ref_out, GRAD_TOL, "out")
    _close(lse.numpy(), ref_lse, GRAD_TOL, "lse")
    delta = (out * tg).sum(-1)
    dq = flash_attention_dq_f32(tq, tk, tv, tg, lse, delta)
    dk, dv = flash_attention_dkv_f32(tq, tk, tv, tg, lse, delta)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert a.dtype == torch.float32
        _close(a.numpy(), r, GRAD_TOL, name)


def test_new_kernel_forms_take_cpu_tensors_and_refuse_others():
    """The f32 flash wrappers and the any-N scan backward run their plain
    versions on CPU tensors and raise on a device without their kernel (the
    meta device) before any launch; the scan backward sends an N that is not
    a power of two up to 32 to the shared-memory kernel's wrapper."""
    meta = dict(device="meta", dtype=torch.float32)
    q = torch.empty((1, 2, 64, 32), **meta)
    lse = torch.empty((1, 2, 64), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_f32(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dq_f32(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dkv_f32(q, q, q, q, lse, lse)
    for n in (12, 24, 48, 64):
        b, l, h = 2, 5, 3
        args = (torch.empty((b, l, h), **meta), torch.empty((h, n), **meta),
                torch.empty((b, l, h, n), **meta), None, torch.empty((b, l, h, n), **meta),
                torch.empty((b, l, h * n), **meta))
        with pytest.raises(ValueError, match="CUDA"):
            selective_scan_bwd(*args)
        with pytest.raises(ValueError):
            selective_scan_bwd_smem(*args[:2], torch.empty((b, l, h, 16), **meta), None,
                                    torch.empty((b, l, h, 16), **meta),
                                    torch.empty((b, l, h * 16), **meta))
    assert selective_scan_bwd.launches == selective_scan_bwd_smem.launches == 0
    assert (flash_attention_fwd_f32.launches == flash_attention_dq_f32.launches
            == flash_attention_dkv_f32.launches == 0)
    delta, a_cont, _, ct, mask, gy, g_last = _scan_inputs(8, l=9, h=2, n=12, masked=True)
    hs = selective_scan_fwd_reference(*(torch.from_numpy(x) for x in (delta, a_cont, ct, ct)),
                                      torch.from_numpy(mask), want_h=True)[2]
    cpu = [torch.from_numpy(x) for x in (delta, a_cont, ct)]
    for fn in (selective_scan_bwd, selective_scan_bwd_smem):
        got = fn(*cpu, torch.from_numpy(mask), hs, torch.from_numpy(gy),
                 torch.from_numpy(g_last))
        ref = selective_scan_bwd_reference(*cpu, torch.from_numpy(mask), hs,
                                           torch.from_numpy(gy), torch.from_numpy(g_last))
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
