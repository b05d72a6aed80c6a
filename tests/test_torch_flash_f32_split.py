"""The arithmetic of the f32 flash kernels (split TF32), emulated on the CPU.

``csrc/flash_attention_f32.cu`` runs every f32 product of the causal flash
forward, dQ and dK/dV on the tensor cores in split TF32: each operand x is
split into hi = x rounded to TF32 (to nearest, ties away from zero) and
lo = x - hi rounded the same way (``hopper.cuh::tf32_hi``, ``tf32_lo``), and
a product X Y is X_lo Y_hi + X_hi Y_lo + X_hi Y_hi, each TF32 product exact
in f32. The kernels build and run only on the card, where ``chip_smoke.py``
holds them within ``F32_FLASH_TOL`` of their plain versions. Here the same
split and products, written in the test, run through the attention forward
and backward and must stay within that tolerance of the plain versions,
while one-pass TF32 (hi * hi alone) must not. A last test checks, against
the PTX fragment layouts, the order in which the kernels hand an
accumulator to a TF32 wgmma as its register A operand.
"""

import re

import numpy as np
import pytest
import torch

from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.kernels.flash_attention import (
    flash_attention_dkv_f32, flash_attention_dq_f32, flash_attention_fwd_f32)
from chip_smoke import F32_FLASH_TOL


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernels round it: half a TF32 ulp added to
    the magnitude's bits, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_split(a, b, passes=3):
    """a @ b with f32 operands as the kernels compute it: the TF32 parts'
    products summed (in f64 here: each product of two TF32 values is exact
    in f32), then rounded to f32. passes=1 keeps hi @ hi alone."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        out = out + al.double() @ bh.double() + ah.double() @ bl.double()
    return out.float()


def attention_split(q, k, v, dout, passes=3):
    """Causal attention's out, lse, dq, dk, dv (f32 softmax) with every
    product in split TF32, in the kernels' order of operations."""
    mm = lambda a, b: matmul_split(a, b, passes)   # noqa: E731
    scale = q.shape[-1] ** -0.5
    length = q.shape[2]
    mask = torch.ones(length, length, dtype=torch.bool).tril()
    s = torch.where(mask, mm(q, k.transpose(-1, -2)) * scale, torch.tensor(-1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = mm(p, v) / l
    lse = (m + torch.log(l))[..., 0]
    delta = (out * dout).sum(-1)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.tensor(0.0))
    ds = p * (mm(dout, v.transpose(-1, -2)) - delta[..., None]) * scale
    return out, lse, mm(ds, k), mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), dout)


def attention_plain(q, k, v, dout):
    """The port's plain versions (what the wrappers run on CPU tensors and
    what chip_smoke.py holds the kernels against)."""
    out, lse = flash_attention_fwd_f32(q, k, v)
    delta = (out * dout).sum(-1)
    dq = flash_attention_dq_f32(q, k, v, dout, lse, delta)
    dk, dv = flash_attention_dkv_f32(q, k, v, dout, lse, delta)
    return out, lse, dq, dk, dv


def relative_errors(got, ref):
    return [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]


def inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(4))


def test_tf32_round_is_round_to_nearest_ties_away():
    """The bit trick is cvt.rna.tf32.f32 on finite values: exact TF32
    values stay, a half-ulp tie rounds away from zero, either sign."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23,
                      -(1.0 + ulp / 2), 3.0 + 3 * ulp, 3.0 + ulp / 2], dtype=torch.float32)
    # (TF32's ulp is 2^-9 in [2, 4): 3 + 3 * 2^-10 is a tie, 3 + 2^-11 below one)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0 + ulp, 1.0, -(1.0 + ulp), 3.0 + 4 * ulp, 3.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    hi, lo = split(torch.randn(1000))
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))
    assert torch.equal(lo.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))


@pytest.mark.parametrize("shape", [(1, 2, 300, 64), (1, 2, 48, 8), (1, 2, 48, 96),
                                   (1, 2, 40, 256)])
def test_split_tf32_stays_within_the_f32_tolerance(shape):
    """The kernels' split TF32 through the forward, dQ and dK/dV keeps every
    output within F32_FLASH_TOL of the plain f32 versions."""
    q, k, v, dout = inputs(shape, seed=sum(shape))
    errs = relative_errors(attention_split(q, k, v, dout), attention_plain(q, k, v, dout))
    assert max(errs) < F32_FLASH_TOL, errs


def test_one_pass_tf32_misses_the_f32_tolerance():
    """The check can fail: hi * hi alone (plain TF32) moves the outputs by
    more than F32_FLASH_TOL, several times over."""
    q, k, v, dout = inputs((1, 2, 300, 64), seed=1)
    errs = relative_errors(attention_split(q, k, v, dout, passes=1),
                           attention_plain(q, k, v, dout))
    assert min(errs) > 4 * F32_FLASH_TOL, errs


def test_register_fragment_order_matches_the_ptx_layouts():
    """hopper.cuh::to_tf32_frags hands accumulator values to a TF32 wgmma's
    register A operand in the order it states, and tf32_slot writes the B
    operand's k rows to match: simulated over the 32 lanes of a warp with the
    PTX layouts (accumulator: lane l holds d[4j + e] at row l / 4 + 8 (e / 2),
    column 8j + 2 (l % 4) + e % 2; A fragment m64k8 TF32: register i at row
    l / 4 + 8 (i % 2), column l % 4 + 4 (i / 2)), the product over a k8 step
    equals P V."""
    src = (_build.CSRC / "hopper.cuh").read_text()
    order = re.search(r"const float x\[4\] = \{d\[4 \* kk\], d\[4 \* kk \+ (\d)\], "
                      r"d\[4 \* kk \+ (\d)\], d\[4 \* kk \+ (\d)\]\};", src)
    assert order, "to_tf32_frags' order not found"
    take = [0] + [int(x) for x in order.groups()]
    slot_src = re.search(r"constexpr int tf32_slot\(int k\) \{ return \(k & 1\) \* (\d) \+ "
                         r"\(k >> (\d)\); \}", src)
    assert slot_src, "tf32_slot not found"
    odd_base, shift = (int(x) for x in slot_src.groups())
    slot = [(k & 1) * odd_base + (k >> shift) for k in range(8)]
    assert sorted(slot) == list(range(8))

    rng = np.random.default_rng(0)
    p = rng.standard_normal((16, 8))      # one warp's 16 rows, one k8 step of keys
    v = rng.standard_normal((8, 5))
    a = np.full((16, 8), np.nan)          # the fragment as the tensor core reads it
    for lane in range(32):
        d = {e: p[lane // 4 + 8 * (e // 2), 2 * (lane % 4) + e % 2] for e in range(4)}
        for i in range(4):
            a[lane // 4 + 8 * (i % 2), lane % 4 + 4 * (i // 2)] = d[take[i]]
    b = np.empty((8, 5))                  # B's k rows as the transposed copy holds them
    for key in range(8):
        b[slot[key]] = v[key]
    assert not np.isnan(a).any()
    np.testing.assert_allclose(a @ b, p @ v, rtol=1e-12)
