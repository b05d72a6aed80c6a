"""The fused norm + quantize kernel's plan and arithmetic order (CPU).

``csrc/ln_quant.cu`` keeps each row in registers, spread over
``ln_plan``'s threads; these tests pin the plan at the main path's widths
and row counts, and emulate the kernel's row sums in its own order (each
thread's vectors in turn, a butterfly over the row's lanes, the warps in
order, in f64 over f32 sums of a vector's values) to show that they give
the plain version's bits at every plan.
"""

import numpy as np
import pytest
import torch

from apertis_llm_torch.ops.kernels.ln_quant import (
    LnPlan, group, ln_plan, ln_quantize, ln_quantize_reference, max_width)


@pytest.mark.parametrize("h,rows,plan", [
    (2432, 2048, LnPlan(8, 64, 5)), (2432, 256, LnPlan(8, 256, 2)),
    (2432, 37, LnPlan(8, 256, 2)), (704, 2048, LnPlan(8, 64, 2)),
    (768, 12608, LnPlan(8, 32, 3)), (768, 788, LnPlan(8, 128, 1)),
    (192, 300, LnPlan(8, 32, 1)), (9728, 2048, LnPlan(8, 256, 5)),
    (2436, 300, LnPlan(4, 256, 4)), (2430, 300, LnPlan(2, 512, 4)),
    (2431, 300, LnPlan(1, 1024, 4)), (32768, 64, LnPlan(8, 1024, 4)),
    (8191, 64, LnPlan(1, 1024, 8))])
def test_plan_at_the_main_path_shapes(h, rows, plan):
    assert ln_plan(h, rows) == plan
    assert plan.threads * plan.nv * plan.vec >= h and plan.vec == group(h)


def test_plan_limits_and_forced_threads():
    assert [max_width(v) for v in (8, 4, 2, 1)] == [32768, 32768, 16384, 8192]
    for h in (32776, 16386, 8193):
        with pytest.raises(ValueError, match="outside the kernel"):
            ln_plan(h)
    assert ln_plan(2432, threads=128) == LnPlan(8, 128, 3)
    assert ln_plan(2432, 2048, sms=264) == LnPlan(8, 128, 3)   # more SMs to fill
    with pytest.raises(ValueError, match="do not fit"):
        ln_plan(2432, threads=16)
    with pytest.raises(ValueError, match="power of two"):
        ln_plan(2432, threads=48)


def _kernel_sum(t, plan):
    """A row's sum of f32 values ``t`` as the kernel takes it on ``plan``:
    thread k adds the f32 sums of its vectors k, k + threads, ... into an
    f64 partial in turn; the partials meet in a butterfly over the lanes
    (pairs at half the lanes first), then the warps' in order."""
    v = t.reshape(-1, plan.vec)
    parts = v[:, 0].copy()
    for e in range(1, plan.vec):
        parts = (parts + v[:, e]).astype(np.float32)
    acc = np.zeros(plan.threads, np.float64)
    for j, p in enumerate(parts):
        acc[j % plan.threads] += np.float64(p)
    lanes = min(plan.threads, 32)
    warps = acc.reshape(-1, lanes)
    while warps.shape[1] > 1:
        half = warps.shape[1] // 2
        warps = warps[:, :half] + warps[:, half:]
    total = warps[0, 0]
    for k in range(1, warps.shape[0]):
        total = total + warps[k, 0]
    return np.float32(total)


def _kernel_order(x, w, b, eps, plan):
    """The kernel's arithmetic in its order, in numpy, one row at a time."""
    h = x.shape[-1]
    inv_h = np.float32(1.0 / h)
    qs, ss = [], []
    for row in x:
        if b is None:
            s2 = _kernel_sum((row * row).astype(np.float32), plan)
            r = np.float32(np.sqrt(s2) if s2 > 0 else 0) * np.float32(h ** -0.5)
            inv = np.float32(1) / (r + np.float32(eps)) if s2 > 0 else np.float32(0)
            v = row * inv * w
        else:
            c = row - _kernel_sum(row, plan) * inv_h
            var = _kernel_sum((c * c).astype(np.float32), plan) * inv_h
            inv = np.float32(1) / np.sqrt(var + np.float32(eps)) if var > 0 else np.float32(0)
            v = c * inv * w + b
        v = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).float().numpy()
        s = np.float32(max(np.abs(v).max(), np.float32(1e-8))) * np.float32(1.0 / 127.0)
        qs.append(np.clip(np.rint(v / s), -127, 127).astype(np.int8))
        ss.append(s)
    return np.stack(qs), np.asarray(ss, np.float32)[:, None]


@pytest.mark.parametrize("h,threads", [(2432, 64), (2432, 128), (2432, 256), (768, 64),
                                       (768, 32), (192, 8), (2436, 256)])
@pytest.mark.parametrize("layer_norm", [True, False])
def test_kernel_order_gives_the_plain_bits(h, threads, layer_norm):
    """Whatever the threads a row, the kernel's order gives the plain
    version's statistics, and so its levels and scales, bit for bit."""
    r = np.random.default_rng(h + threads + layer_norm)
    x = torch.from_numpy((r.standard_normal((24, h)) * 2).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((1 + 0.1 * r.standard_normal(h)).astype(np.float32)).to(torch.bfloat16)
    b = (torch.from_numpy((0.1 * r.standard_normal(h)).astype(np.float32)).to(torch.bfloat16)
         if layer_norm else None)
    q, s = _kernel_order(x.float().numpy(), w.float().numpy(),
                         None if b is None else b.float().numpy(), 1e-5,
                         ln_plan(h, threads=threads))
    q_ref, s_ref = ln_quantize_reference(x, w, b, 1e-5)
    np.testing.assert_array_equal(q, q_ref.numpy())
    np.testing.assert_array_equal(s, s_ref.numpy())
    ln_quantize.launches = 0
    got = ln_quantize(x, w, b, 1e-5)      # a CPU tensor: the plain version
    assert ln_quantize.launches == 0 and torch.equal(got[0], q_ref)

