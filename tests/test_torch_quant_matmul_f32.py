"""#6's f32 form (``quant_matmul_f32``) on the CPU: its split, its plan, its
arithmetic by bits, and its routing.

On the card the f32 rows are split by a row pass into three bf16 parts,
hi + mid + lo, which the tensor cores multiply by the int8 levels as exact
bf16 (``csrc/quant_matmul.cu``, ``decode_gemm.cuh``'s kDgB3): each product
is exact in f32, each 64-K chunk's three products are summed in a fresh f32
accumulator, and the chunks are added in f32 in order. These tests show the
split exact, emulate that arithmetic by bits (numpy) and hold it within the
card check's tolerance of an f64 product at the head's and W2's K, while a
one-part (bf16 x) product falls outside it, and pin the plan and the
routing; the kernel itself runs only on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from apertis_llm_torch.ops.kernels import quant_matmul as qm
from chip_smoke import QMM_F32_TOL


def _quantized(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    s = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-8) / 127.0
    return np.clip(np.rint(w / s), -127, 127).astype(np.int8), s.astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 3e-4, 7e3])
def test_split_is_exact(scale):
    """hi + mid + lo == x exactly (in f64) for seeded normal f32 values of
    any magnitude, each part a bf16 value; the pad rows and columns are 0."""
    r = np.random.default_rng(int(scale * 1000) % 97)
    x = torch.from_numpy((r.standard_normal((37, 597)) * scale).astype(np.float32))
    parts = qm.split_rows(x, 16)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 48, 600)
    total = parts.double().sum(dim=0)
    assert torch.equal(total[:37, :597], x.double())
    assert not parts[:, 37:].any() and not parts[:, :, 597:].any()
    # Each part takes the next 8 bits: mid within 2^-8 of x, lo within 2^-16.
    assert (parts[1, :37, :597].double().abs() <= x.double().abs() * 2.0 ** -8).all()
    assert (parts[2, :37, :597].double().abs() <= x.double().abs() * 2.0 ** -16).all()


def _kernel_product(x, w_q, w_s, b, parts_used=3):
    """The kernel's f32 form by bits: the rows' parts (lo, mid, hi) times
    the exact levels, each k16 step's 16 exact products summed and rounded
    to f32 (the tensor cores add a step's products wider than f32), the
    steps added in f32 into a fresh accumulator a 64-K chunk, the chunks
    added in f32 in order; then ``acc * w_s`` and ``+ b`` in f32.
    ``parts_used`` 1: x rounded to bf16 alone (one product)."""
    parts = qm.split_rows(torch.from_numpy(x)).double().numpy()[:, :x.shape[0], :x.shape[1]]
    m, k = x.shape
    wf = w_q.astype(np.float64)
    acc = np.zeros((m, w_q.shape[1]), np.float32)
    for c0 in range(0, k, 64):
        t = np.zeros_like(acc)
        for p in (2, 1, 0)[3 - parts_used:]:
            for s0 in range(c0, min(c0 + 64, k), 16):
                step = (parts[p][:, s0:s0 + 16] @ wf[s0:s0 + 16]).astype(np.float32)
                t = (t + step).astype(np.float32)
        acc = (acc + t).astype(np.float32)
    y = (acc * w_s).astype(np.float32)
    return y + b if b is not None else y


@pytest.mark.parametrize("k,n", [(2432, 256), (9728, 128)])
def test_product_by_bits_within_the_card_tolerance(k, n):
    """At the head's K (2432) and W2's (9728), the three-part product lands
    within QMM_F32_TOL of max|ref| of the f64 product; a one-part product
    (x as bf16) lands outside it, so the tolerance sees a lost part."""
    r = np.random.default_rng(k + n)
    x = r.standard_normal((4, k)).astype(np.float32)
    w_q, w_s = _quantized(r, k, n)
    b = (0.1 * r.standard_normal(n)).astype(np.float32)
    ref = (x.astype(np.float64) @ w_q.astype(np.float64)) * w_s.astype(np.float64) + b
    scale = np.abs(ref).max()
    three = np.abs(_kernel_product(x, w_q, w_s, b) - ref).max() / scale
    one = np.abs(_kernel_product(x, w_q, w_s, b, parts_used=1) - ref).max() / scale
    assert three < QMM_F32_TOL / 10, three
    assert one > QMM_F32_TOL, one
    # The plain version (the f32 product) is inside the tolerance too.
    plain = qm.quant_matmul_reference(torch.from_numpy(x), torch.from_numpy(w_q),
                                      torch.from_numpy(w_s), torch.from_numpy(b)).numpy()
    assert np.abs(plain - ref).max() / scale < QMM_F32_TOL / 10


@pytest.mark.parametrize("m,n,k,plan", [
    (1, 32000, 2432, qm.TilePlan(16, 1, True, True)),
    (10, 32000, 2432, qm.TilePlan(16, 1, True, True)),
    (64, 9728, 2432, qm.TilePlan(64, 1, True, True)),
    (10, 2432, 9728, qm.TilePlan(16, 4, True, True)),
    (64, 2432, 9728, qm.TilePlan(64, 4, True, True)),
    (132, 9728, 2432, qm.TilePlan(128, 1, True, True)),
    (520, 9728, 2432, qm.TilePlan(128, 1, True, True)),
    (2048, 9728, 2432, qm.TilePlan(128, 1, True, True)),
    (17, 44, 597, qm.TilePlan(64, 1, True, False))])
def test_f32_plan_at_the_chat_shapes(m, n, k, plan):
    """The f32 form's plan: the bf16 form's row tile capped at 128 (the
    chunk accumulators double the consumers' registers), its K split at
    decode rows where the column tiles leave SMs idle, the parts by TMA
    always, the weight by TMA where N is a multiple of 16."""
    assert qm.f32_plan(m, n, k, 132) == plan


def test_f32_rows_take_the_plain_version_on_the_cpu():
    """On CPU tensors ``quant_matmul`` and ``quant_matmul_f32`` run the plain
    version and count no launch."""
    r = np.random.default_rng(5)
    w_q, w_s = _quantized(r, 96, 40)
    x = torch.from_numpy(r.standard_normal((3, 96)).astype(np.float32))
    b = torch.from_numpy((0.1 * r.standard_normal(40)).astype(np.float32))
    args = (x, torch.from_numpy(w_q), torch.from_numpy(w_s), b)
    qm.quant_matmul.launches = qm.quant_matmul_f32.launches = 0
    ref = qm.quant_matmul_reference(*args)
    assert torch.equal(qm.quant_matmul(*args), ref)
    assert torch.equal(qm.quant_matmul_f32(*args), ref)
    assert qm.quant_matmul.launches == qm.quant_matmul_f32.launches == 0


def test_f32_rows_on_the_card_take_the_f32_form(monkeypatch):
    """On a card's tensors (``meta`` here, which is not the CPU) f32 rows
    go to ``quant_matmul_f32``, bf16 rows stay with the bf16 kernel."""
    seen = []
    monkeypatch.setattr(qm, "quant_matmul_f32", lambda *a: seen.append("f32") or "f32 form")
    monkeypatch.setattr(qm, "_launch_float_x", lambda wrapper, entry, *a: entry)
    w_q = torch.empty((96, 40), dtype=torch.int8, device="meta")
    w_s = torch.empty((1, 40), device="meta")
    x32 = torch.empty((3, 96), device="meta")
    assert qm.quant_matmul(x32, w_q, w_s) == "f32 form" and seen == ["f32"]
    assert qm.quant_matmul(x32.bfloat16(), w_q, w_s) == "apertis_quant_matmul"
