"""Fused pre-norm + per-row int8 quantize: the int8 prefill's pre-norms.

``ln_quantize`` launches the CUDA kernel in ``csrc/ln_quant.cu`` for CUDA
tensors and runs :func:`ln_quantize_reference`, its plain PyTorch version,
for CPU tensors. It replaces ``apertis_llm_tpu/ops/pallas/ln_quant.py::
ln_quantize``. :func:`ln_plan` chooses how the kernel spreads a row over
threads: vectors of ``vec`` bf16 values (8, one 16-byte load, where H allows),
``threads`` threads a row and ``nv`` vectors a thread, all held in
registers. Both versions take each row sum as the f32 sums of ``vec``
consecutive values added in f64 (:func:`row_sum`), so that the kernel's
result does not depend on the order its threads add them in. f32 rows take
the f32 form, :func:`ln_quantize_f32`: the same kernel on f32 rows, on the
same plan, and, for rows wider than the plan takes (up to
:data:`F32_WIDE_MAX` values), a second kernel that stages the row in shared
memory; both sum as the plain version does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.kernels.flash_attention import RESOURCE_KEYS

# Vectors a thread that the 16-byte kernel is built for (csrc/ln_quant.cu
# ``pick``) in blocks of up to 256 threads, at most 40 values a thread;
# wider rows take 4 a thread in blocks of up to 1024, and so do narrower
# vectors, or 8.
NV_16B = (1, 2, 3, 4, 5)
# The threads the default plan aims to run at once: 16 warps an SM.
THREADS_PER_SM = 512
MAX_THREADS = 1024
# The widest f32 row of the f32 form's wide route: a block's 232,448 bytes
# of shared memory less its 96 bytes of reduction slots, as f32 values.
F32_WIDE_MAX = (232448 - 96) // 4


class LnPlan(NamedTuple):
    vec: int       # bf16 values a load (8, 4, 2 or 1)
    threads: int   # threads a row, a power of two from 8 to 1024
    nv: int        # vectors a thread


def group(h: int) -> int:
    """The values a row sum adds in f32 before f64, and the kernel's vector:
    the widest of 8, 4, 2 and 1 that divides ``h``."""
    return next(v for v in (8, 4, 2, 1) if h % v == 0)


def max_width(vec: int) -> int:
    """The widest row the kernel takes with vectors of ``vec`` values."""
    return MAX_THREADS * (4 if vec == 8 else 8) * vec


def ln_plan(h: int, rows: int = 1 << 20, sms: int = 132,
            threads: Optional[int] = None) -> LnPlan:
    """The kernel's plan for ``rows`` rows of ``h`` values on a card of
    ``sms`` SMs: vectors of :func:`group` values; for 16-byte vectors the
    fewest threads a row (8 to 256) that hold the row in at most 5
    vectors each, more (up to one a vector) where the rows
    would not give every SM ``THREADS_PER_SM`` threads, or 512 or 1024
    threads with 4 each for rows
    wider than that; for narrower vectors the fewest threads with 4 each, or
    1024 with 8. ``threads`` forces the threads a row (what the timing sweeps
    use). Raises ``ValueError`` past :func:`max_width`."""
    vec = group(h)
    if h <= 0 or h > max_width(vec):
        raise ValueError(f"ln_quantize: rows of {h} values are outside the kernel's 1 to "
                         f"{max_width(vec):,} (vectors of {vec})")
    units = h // vec
    if threads is not None:
        if threads < 8 or threads > MAX_THREADS or threads & (threads - 1):
            raise ValueError(f"ln_quantize: {threads} threads a row (a power of two, 8 to "
                             f"{MAX_THREADS})")
        plan = _fit(units, vec, threads)
        if plan is None:
            raise ValueError(f"ln_quantize: {units} vectors of {vec} do not fit {threads} "
                             "threads")
        return plan
    if vec == 8:
        fill = sms * THREADS_PER_SM
        for t in (8, 16, 32, 64, 128, 256):
            plan = _fit(units, vec, t)
            if plan is not None and (
                    t * rows >= fill or t >= units or t == 256):
                return plan
    t = 8
    while t * 4 < units and t < MAX_THREADS:
        t *= 2
    return _fit(units, vec, t)


def _fit(units: int, vec: int, threads: int) -> Optional[LnPlan]:
    """The fewest vectors a thread that cover ``units`` over ``threads``."""
    need = -(-units // threads)
    choices = NV_16B if vec == 8 and threads <= 256 else (4,) if vec == 8 else (4, 8)
    for nv in choices:
        if nv >= need:
            return LnPlan(vec, threads, nv)
    return None


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """(..., H) f32 -> (..., 1) f32: the f32 sums of :func:`group` (H)
    consecutive values, each in order, added in f64 and rounded to f32 once.
    An f64 sum moves with its order by about 1e-16 of its terms, so its f32
    rounding does not depend on the order but with a probability of about
    1e-6 a row: the kernel, which adds its threads' parts in another order,
    gets the same f32 sums."""
    g = group(t.shape[-1])
    parts = t.reshape(*t.shape[:-1], -1, g)
    acc = parts[..., 0]
    for e in range(1, g):
        acc = acc + parts[..., e]
    return acc.double().sum(dim=-1, keepdim=True).float()


def sqrt_f32(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of f32 ``t`` on any device, as
    the kernel's ``sqrtf`` gives it: the square root in f64, rounded once to
    f32. A square root of an f32 value lies at least 2^-49 of itself from
    any f32 rounding boundary, far past an f64 ulp (2^-52), so the two
    roundings give the one correct f32 result. ``torch.sqrt`` of f32 CPU
    tensors need not round correctly (its vectorised form was found one ulp
    off on some CPUs), which would move a level or a scale."""
    return torch.sqrt(t.double()).float()


def ln_quantize_reference(
    x: torch.Tensor,                 # (..., H)
    weight: torch.Tensor,            # (H,) LayerNorm weight or RMSNorm scale
    bias: Optional[torch.Tensor],    # (H,) LayerNorm bias; None = RMSNorm
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_q int8 (..., H), x_s f32 (..., 1))`` with ``x_q * x_s ~= norm(x)``.
    The norm runs in f32 (RMSNorm with eps on the RMS and a zero inverse on
    zero rows; LayerNorm with a zero inverse on constant rows; the row sums
    of :func:`row_sum`, the means as products with 1/H, the square roots
    correctly rounded by :func:`sqrt_f32`), is rounded through
    ``x.dtype``, then ``x_s = max(absmax, 1e-8) * (1/127)`` and ``x_q =
    clip(rint(normed / x_s), +-127)``."""
    xf = x.float()
    w = weight.float()
    h = x.shape[-1]
    if bias is None:
        ss = row_sum(xf * xf)
        rms = torch.where(ss > 0, sqrt_f32(torch.where(ss > 0, ss, torch.ones_like(ss))),
                          torch.zeros_like(ss)) * (h ** -0.5)
        inv = torch.where(ss > 0, 1.0 / (rms + eps), torch.zeros_like(rms))
        normed = xf * inv * w
    else:
        c = xf - row_sum(xf) * (1.0 / h)
        var = row_sum(c * c) * (1.0 / h)
        inv = torch.where(var > 0, 1.0 / sqrt_f32(var + eps), torch.zeros_like(var))
        normed = c * inv * w + bias.float()
    normed = normed.to(x.dtype).float()
    scale = torch.clamp(normed.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(normed / scale), -127, 127).to(torch.int8)
    return q, scale


def ln_quantize(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Norm + quantize: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes contiguous bf16 ``x`` of any leading shape whose rows
    :func:`ln_plan` takes (up to 32,768 values where H is a multiple of 4,
    16,384 where it is even, 8,192 where it is odd) and bf16 weights;
    ``bias`` None selects RMSNorm. f32 rows go to the f32 form
    :func:`ln_quantize_f32`.
    """
    if x.device.type == "cpu":
        return ln_quantize_reference(x, weight, bias, eps)
    if x.dtype == torch.float32:
        return ln_quantize_f32(x, weight, bias, eps)
    q, s = _ln_launch(x, weight, bias, eps, None)
    ln_quantize.launches += 1
    return q, s


def ln_quantize_f32(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Norm + quantize of f32 rows (``csrc/ln_quant.cu``,
    ``apertis_ln_quantize_f32``): contiguous f32 ``x`` of any leading shape
    with rows of up to :data:`F32_WIDE_MAX` values, the weights f32 or bf16
    (one dtype); the normed row is not rounded (x's dtype is f32), then
    quantized as :func:`ln_quantize_reference` does. Rows that
    :func:`ln_plan` takes run the register kernel on its plan, wider ones
    the wide route (:func:`f32_route`). Plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ln_quantize_reference(x, weight, bias, eps)
    floats = (torch.float32, torch.bfloat16)
    h = x.shape[-1]
    rows = x.numel() // max(h, 1)
    dev = x.device
    _build.check_tensor(x, tuple(x.shape), (torch.float32,), "x", dev)
    _build.check_tensor(weight, (h,), floats, "weight", dev)
    if bias is not None:
        _build.check_tensor(bias, (h,), (weight.dtype,), "bias", dev)
    if rows == 0 or h == 0:
        raise ValueError(f"ln_quantize_f32: empty shape {tuple(x.shape)}")
    plan = f32_route(h, rows, _build.sm_count(dev.index or 0))
    if plan is None:
        vec, threads, nv = 0, 0, 0
    else:
        vec, threads, nv = plan
        x, weight, bias = (t.clone() if t is not None and t.data_ptr() % min(
            16, vec * t.element_size()) else t for t in (x, weight, bias))
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=dev)
    err = _build.load_library().apertis_ln_quantize_f32(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        q.data_ptr(), s.data_ptr(), rows, h, vec, threads, nv,
        int(weight.dtype == torch.bfloat16), int(bias is None), float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_quantize_f32")
    ln_quantize_f32.launches += 1
    return q, s


def f32_route(h: int, rows: int, sms: int = 132) -> Optional[LnPlan]:
    """The f32 form's route for ``rows`` rows of ``h`` > 0 values:
    :func:`ln_plan`'s plan where it takes the row (the register kernel),
    None for the wide route up to :data:`F32_WIDE_MAX` values. Raises
    ``ValueError`` past it."""
    if h <= max_width(group(h)):
        return ln_plan(h, rows, sms)
    if h > F32_WIDE_MAX:
        raise ValueError(f"ln_quantize_f32: rows of {h} values are outside the kernel's 1 to "
                         f"{F32_WIDE_MAX:,}")
    return None


ln_quantize.launches = 0
ln_quantize_f32.launches = 0


def _ln_launch(x, weight, bias, eps, threads):
    """Check the operands, allocate the outputs and launch the kernel on
    :func:`ln_plan`'s plan (``threads`` forces the threads a row); an
    operand that does not start on its vector's boundary is copied first."""
    bf16 = (torch.bfloat16,)
    h = x.shape[-1]
    rows = x.numel() // max(h, 1)
    dev = x.device
    _build.check_tensor(x, tuple(x.shape), bf16, "x", dev)
    _build.check_tensor(weight, (h,), bf16, "weight", dev)
    if bias is not None:
        _build.check_tensor(bias, (h,), bf16, "bias", dev)
    if rows == 0 or h == 0:
        raise ValueError(f"ln_quantize: empty shape {tuple(x.shape)}")
    plan = ln_plan(h, rows, _build.sm_count(dev.index or 0), threads)
    x, weight, bias = (t.clone() if t is not None and t.data_ptr() % (2 * plan.vec) else t
                       for t in (x, weight, bias))
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=dev)
    err = _build.load_library().apertis_ln_quantize(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        q.data_ptr(), s.data_ptr(), rows, h, plan.vec, plan.threads, plan.nv,
        int(bias is None), float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_quantize")
    return q, s


def ln_quantize_resources(plan: LnPlan, form: int = 0) -> Dict[str, int]:
    """What the card gives the kernel of ``plan`` (``form`` 0: bf16 rows; 1:
    f32 rows and weights; 2: f32 rows, bf16 weights): registers a thread,
    shared memory a block in bytes, resident blocks an SM, threads a block
    and spilled bytes a thread."""
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = _build.load_library().apertis_ln_quantize_resources(
        plan.vec, plan.threads, plan.nv, form, ctypes.addressof(out))
    _build.check(err, "ln_quantize_resources")
    return dict(zip(RESOURCE_KEYS, out))
