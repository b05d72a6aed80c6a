"""Int8 matmul arithmetic (``quant_matmul.py`` semantics).

Per-row activation quantization (plain torch, as the JAX package leaves it to
XLA) and the int8-weight linears of the four ``quant_matmul`` modes
(:func:`linear_int8`, the JAX package's ``APERTIS_QUANT_MATMUL``): ``dyn``,
the dynamic w8a8 product with per-output-channel weight scales; ``weightonly``,
the dequantized weight in plain torch; ``pallas`` and ``fused``, the
weight-only and the block-quantizing kernels; ``auto``, the default, the
weight-only kernel, and the w8a8 product behind a fused pre-norm from the
card's measured row count (:func:`resolve_mode`, :func:`fuses_pre_norm`).
On the card the products are
the hand-written kernels of ``ops/kernels/quant_matmul.py``;
:func:`linear_pre_q_reference` is the w8a8 product's plain version, whose
int8 x int8 -> int32 product is :func:`int_mm` (``torch._int_mm``), exact
integer arithmetic. ``int_mm`` serves the plain versions only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def divide(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` rounded once, as JAX divides. A Python scalar divisor
    makes PyTorch's CUDA kernel multiply by its reciprocal instead, which can
    differ in the last bit, so the divisor is a tensor on ``x``'s device,
    filled there: a copy from the host would wait for the device to finish
    its queue."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (K, N) -> int32 (M, N), for the kernels'
    plain versions. On the card ``torch._int_mm`` needs K and N multiples of
    8 and more than 16 rows, and cuBLASLt refuses some row counts that are
    not multiples of 32 when K is small: the rows are padded with zeros to a
    multiple of 32, K and N to multiples of 8 (zeros add nothing to the
    sums), and the padding is cut off again."""
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda" or (m % 32 == 0 and k % 8 == 0 and n % 8 == 0):
        return torch._int_mm(a, b)
    pad_k, pad_n = -k % 8, -n % 8
    if pad_k or pad_n:
        b = torch.nn.functional.pad(b, (0, pad_n, 0, pad_k))
    padded = torch.zeros((-(-m // 32) * 32, k + pad_k), dtype=torch.int8, device=a.device)
    padded[:m, :k] = a
    return torch._int_mm(padded, b)[:m, :n]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8, ``x ~= x_q * x_s`` with (..., 1) f32 scales
    ``max(absmax, 1e-8) / 127`` and ``x_q = rint(x / x_s)``
    (``quant_matmul.py::quantize_rows``)."""
    xf = x.float()
    scale = divide(torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def linear_pre_q_reference(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                           w_s: torch.Tensor, b: Optional[torch.Tensor],
                           out_dtype: torch.dtype) -> torch.Tensor:
    """int8 product with pre-quantized activations (``apertis.py::
    _linear_pre_q``, ``quant_matmul.py::_dyn_kernel``): ``int32(x_q @ w_q) *
    x_s * w_s`` in f32, cast to ``out_dtype``, then ``+ b``."""
    lead = x_q.shape[:-1]
    acc = int_mm(x_q.reshape(-1, x_q.shape[-1]), w_q)
    y = (acc.float() * x_s.reshape(-1, 1).float()
         * w_s.reshape(1, -1).float()).to(out_dtype)
    y = y.reshape(*lead, w_q.shape[-1])
    return y + b if b is not None else y


def linear_pre_q(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                 w_s: torch.Tensor, b: Optional[torch.Tensor],
                 out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`linear_pre_q_reference`'s arithmetic through the w8a8 kernel on
    CUDA tensors (its plain version on CPU ones)."""
    # Imported here: the kernel module imports this one for its plain version.
    from apertis_llm_torch.ops.kernels.quant_matmul import quant_matmul_dyn_pre_q
    return quant_matmul_dyn_pre_q(x_q, x_s, w_q, w_s, b, out_dtype)


def linear_dyn(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic w8a8 linear (``quant_matmul_dyn_xla`` then ``+ b``): rows of
    ``x`` quantized at run time, result in ``x.dtype``."""
    x_q, x_s = quantize_rows(x)
    return linear_pre_q(x_q, x_s, w_q, w_s, b, x.dtype)


QUANT_MATMUL_MODES = ("auto", "dyn", "weightonly", "pallas", "fused")

# quant_matmul="auto" (the JAX package's default, apertis.py:80-186): JAX
# runs every int8 linear as the w8a8 product (dyn) from 128 rows, tuned to
# the TPU's MXU, and fuses a pre-norm with its consumers' row quantization
# (_maybe_ln_quant) under auto as under dyn. The port's rule is the card's
# (NVIDIA H100 80GB HBM3 at 700 W), with one threshold:
# - a linear on rows not quantized already runs the weight-only kernel #6
#   at every row count: ``python3 chip_smoke.py --auto-times`` (each linear
#   alone, CUDA-event ms with the host's enqueue, 1 to 16,384 rows, seven of
#   the models' products) found #6 faster than dyn (the rows quantized in
#   plain torch, then #7) at 88 of 91 points (at 2048 rows the 1.5B FFN's
#   w1 0.1554 ms against 0.3436, w2 0.2130 against 0.5365);
# - #7 alone, on rows quantized already, beats #6 from about 1,024 rows
#   there (w1 at 2048 rows 0.1197 against 0.1554, the fused QKV 0.0955
#   against 0.1258), and #5 quantizes 2048 x 2432 rows for 0.013 ms. So
#   where every consumer of an int8 pre-norm is int8 (the SSM mixer's
#   in-projections, the dense FFN's w1, SwiGLU's w_gate and w_up, the ViT's
#   in_proj and linear1) the pre-norm runs #5 and its consumers #7 from
#   AUTO_DYN_ROWS rows of x (fuses_pre_norm). ``python3 chip_smoke.py
#   --auto-model-times`` (the 1.5B int8 models' prefill, profiler device ms,
#   fused against every linear through #6) found the fused form faster at
#   every count measured, 64 to 4,096 rows, in all three models: dense SSM
#   4.279 against 5.902 at 64 rows and 22.044 against 34.661 at 4,096, MHA
#   5.866 against 6.580 and 63.311 against 70.832, MoE SSM 14.817 against
#   15.961 and 42.851 against 45.883. Below 64 rows it was not measured.
AUTO_DYN_ROWS: Optional[int] = 64


def resolve_mode(mode: str) -> str:
    """The form an int8 linear of ``quant_matmul`` mode ``mode`` takes on
    rows not quantized already: ``auto`` the weight-only kernel
    (``pallas``) at every row count, every other mode itself."""
    return "pallas" if mode == "auto" else mode


def fuses_pre_norm(mode: str, rows: int) -> bool:
    """Whether an int8 pre-norm on ``rows`` rows whose consumers are all
    int8 runs the fused norm + row quantization (#5) and feeds them the
    w8a8 product (#7), as ``_maybe_ln_quant`` does: always under ``dyn``,
    under ``auto`` from :data:`AUTO_DYN_ROWS` rows (never when it is
    None), under the other modes never."""
    return mode == "dyn" or (mode == "auto" and AUTO_DYN_ROWS is not None
                             and rows >= AUTO_DYN_ROWS)


def linear_weightonly(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ (w_q * w_s)`` with the weight dequantized in x's dtype, then
    ``+ b`` (``apertis.py::_linear``'s weight-only branch, which the JAX
    package leaves to XLA outside any kernel)."""
    y = x @ (w_q.to(x.dtype) * w_s.to(x.dtype))
    return y + b if b is not None else y


def linear_int8(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                b: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """The int8 linear of ``quant_matmul`` mode ``mode`` (``apertis.py::
    _linear``): ``dyn`` :func:`linear_dyn`, ``weightonly``
    :func:`linear_weightonly`, ``pallas`` the weight-only kernel and
    ``fused`` the block-quantizing kernel (``ops/kernels/quant_matmul.py``),
    each ``+ b`` in x's dtype; ``auto`` the weight-only kernel
    (:func:`resolve_mode`)."""
    mode = resolve_mode(mode)
    if mode == "dyn":
        return linear_dyn(x, w_q, w_s, b)
    if mode == "weightonly":
        return linear_weightonly(x, w_q, w_s, b)
    # Imported here: the kernel module imports this one for its plain versions.
    from apertis_llm_torch.ops.kernels.quant_matmul import quant_matmul, quant_matmul_dyn_fused
    if mode == "pallas":
        return quant_matmul(x, w_q, w_s, b)
    if mode == "fused":
        return quant_matmul_dyn_fused(x, w_q, w_s, b)
    raise ValueError(f"quant_matmul must be one of {QUANT_MATMUL_MODES}, got {mode!r}")
