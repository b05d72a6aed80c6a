"""The w8a8 product with its dequantizing epilogue: every int8 linear.

``quant_matmul_dyn_pre_q`` launches the CUDA kernel in
``csrc/quant_matmul.cu`` (a tiled int8 tensor-core GEMM whose epilogue
applies ``acc * x_s * w_s``, the rounding to the output type and the bias)
for CUDA tensors and runs :func:`quant_matmul_dyn_pre_q_reference`, its plain
PyTorch version, for CPU tensors. It replaces
``apertis_llm_tpu/ops/pallas/quant_matmul.py::quant_matmul_dyn``;
:func:`quant_matmul_dyn` is that function's form that quantizes its input
rows first (``ops/quant.py::quantize_rows``, plain torch). The weight is the
JAX tree's row-major (K, N) int8 ``w_q``, read as it is.
"""

from __future__ import annotations

from typing import Optional

import torch

from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.quant import linear_pre_q_reference, quantize_rows

_OUT_DTYPES = (torch.bfloat16, torch.float32)


# The plain version: ``int32(x_q @ w_q) * x_s * w_s`` in f32, cast to
# ``out_dtype``, then ``+ b``.
quant_matmul_dyn_pre_q_reference = linear_pre_q_reference


def quant_matmul_dyn_pre_q(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                           w_s: torch.Tensor, b: Optional[torch.Tensor],
                           out_dtype: torch.dtype) -> torch.Tensor:
    """The w8a8 product of rows quantized already: kernel on CUDA tensors,
    plain version on CPU ones.

    The kernel takes contiguous int8 ``x_q`` (..., K) with f32 ``x_s``
    (..., 1), a contiguous int8 ``w_q`` (K, N) with f32 ``w_s`` (1, N) or
    (N,), ``b`` None or (N,) of ``out_dtype``, and ``out_dtype`` bf16 or f32;
    any M, N and K."""
    if x_q.device.type == "cpu":
        return quant_matmul_dyn_pre_q_reference(x_q, x_s, w_q, w_s, b, out_dtype)
    lead = x_q.shape[:-1]
    k = x_q.shape[-1]
    n = w_q.shape[-1]
    m = x_q.numel() // max(k, 1)
    dev = x_q.device
    x2, s2 = x_q.reshape(m, k), x_s.reshape(m, 1)
    _build.check_tensor(x2, (m, k), (torch.int8,), "x_q", dev)
    _build.check_tensor(s2, (m, 1), (torch.float32,), "x_s", dev)
    _build.check_tensor(w_q, (k, n), (torch.int8,), "w_q", dev)
    _build.check_tensor(w_s.reshape(1, n), (1, n), (torch.float32,), "w_s", dev)
    if b is not None:
        _build.check_tensor(b, (n,), (out_dtype,), "b", dev)
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"quant_matmul_dyn: out_dtype {out_dtype} not in {_OUT_DTYPES}")
    if k == 0 or n == 0:
        raise ValueError(f"quant_matmul_dyn: unsupported shape M={m} K={k} N={n}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out.reshape(*lead, n)
    err = _build.load_library().apertis_quant_matmul_dyn(
        x2.data_ptr(), s2.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), m, n, k,
        int(out_dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "quant_matmul_dyn")
    quant_matmul_dyn_pre_q.launches += 1
    return out.reshape(*lead, n)


def quant_matmul_dyn(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic w8a8 linear (``quant_matmul_dyn`` then ``+ b``): the rows of
    ``x`` quantized per row at run time, the result in ``x.dtype``."""
    x_q, x_s = quantize_rows(x)
    return quant_matmul_dyn_pre_q(x_q, x_s, w_q, w_s, b, x.dtype)


quant_matmul_dyn_pre_q.launches = 0
