"""The int8-weight products of serving: the three kernels of ``csrc/quant_matmul.cu``.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (``*_reference``) for CPU tensors. The weight is the JAX
tree's row-major (K, N) int8 ``w_q``, read as it is, with f32 column scales
``w_s``; a bias is added in the output type after the kernel's one rounding.

  * :func:`quant_matmul_dyn_pre_q` (``quant_matmul_dyn``, #7): the w8a8
    product of rows quantized already, with its dequantizing epilogue
    ``acc * x_s * w_s``: every int8 linear under ``quant_matmul="dyn"`` and
    the int8 decode projections in every mode. :func:`quant_matmul_dyn` is
    its form that quantizes its input rows first (``ops/quant.py::
    quantize_rows``, plain torch);
  * :func:`quant_matmul` (#6, ``quant_matmul="pallas"``): the weight-only
    product ``x.dtype((x @ float(w_q)) * w_s)`` with f32 accumulation;
  * :func:`quant_matmul_dyn_fused` (#8, ``quant_matmul="fused"``): the w8a8
    product that quantizes x inside the kernel per row and 512-wide K block.

They replace ``apertis_llm_tpu/ops/pallas/quant_matmul.py``'s
``quant_matmul_dyn``, ``quant_matmul`` and ``quant_matmul_dyn_fused``.
"""

from __future__ import annotations

from typing import Optional

import torch

from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.quant import int_mm, linear_pre_q_reference, quantize_rows

_OUT_DTYPES = (torch.bfloat16, torch.float32)
# quant_matmul_dyn_fused's K block: x is quantized per row over columns
# [512 j, 512 j + 512) (quant_matmul.py BLOCK_K; one block when K <= 512).
QUANT_BLOCK_K = 512


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


def quant_matmul_reference(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """#6's arithmetic (``quant_matmul.py::_kernel``): ``x @ float(w_q)`` in
    f32 (the products of bf16 or f32 x with int8 levels, f32 sums), times
    ``w_s`` in f32, one rounding to x's dtype, then ``+ b``."""
    lead = x.shape[:-1]
    acc = x.reshape(-1, x.shape[-1]).float() @ w_q.float()
    y = (acc * w_s.reshape(1, -1).float()).to(x.dtype).reshape(*lead, w_q.shape[-1])
    return y + b if b is not None else y


def quant_matmul_dyn_fused_reference(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """#8's arithmetic (``quant_matmul.py::_dyn_fused_kernel``), block by
    block: for each 512-wide K block j, ``s_j = max(absmax, 1e-8) * (1/127)``
    per row (a multiply, where ``quantize_rows`` divides by 127), ``q =
    clip(rint(x / s_j))`` (a true division), ``acc += float(q @ w_q[j]) *
    s_j``; then ``x.dtype(acc * w_s)`` and ``+ b``."""
    lead, k, n = x.shape[:-1], x.shape[-1], w_q.shape[-1]
    xf = x.reshape(-1, k).float()
    acc = torch.zeros((xf.shape[0], n), dtype=torch.float32, device=x.device)
    for j0 in range(0, k, QUANT_BLOCK_K):
        xb = xf[:, j0:j0 + QUANT_BLOCK_K]
        s = torch.clamp(xb.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
        acc = acc + int_mm(q, w_q[j0:j0 + QUANT_BLOCK_K]).float() * s
    y = (acc * w_s.reshape(1, -1).float()).to(x.dtype).reshape(*lead, n)
    return y + b if b is not None else y


def _launch_float_x(wrapper, entry: str, x: torch.Tensor, w_q: torch.Tensor,
                    w_s: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Check the operands of a kernel that reads bf16 or f32 x, launch
    ``entry`` (none for an x without rows), count the launch on
    ``wrapper`` and return the (..., N) result in x's dtype."""
    lead, k, n = x.shape[:-1], x.shape[-1], w_q.shape[-1]
    m = x.numel() // max(k, 1)
    dev = x.device
    if x.dtype not in _OUT_DTYPES:
        raise ValueError(f"{entry}: x dtype {x.dtype} not in {_OUT_DTYPES}")
    x2 = x.reshape(m, k)
    _build.check_tensor(x2, (m, k), _OUT_DTYPES, "x", dev)
    _build.check_tensor(w_q, (k, n), (torch.int8,), "w_q", dev)
    _build.check_tensor(w_s.reshape(1, n), (1, n), (torch.float32,), "w_s", dev)
    if b is not None:
        _build.check_tensor(b, (n,), (x.dtype,), "b", dev)
    if k == 0 or n == 0:
        raise ValueError(f"{entry}: unsupported shape M={m} K={k} N={n}")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m > 0:
        err = getattr(_build.load_library(), entry)(
            x2.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), m, n, k, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, entry)
        wrapper.launches += 1
    return out.reshape(*lead, n)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weight-only product (#6): kernel on CUDA tensors, plain version on
    CPU ones. The kernel takes contiguous bf16 or f32 ``x`` (..., K), a
    contiguous int8 ``w_q`` (K, N), f32 ``w_s`` (1, N) or (N,) and ``b``
    None or (N,) of x's dtype; any M, N and K."""
    if x.device.type == "cpu":
        return quant_matmul_reference(x, w_q, w_s, b)
    return _launch_float_x(quant_matmul, "apertis_quant_matmul", x, w_q, w_s, b)


def quant_matmul_dyn_fused(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The w8a8 product with x quantized in the kernel per row and 512-wide
    K block (#8): kernel on CUDA tensors, plain version on CPU ones. Takes
    what :func:`quant_matmul` takes."""
    if x.device.type == "cpu":
        return quant_matmul_dyn_fused_reference(x, w_q, w_s, b)
    return _launch_float_x(quant_matmul_dyn_fused, "apertis_quant_matmul_dyn_fused", x, w_q,
                           w_s, b)


quant_matmul_dyn_pre_q.launches = 0
quant_matmul.launches = 0
quant_matmul_dyn_fused.launches = 0
