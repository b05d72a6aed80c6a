"""Fused pre-norm + per-row int8 quantize: the int8 prefill's pre-norms.

``ln_quantize`` launches the CUDA kernel in ``csrc/ln_quant.cu`` for CUDA
tensors and runs :func:`ln_quantize_reference`, its plain PyTorch version,
for CPU tensors. It replaces ``apertis_llm_tpu/ops/pallas/ln_quant.py::
ln_quantize``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build

_ROWS = 8          # rows per block, one warp each (csrc/ln_quant.cu kRows)


def ln_quantize_reference(
    x: torch.Tensor,                 # (..., H)
    weight: torch.Tensor,            # (H,) LayerNorm weight or RMSNorm scale
    bias: Optional[torch.Tensor],    # (H,) LayerNorm bias; None = RMSNorm
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_q int8 (..., H), x_s f32 (..., 1))`` with ``x_q * x_s ~= norm(x)``.
    The norm runs in f32 (RMSNorm with eps on the RMS and a zero inverse on
    zero rows; LayerNorm with a zero inverse on constant rows), is rounded
    through ``x.dtype``, then ``x_s = max(absmax, 1e-8) * (1/127)`` and
    ``x_q = clip(rint(normed / x_s), +-127)``."""
    xf = x.float()
    w = weight.float()
    if bias is None:
        ss = (xf * xf).sum(dim=-1, keepdim=True)
        rms = torch.where(ss > 0, torch.sqrt(torch.where(ss > 0, ss, torch.ones_like(ss))),
                          torch.zeros_like(ss)) * (x.shape[-1] ** -0.5)
        inv = torch.where(ss > 0, 1.0 / (rms + eps), torch.zeros_like(rms))
        normed = xf * inv * w
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        inv = torch.where(var > 0, 1.0 / torch.sqrt(var + eps), torch.zeros_like(var))
        normed = (xf - mean) * inv * w + bias.float()
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

    The kernel takes contiguous bf16 ``x`` of any leading shape and bf16
    weights; ``bias`` None selects RMSNorm.
    """
    if x.device.type == "cpu":
        return ln_quantize_reference(x, weight, bias, eps)
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
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=dev)
    err = _build.load_library().apertis_ln_quantize(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        q.data_ptr(), s.data_ptr(), rows, h, int(bias is None), float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ln_quantize")
    ln_quantize.launches += 1
    return q, s


ln_quantize.launches = 0
