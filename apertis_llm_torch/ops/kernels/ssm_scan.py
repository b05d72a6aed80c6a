"""Selective scan over a whole sequence: the prefill half of the SSM mixer.

``selective_scan_fwd`` launches the CUDA kernel in ``csrc/ssm_scan.cu`` for
CUDA tensors and runs :func:`selective_scan_fwd_reference`, its plain PyTorch
version, for CPU tensors. It replaces the forward of
``apertis_llm_tpu/ops/pallas/ssm_scan.py::gated_scan_2d`` together with the
layout work ``ops/ssm.py::ssm_mix`` did around it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build


def selective_scan_fwd_reference(
    delta: torch.Tensor,      # (B, L, H) float32 softplus'd timescales
    a_cont: torch.Tensor,     # (H, N) float32 continuous-time A (negative)
    b_term: torch.Tensor,     # (B, L, H, N) recurrence inputs
    c_mod: torch.Tensor,      # (B, L, H, N) output gates
    seq_mask: Optional[torch.Tensor] = None,  # (B, L), nonzero = real token
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y = C * scan(exp(delta * A), B)`` step by step with an f32 carry;
    a masked step is the identity (a = 1, b = 0). Returns ``(y (B, L, H*N)
    in out_dtype, h_last (B, H, N) float32)``."""
    b, l, h, n = b_term.shape
    a_bar = torch.exp(delta.float()[..., None] * a_cont.float())   # (B, L, H, N)
    bb = b_term.float()
    if seq_mask is not None:
        m = (seq_mask != 0).float()[:, :, None, None]
        a_bar = a_bar * m + (1.0 - m)
        bb = bb * m
    carry = torch.zeros((b, h, n), dtype=torch.float32, device=b_term.device)
    hs = torch.empty((b, l, h, n), dtype=torch.float32, device=b_term.device)
    for t in range(l):
        carry = a_bar[:, t] * carry + bb[:, t]
        hs[:, t] = carry
    y = (c_mod.float() * hs).reshape(b, l, h * n)
    return y.to(out_dtype or b_term.dtype), carry


def selective_scan_fwd(
    delta: torch.Tensor,
    a_cont: torch.Tensor,
    b_term: torch.Tensor,
    c_mod: torch.Tensor,
    seq_mask: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes ``delta`` and ``a_cont`` in float32, ``b_term`` and
    ``c_mod`` contiguous in one dtype (bfloat16 or float32), ``seq_mask`` as a
    contiguous int32 (B, L) or None, and ``out_dtype`` bfloat16 or float32.
    """
    out_dtype = out_dtype or b_term.dtype
    if b_term.device.type == "cpu":
        return selective_scan_fwd_reference(delta, a_cont, b_term, c_mod,
                                            seq_mask, out_dtype)
    bsz, l, h, n = b_term.shape
    dev = b_term.device
    _build.check_tensor(delta, (bsz, l, h), (torch.float32,), "delta", dev)
    _build.check_tensor(a_cont, (h, n), (torch.float32,), "a_cont", dev)
    _build.check_tensor(b_term, (bsz, l, h, n), (torch.bfloat16, torch.float32), "b_term", dev)
    _build.check_tensor(c_mod, (bsz, l, h, n), (b_term.dtype,), "c_mod", dev)
    if seq_mask is not None:
        _build.check_tensor(seq_mask, (bsz, l), (torch.int32,), "seq_mask", dev)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"selective_scan_fwd: out_dtype {out_dtype} not supported")
    if bsz == 0 or l == 0 or h * n == 0:
        raise ValueError(f"selective_scan_fwd: empty shape {tuple(b_term.shape)}")
    y = torch.empty((bsz, l, h * n), dtype=out_dtype, device=dev)
    h_last = torch.empty((bsz, h, n), dtype=torch.float32, device=dev)
    err = _build.load_library().apertis_selective_scan_fwd(
        delta.data_ptr(), a_cont.data_ptr(), b_term.data_ptr(), c_mod.data_ptr(),
        seq_mask.data_ptr() if seq_mask is not None else None,
        y.data_ptr(), h_last.data_ptr(), bsz, l, h, n,
        int(b_term.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "selective_scan_fwd")
    selective_scan_fwd.launches += 1
    return y, h_last


selective_scan_fwd.launches = 0

