"""Causal flash attention over full sequences, forward.

``flash_attention_fwd`` launches the CUDA kernel in ``csrc/flash_attention.cu``
for CUDA tensors and runs :func:`flash_attention_fwd_reference`, its plain
PyTorch version, for CPU tensors. It replaces the forward of
``apertis_llm_tpu/ops/pallas/flash_attention.py::flash_attention`` and
returns the log-sum-exp beside the output, for the backward kernel to come.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apertis_llm_torch.ops.kernels import _build

NEG_INF = -1e30      # flash_attention.py:31


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, H, L, Dh) in q's dtype, lse (B, H, L) f32)`` for q, k, v
    (B, H, L, Dh), with the TPU kernel's arithmetic in one block: ``s = (q *
    Dh^-1/2) k^T`` in f32, ``NEG_INF`` above the diagonal when causal,
    ``p = exp(s - max s)``, ``l = max(sum p, 1e-30)``, ``out = (p v) / l``
    with p in f32, ``lse = max s + log l``."""
    lq, lk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float() * q.shape[-1] ** -0.5, k.float().transpose(-1, -2))
    if causal:
        rows = torch.arange(lq, device=q.device)[:, None]
        cols = torch.arange(lk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = (torch.matmul(p, v.float()) / l).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention forward: kernel on CUDA tensors, plain version on CPU
    ones. The kernel takes contiguous bf16 q, k, v of one shape (B, H, L, Dh)
    with Dh a multiple of 8 up to 256, and returns bf16 ``out`` and f32
    ``lse``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal)
    b, h, l, dh = q.shape
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_tensor(t, (b, h, l, dh), (torch.bfloat16,), name, dev)
    if b * h == 0 or l == 0 or dh % 8 or dh > 256:
        raise ValueError(f"flash_attention_fwd: unsupported shape {tuple(q.shape)}")
    _build.check_aligned("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=dev)
    err = _build.load_library().apertis_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b * h, l,
        dh, int(causal), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
