"""Causal flash attention over full sequences, forward and backward.

``flash_attention_fwd`` launches the CUDA kernel in ``csrc/flash_attention.cu``
and ``flash_attention_dq`` / ``flash_attention_dkv`` those in
``csrc/flash_attention_bwd.cu`` for bf16 CUDA tensors;
``flash_attention_fwd_f32``, ``flash_attention_dq_f32`` and
``flash_attention_dkv_f32`` launch the f32 kernels of
``csrc/flash_attention_f32.cu`` for f32 CUDA tensors. For CPU tensors each
runs its plain PyTorch version (``*_reference``, which takes either dtype).
They replace ``apertis_llm_tpu/ops/pallas/flash_attention.py::
flash_attention``: its forward, which returns the log-sum-exp beside the
output, and its backward (``_flash_bwd``), which recomputes the
probabilities from it. :class:`FlashAttention` is the
``torch.autograd.Function`` around the three, choosing the bf16 or the f32
kernels by q's dtype. :func:`flash_attention_resources` reports what the
card gives each kernel, bf16 and f32 (registers, shared memory, resident
blocks).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build

NEG_INF = -1e30      # flash_attention.py:31
# The bf16 and the f32 kernels, in the order of
# apertis_flash_attention_resources' codes (0-2, 3-5).
BF16_KERNELS = ("forward", "dq", "dkv")
F32_KERNELS = ("forward_f32", "dq_f32", "dkv_f32")
RESOURCE_KEYS = ("registers", "shared_bytes", "blocks_per_sm", "threads", "spill_bytes")


def supported_head_dim(dh: int) -> bool:
    """Whether the bf16 kernels take heads of width ``dh``: a multiple of 8
    (rows of whole 16-byte units, which their TMA tensor maps need) up to
    256."""
    return 0 < dh <= 256 and dh % 8 == 0


def flash_attention_resources(kernel: str, head_dim: int) -> Dict[str, int]:
    """What the card gives ``kernel`` (one of :data:`BF16_KERNELS` or
    :data:`F32_KERNELS`) at ``head_dim``: registers a thread, shared memory
    a block in bytes, resident blocks an SM (the occupancy calculator's),
    threads a block and spilled bytes a thread."""
    kernels = BF16_KERNELS + F32_KERNELS
    if kernel not in kernels:
        raise ValueError(f"flash_attention_resources: unknown kernel {kernel!r}")
    if not supported_head_dim(head_dim):
        raise ValueError(f"flash_attention_resources: unsupported head_dim {head_dim}")
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = _build.load_library().apertis_flash_attention_resources(
        kernels.index(kernel), head_dim, ctypes.addressof(out))
    _build.check(err, "flash_attention_resources")
    return dict(zip(RESOURCE_KEYS, out))


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
    if b * h == 0 or l == 0 or not supported_head_dim(dh):
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


def _probabilities(q, k, lse, causal):
    """``(p (B, H, L, L) f32, scale)`` with the forward kernel's arithmetic:
    ``s = (q k^T) * Dh^-1/2`` in f32, ``p = exp(s - lse)``, 0 above the
    diagonal when causal."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        rows = torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(k.shape[2], device=q.device)[None, :]
        p = torch.where(rows >= cols, p, torch.zeros_like(p))
    return p, scale


def _score_grad(q, k, v, dout, lse, delta, causal):
    """``(p, ds)`` of the backward (flash_attention.py:147-161, 186-200):
    ``ds = p * (dout v^T - delta) * Dh^-1/2``, in f32."""
    p, scale = _probabilities(q, k, lse, causal)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_dq_reference(q, k, v, dout, lse, delta, causal: bool = True) -> torch.Tensor:
    """``dq = ds k`` (B, H, L, Dh) in q's dtype, the TPU ``_dq_kernel``'s
    arithmetic in one block."""
    _, ds = _score_grad(q, k, v, dout, lse, delta, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, dout, lse, delta,
                                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk = ds^T q, dv = p^T dout)`` in k's and v's dtypes, the TPU
    ``_dkv_kernel``'s arithmetic in one block."""
    p, ds = _score_grad(q, k, v, dout, lse, delta, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(name, q, k, v, dout, lse, delta):
    b, h, l, dh = q.shape
    dev = q.device
    for t, tname in ((q, "q"), (k, "k"), (v, "v"), (dout, "dout")):
        _build.check_tensor(t, (b, h, l, dh), (torch.bfloat16,), tname, dev)
    for t, tname in ((lse, "lse"), (delta, "delta")):
        _build.check_tensor(t, (b, h, l), (torch.float32,), tname, dev)
    if b * h == 0 or l == 0 or not supported_head_dim(dh):
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}")
    _build.check_aligned(name, q, k, v, dout)


def flash_attention_dq(q, k, v, dout, lse, delta, causal: bool = True) -> torch.Tensor:
    """dQ of the attention: kernel on CUDA tensors, plain version on CPU ones.
    The kernel takes contiguous bf16 q, k, v, dout (B, H, L, Dh), Dh a
    multiple of 8 up to 256, the forward's f32 ``lse`` (B, H, L) and f32
    ``delta = sum_d out * dout`` (B, H, L), and returns bf16 ``dq``."""
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, dout, lse, delta, causal)
    _check_bwd("flash_attention_dq", q, k, v, dout, lse, delta)
    b, h, l, dh = q.shape
    dq = torch.empty_like(q)
    err = _build.load_library().apertis_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, l, dh, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, dout, lse, delta,
                        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of the attention: kernel on CUDA tensors, plain version on
    CPU ones; the kernel takes what :func:`flash_attention_dq` takes and
    returns bf16 ``(dk, dv)``."""
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, dout, lse, delta, causal)
    _check_bwd("flash_attention_dkv", q, k, v, dout, lse, delta)
    b, h, l, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load_library().apertis_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, l, dh, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def _check_f32(name, q, *others):
    """The f32 kernels' operands: contiguous f32 CUDA tensors, each (B, H,
    L, Dh) or (B, H, L), Dh a multiple of 8 up to 256; the (B, H, L, Dh)
    ones 16-byte aligned, since their TMA tensor maps need aligned bases."""
    b, h, l, dh = q.shape
    for t in (q,) + others:
        shape = (b, h, l, dh) if t.dim() == 4 else (b, h, l)
        _build.check_tensor(t, shape, (torch.float32,), name, q.device)
    if b * h == 0 or l == 0 or not supported_head_dim(dh):
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}")
    _build.check_aligned(name, *(t for t in (q,) + others if t.dim() == 4))


def flash_attention_fwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention forward with f32 operands: kernel on CUDA tensors, plain
    version on CPU ones. The kernel runs its products on the tensor cores in
    split TF32 (each f32 operand as a TF32 hi part and a TF32 lo remainder,
    hi*hi + hi*lo + lo*hi summed in f32: about f32 accuracy) and its softmax
    in f32. It takes contiguous, 16-byte aligned f32 q, k, v of one shape
    (B, H, L, Dh) with Dh a multiple of 8 up to 256, and returns f32 ``out``
    and ``lse``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal)
    _check_f32("flash_attention_fwd_f32", q, k, v)
    b, h, l, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    err = _build.load_library().apertis_flash_attention_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b * h, l,
        dh, int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd_f32")
    flash_attention_fwd_f32.launches += 1
    return out, lse


flash_attention_fwd_f32.launches = 0


def flash_attention_dq_f32(q, k, v, dout, lse, delta, causal: bool = True) -> torch.Tensor:
    """dQ with f32 operands: kernel on CUDA tensors, plain version on CPU
    ones. The kernel takes contiguous f32 q, k, v, dout (B, H, L, Dh), Dh a
    multiple of 8 up to 256, the forward's ``lse`` and ``delta = sum_d out *
    dout`` (B, H, L) f32, and returns f32 ``dq``."""
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, dout, lse, delta, causal)
    _check_f32("flash_attention_dq_f32", q, k, v, dout, lse, delta)
    b, h, l, dh = q.shape
    dq = torch.empty_like(q)
    err = _build.load_library().apertis_flash_attention_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, l, dh, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_dq_f32")
    flash_attention_dq_f32.launches += 1
    return dq


flash_attention_dq_f32.launches = 0


def flash_attention_dkv_f32(q, k, v, dout, lse, delta,
                            causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV with f32 operands: kernel on CUDA tensors, plain version on
    CPU ones; the kernel takes what :func:`flash_attention_dq_f32` takes and
    returns f32 ``(dk, dv)``."""
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, dout, lse, delta, causal)
    _check_f32("flash_attention_dkv_f32", q, k, v, dout, lse, delta)
    b, h, l, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load_library().apertis_flash_attention_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, l, dh, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_dkv_f32")
    flash_attention_dkv_f32.launches += 1
    return dk, dv


flash_attention_dkv_f32.launches = 0


def _kernels(dtype: torch.dtype):
    """The (forward, dQ, dK/dV) wrappers for q/k/v of ``dtype``: the f32
    kernels for f32, the bf16 ones otherwise (which raise on a CUDA tensor
    of another dtype)."""
    if dtype == torch.float32:
        return flash_attention_fwd_f32, flash_attention_dq_f32, flash_attention_dkv_f32
    return flash_attention_fwd, flash_attention_dq, flash_attention_dkv


class FlashAttention(torch.autograd.Function):
    """Causal self-attention ``out`` of q, k, v (B, H, L, Dh) with its
    gradient, the JAX package's custom VJP of ``flash_attention``: the
    forward (:func:`flash_attention_fwd`, or :func:`flash_attention_fwd_f32`
    for f32 q) saves q, k, v, out and the LSE; the backward forms ``delta =
    sum_d out * dout`` in f32 (plain torch, as the JAX package leaves it to
    XLA, flash_attention.py:246) and runs the dQ and dK/dV kernels of q's
    dtype. The f32 kernels' products run in split TF32 (see
    :func:`flash_attention_fwd_f32`), the bf16 ones' on bf16 tensor cores."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _kernels(q.dtype)[0](q, k, v, causal=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        _, dq_fn, dkv_fn = _kernels(q.dtype)
        dout = dout.to(q.dtype).contiguous()
        delta = (out.float() * dout.float()).sum(dim=-1)
        dq = dq_fn(q, k, v, dout, lse, delta, causal=True)
        dk, dv = dkv_fn(q, k, v, dout, lse, delta, causal=True)
        return dq, dk, dv
