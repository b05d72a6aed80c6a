"""Decode attention of one query per row over one layer of the flat KV cache.

``mha_decode_ctx`` (bf16 cache) and ``mha_decode_ctx_int8`` (int8 cache with
per-(head, slot) scales) launch the CUDA kernel in ``csrc/mha_step.cu`` for
CUDA tensors and run :func:`mha_decode_ctx_reference`, their plain PyTorch
version, for CPU tensors. They replace ``apertis_llm_tpu/ops/pallas/
mha_step.py::mha_decode_ctx``.

The cache is JAX's flat layout: slot ``l`` of row ``b`` holds the head-flat
(H * Dh) projection row, so a slot's heads are contiguous. The attention
runs over the stale-slot-masked cache plus an explicit self-term for the
fresh token's K/V, which the caller writes to its slot afterwards. An f32
``q`` takes the f32 forms (:func:`mha_decode_ctx_f32`,
:func:`mha_decode_ctx_int8_f32`): the same kernel instantiated on f32.
:func:`quantize_heads` is that write's int8 quantization (plain torch, as the
JAX package leaves it to XLA).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build

NEG = -1e30        # additive bias of a masked slot (mha_step.py:51)
# Every multiple of 32 up to 256: lanes of a warp each hold Dh / 32 values
# (csrc). The model serves other head widths through the plain version.
_HEAD_DIMS = (32, 64, 96, 128, 160, 192, 224, 256)


def kernel_takes(head_dim: int) -> bool:
    """Whether the kernel serves heads of ``head_dim``: a multiple of 32 up
    to 256."""
    return head_dim in _HEAD_DIMS


def quantize_heads(t: torch.Tensor, head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per head segment of the trailing axis (D = H * Dh):
    ``(q int8, same shape; scale f32, shape[:-1] + (H,))`` with ``scale =
    max(absmax, 1e-8) * (1/127)`` and ``q = clip(round(t / scale), +-127)``
    (``mha_step.py::quantize_heads``); ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    lead = t.shape[:-1]
    heads = t.shape[-1] // head_dim
    tf = t.float().reshape(*lead, heads, head_dim)
    scale = torch.clamp(tf.abs().amax(dim=-1), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(t.shape), scale


def mha_decode_ctx_reference(
    q: torch.Tensor,          # (B, D) head-flat, post-RoPE, not yet scaled
    k: torch.Tensor,          # (B, L, D) cache of one layer (float, or int8 with scales)
    v: torch.Tensor,          # (B, L, D)
    k_new: torch.Tensor,      # (B, D) the fresh token's key (self-term)
    v_new: torch.Tensor,      # (B, D)
    bias: torch.Tensor,       # (B, L) additive f32: 0 valid, NEG masked
    head_dim: int,
    k_scale: Optional[torch.Tensor] = None,   # (B, H, L) f32 per-(head, slot) scales
    v_scale: Optional[torch.Tensor] = None,   # (B, H, L) f32
) -> torch.Tensor:
    """The TPU kernel's arithmetic (mha_step.py:54-127, 146-215), per row and
    head: ``q`` scaled by ``head_dim ** -0.5`` in f32 and cast back to its
    dtype; the self-term score ``sum q * k_new`` in f32; cached scores
    ``sum q * k`` in f32, or with an int8 cache ``f32(int32 sum q_i * k) *
    (ks * qs)`` where ``q_i``, ``qs`` quantize q per head; ``+ bias``; a
    softmax whose denominator includes the self-term; an int8 cache's V
    scales folded into the probabilities; ``ctx = sum p * v + p_self *
    v_new`` in f32, times ``1 / denom``, cast to q's dtype. Returns (B, D)."""
    b, d = q.shape
    l = k.shape[1]
    heads = d // head_dim
    qs = (q.float() * head_dim ** -0.5).to(q.dtype)
    qh = qs.float().reshape(b, heads, head_dim)
    s_self = (qh * k_new.float().reshape(b, heads, head_dim)).sum(dim=-1)   # (B, H)
    kh = k.reshape(b, l, heads, head_dim).float()
    if k_scale is None:
        q_c = qs.to(k.dtype).float().reshape(b, heads, head_dim)
        s = torch.einsum("bhd,blhd->bhl", q_c, kh)
    else:
        qscale = torch.clamp(qh.abs().amax(dim=-1), min=1e-8) * (1.0 / 127.0)    # (B, H)
        q_i = torch.clamp(torch.round(qh / qscale[..., None]), -127, 127)
        # int8 x int8 sums of at most 256 terms stay below 2^24: exact in f32.
        s = torch.einsum("bhd,blhd->bhl", q_i, kh) * (k_scale * qscale[..., None])
    s = s + bias[:, None, :].float()
    m = torch.maximum(s.amax(dim=-1), s_self)                               # (B, H)
    p = torch.exp(s - m[..., None])
    p_self = torch.exp(s_self - m)
    denom = p.sum(dim=-1) + p_self
    if v_scale is not None:
        p = p * v_scale
    ctx = torch.einsum("bhl,blhd->bhd", p, v.reshape(b, l, heads, head_dim).float())
    ctx = ctx + p_self[..., None] * v_new.float().reshape(b, heads, head_dim)
    return (ctx * (1.0 / denom)[..., None]).reshape(b, d).to(q.dtype)


def _launch(q, k, v, k_new, v_new, bias, head_dim, k_scale, v_scale, name, f32=False):
    b, d = q.shape
    l = k.shape[1]
    dev = q.device
    if head_dim not in _HEAD_DIMS or d % head_dim:
        raise ValueError(f"{name}: head_dim {head_dim} not in {_HEAD_DIMS} or D={d} "
                         "not a multiple of it")
    if b == 0 or l == 0:
        raise ValueError(f"{name}: empty shape B={b} L={l}")
    heads = d // head_dim
    f32s = (torch.float32,)
    rows = f32s if f32 else (torch.bfloat16,)
    cache_dtype = (torch.int8,) if k_scale is not None else rows
    for t, shape, dtypes, label in ((q, (b, d), rows, "q"), (k, (b, l, d), cache_dtype, "k"),
                                    (v, (b, l, d), cache_dtype, "v"),
                                    (k_new, (b, d), rows, "k_new"),
                                    (v_new, (b, d), rows, "v_new"), (bias, (b, l), f32s, "bias")):
        _build.check_tensor(t, shape, dtypes, label, dev)
    if k_scale is not None:
        _build.check_tensor(k_scale, (b, heads, l), f32s, "k_scale", dev)
        _build.check_tensor(v_scale, (b, heads, l), f32s, "v_scale", dev)
    _build.check_aligned(name, k, v)
    out = torch.empty((b, d), dtype=rows[0], device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            bias.data_ptr())
    if f32:
        scales = (None, None) if k_scale is None else (k_scale.data_ptr(), v_scale.data_ptr())
        err = lib.apertis_mha_decode_ctx_f32(*ptrs, *scales, out.data_ptr(), b, l, heads,
                                             head_dim, stream)
    elif k_scale is None:
        err = lib.apertis_mha_decode_ctx(*ptrs, out.data_ptr(), b, l, heads, head_dim, stream)
    else:
        err = lib.apertis_mha_decode_ctx_int8(*ptrs, k_scale.data_ptr(), v_scale.data_ptr(),
                                              out.data_ptr(), b, l, heads, head_dim, stream)
    _build.check(err, name)
    return out


def mha_decode_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, bias: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Decode attention over a float cache: kernel on CUDA tensors, plain
    version on CPU ones. The kernel takes contiguous bf16 ``q``, ``k_new``,
    ``v_new`` (B, D) and cache ``k``, ``v`` (B, L, D), f32 ``bias`` (B, L),
    and ``head_dim`` a multiple of 32 up to 256; it returns bf16 (B, D). An
    f32 ``q`` goes to the f32 form :func:`mha_decode_ctx_f32`."""
    if q.device.type == "cpu":
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, head_dim)
    if q.dtype == torch.float32:
        return mha_decode_ctx_f32(q, k, v, k_new, v_new, bias, head_dim)
    out = _launch(q, k, v, k_new, v_new, bias, head_dim, None, None, "mha_decode_ctx")
    mha_decode_ctx.launches += 1
    return out


def mha_decode_ctx_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor, bias: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor,
                        head_dim: int) -> torch.Tensor:
    """Decode attention over an int8 cache with f32 per-(head, slot) scales
    ``k_scale``, ``v_scale`` (B, H, L): kernel on CUDA tensors, plain version
    on CPU ones. Otherwise as :func:`mha_decode_ctx`."""
    if q.device.type == "cpu":
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, head_dim,
                                        k_scale, v_scale)
    if q.dtype == torch.float32:
        return mha_decode_ctx_int8_f32(q, k, v, k_new, v_new, bias, k_scale, v_scale, head_dim)
    out = _launch(q, k, v, k_new, v_new, bias, head_dim, k_scale, v_scale,
                  "mha_decode_ctx_int8")
    mha_decode_ctx_int8.launches += 1
    return out


def mha_decode_ctx_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, bias: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The f32 form over an f32 cache (``csrc/mha_step.cu``,
    ``apertis_mha_decode_ctx_f32``): f32 ``q``, ``k_new``, ``v_new`` and
    cache, f32 output; otherwise as :func:`mha_decode_ctx`. Plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, head_dim)
    out = _launch(q, k, v, k_new, v_new, bias, head_dim, None, None, "mha_decode_ctx_f32",
                  f32=True)
    mha_decode_ctx_f32.launches += 1
    return out


def mha_decode_ctx_int8_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor, bias: torch.Tensor,
                            k_scale: torch.Tensor, v_scale: torch.Tensor,
                            head_dim: int) -> torch.Tensor:
    """The f32 form over an int8 cache with its f32 scales: f32 ``q``,
    ``k_new``, ``v_new`` and output; otherwise as :func:`mha_decode_ctx_int8`.
    Plain version on CPU tensors."""
    if q.device.type == "cpu":
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, head_dim,
                                        k_scale, v_scale)
    out = _launch(q, k, v, k_new, v_new, bias, head_dim, k_scale, v_scale,
                  "mha_decode_ctx_int8_f32", f32=True)
    mha_decode_ctx_int8_f32.launches += 1
    return out


mha_decode_ctx.launches = 0
mha_decode_ctx_int8.launches = 0
mha_decode_ctx_f32.launches = 0
mha_decode_ctx_int8_f32.launches = 0
