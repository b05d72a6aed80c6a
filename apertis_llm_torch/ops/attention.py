"""Plain multi-head attention over full sequences (``apertis_llm_tpu/ops/
attention.py``): the causal and padding biases and the softmax attention the
JAX package leaves to XLA. This is the path of ``prefill`` (which always
carries the padding mask) and of ``forward`` with a mask or below the flash
gate; the causal flash kernel (``ops/kernels/flash_attention.py``) takes
``forward`` without a mask.

The causal convention matches the reference's cached-decode offset: query
``i`` at absolute position ``kv_len - q_len + i`` attends key ``j`` iff
``kv_len - q_len + i >= j`` (reference: src/model/core.py:793-830).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def causal_mask_bias(q_len: int, kv_len: int, device=None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive (q_len, kv_len) causal bias with the decode offset."""
    rows = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    cols = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(rows >= cols, zero, torch.full_like(zero, NEG_INF))


def build_bias(attention_mask: torch.Tensor, q_len: int, past_len: int = 0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Causal x padding additive bias (B, 1, q_len, kv_len) (``apertis.py::
    _build_bias``; reference: core.py:1088-1139). A key that is both in the
    future and padded gets ``NEG_INF`` twice, which overflows to ``-inf`` as
    in JAX; a row always has key 0 valid, so no softmax row is all ``-inf``."""
    kv_len = past_len + q_len
    dev = attention_mask.device
    causal = causal_mask_bias(q_len, kv_len, dev, dtype)[None, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    padding = torch.where(attention_mask[:, None, None, :kv_len] > 0, zero,
                          torch.full_like(zero, NEG_INF))
    return causal + padding


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor] = None, causal: bool = True) -> torch.Tensor:
    """Softmax attention, q (B, H, Lq, Dh), k and v (B, H, Lkv, Dh) -> (B, H,
    Lq, Dh). The operands are upcast before the score product (a product in
    bf16 would round the scores; JAX accumulates them in f32), the scores
    are scaled and biased in f32, and the probabilities are cast to
    ``v.dtype`` before the context product, whose result is cast to
    ``v.dtype``."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    elif causal and q.shape[2] > 1:
        scores = scores + causal_mask_bias(q.shape[2], k.shape[2], q.device)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (probs / probs.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)
