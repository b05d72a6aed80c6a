"""Selective-SSM primitives: the fused mixer scan and the depthwise causal conv.

The recurrence (reference: src/model/core.py:337-353), per batch row, head
and state channel:

    h_t = exp(delta_t * A) * h_{t-1} + B_t          y_t = C_t * h_t

with ``A = -exp(A_log)`` diagonal and an f32 carry. ``ssm_mix`` runs it over
a whole sequence through ``ops/kernels/ssm_scan.py`` (the CUDA kernels on the
card, their plain versions on the CPU), as :class:`SelectiveScan`, a
``torch.autograd.Function``, when a gradient is wanted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels.ssm_scan import selective_scan_bwd, selective_scan_fwd


class SelectiveScan(torch.autograd.Function):
    """``(y, h_last)`` of :func:`selective_scan_fwd` with its gradient, the
    JAX package's custom VJP of ``gated_scan_2d`` (ssm_scan.py:290-321)
    together with XLA's derivative of ``exp(delta * A)``. The forward keeps
    every f32 state for the backward (:func:`selective_scan_bwd`), which
    returns the gradients of ``delta``, ``a_cont``, ``b_term`` and
    ``c_mod``; the mask and the output dtype take none."""

    @staticmethod
    def forward(ctx, delta, a_cont, b_term, c_mod, seq_mask, out_dtype):
        y, h_last, hs = selective_scan_fwd(delta, a_cont, b_term, c_mod, seq_mask,
                                           out_dtype, want_h=True)
        ctx.save_for_backward(delta, a_cont, c_mod, seq_mask, hs)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, gy, g_last):
        delta, a_cont, c_mod, seq_mask, hs = ctx.saved_tensors
        if gy is None:
            b, l, h, n = hs.shape
            gy = torch.zeros((b, l, h * n), dtype=torch.float32, device=hs.device)
        d_delta, d_a, db, dc = selective_scan_bwd(
            delta, a_cont, c_mod, seq_mask, hs, gy.contiguous(),
            None if g_last is None else g_last.float().contiguous())
        return d_delta, d_a, db, dc, None, None


def ssm_mix(
    delta: torch.Tensor,     # (B, L, H) float32 softplus'd timescales
    a_cont: torch.Tensor,    # (H, N) float32 continuous-time A (negative)
    b_term: torch.Tensor,    # (B, L, H, N) recurrence inputs
    c_mod: torch.Tensor,     # (B, L, H, N) output gates
    seq_mask: Optional[torch.Tensor] = None,  # (B, L) 1 = real token
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused selective mixer ``y = C * scan(exp(delta * A), B)``.

    Returns ``(y, h_last)`` with ``y`` of shape (B, L, H*N) in ``out_dtype``
    (default ``b_term.dtype``) and ``h_last`` (B, H, N) float32. Masked
    (padded) steps are identity transitions, so ``h_last`` is the state after
    each row's last real token. With grad enabled and an input that requires
    grad it runs as :class:`SelectiveScan`; otherwise (serving, under
    ``no_grad``) the forward kernel writes no states.
    """
    if seq_mask is not None:
        seq_mask = (seq_mask != 0).to(torch.int32).contiguous()
    args = (delta.float().contiguous(), a_cont.float().contiguous(),
            b_term.contiguous(), c_mod.to(b_term.dtype).contiguous(), seq_mask,
            out_dtype or b_term.dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:4]):
        return SelectiveScan.apply(*args)
    return selective_scan_fwd(*args)


def depthwise_causal_conv(
    x: torch.Tensor,        # (B, L, C)
    weight: torch.Tensor,   # (C, K) per-channel taps
    bias: Optional[torch.Tensor] = None,   # (C,)
) -> torch.Tensor:
    """Causal depthwise conv: ``out[t] = sum_j w[j] * x[t - K + 1 + j] (+ bias)``,
    torch ``Conv1d(C, C, K, groups=C, padding=K-1)`` truncated to the first L
    outputs, as an unrolled shifted sum over the K taps."""
    k = weight.shape[-1]
    l = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + l, :] * weight[:, j]
    if bias is not None:
        out = out + bias
    return out


def depthwise_conv_step(
    conv_state: torch.Tensor,  # (B, K-1, C) trailing inputs
    x_t: torch.Tensor,         # (B, C) current input
    weight: torch.Tensor,      # (C, K)
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token causal conv over the carried window; returns
    ``(y_t, new_conv_state)``."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, weight)
    if bias is not None:
        y = y + bias
    return y, window[:, 1:, :]
