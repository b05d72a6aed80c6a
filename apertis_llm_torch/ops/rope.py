"""Rotary position embeddings, Apertis variant (``apertis_llm_tpu/ops/rope.py``).

Parity-critical quirk (reference: src/model/core.py:258-293, 676-683): RoPE
rotates the *full* ``hidden_size``-wide Q/K vectors BEFORE the head split,
on interleaved pairs ``(x[..., 2i], x[..., 2i+1])``, with frequencies indexed
over the full width. The rotation computes in float32 and casts back.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_tables(dim: int, max_positions: int, base: float = 10000.0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (max_positions, dim // 2) in float32, built
    as JAX builds them: ``inv_freq = 1 / base ** (arange(0, dim, 2) / dim)``,
    then ``t (x) inv_freq``."""
    if dim % 2 != 0:
        raise ValueError(f"RoPE dimension must be even, got {dim}")
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
    t = torch.arange(max_positions, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, position_ids: torch.Tensor, cos_table: torch.Tensor,
               sin_table: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (B, L, D) by positions (B, L) or (L,):
    ``out[2i] = x[2i] cos_i - x[2i+1] sin_i``,
    ``out[2i+1] = x[2i] sin_i + x[2i+1] cos_i``."""
    if position_ids.dim() == 1:
        position_ids = position_ids[None, :]
    pos = position_ids.long()
    return rotate(x, cos_table[pos], sin_table[pos])


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The rotation of :func:`apply_rope` with the table rows already taken:
    ``cos``, ``sin`` (..., D/2) broadcast against ``x`` (..., D)."""
    xf = x.float().reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1)
    return out.reshape(x.shape).to(x.dtype)
