"""Normalisation functions (the ``apertis_llm_tpu/ops/norms.py`` semantics).

  * RMSNorm follows the reference formulation ``x / (||x||_2 / sqrt(D) + eps)``:
    the epsilon is added to the RMS value itself, not to the variance.
  * LayerNorm matches ``torch.nn.LayerNorm`` (biased variance, eps under the
    sqrt) with weight and bias.

Both compute in float32 and cast back. Both factor the division through an
inverse that is exactly zero on all-zero (RMS) or constant (LayerNorm) rows:
the forward value is unchanged there, and the backward stays bounded instead
of scaling by ``1/eps`` on the zero pad rows the SSM stream carries.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ss = (xf * xf).sum(dim=-1, keepdim=True)
    nonzero = ss > 0
    rms = torch.where(nonzero, torch.sqrt(torch.where(nonzero, ss, torch.ones_like(ss))),
                      torch.zeros_like(ss)) * (x.shape[-1] ** -0.5)
    inv = torch.where(nonzero, 1.0 / (rms + eps), torch.zeros_like(rms))
    return (xf * inv * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.where(var > 0, torch.rsqrt(var + eps), torch.zeros_like(var))
    out = (xf - mean) * inv * weight.float() + bias.float()
    return out.to(x.dtype)
