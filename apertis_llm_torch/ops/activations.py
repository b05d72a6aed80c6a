"""Activation functions with torch semantics: GELU is the exact erf form."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


_ACTIVATIONS = {
    "gelu": gelu,
    "relu": relu,
    "silu": silu,
    "swish": silu,
}


def get_activation(name: str):
    """Resolve an activation by name; unknown names fall back to GELU
    (reference: src/model/core.py:463-468)."""
    return _ACTIVATIONS.get(name, gelu)
