"""Parameter initialisation, as a tree of tensors named like the JAX package's.

``init_params`` builds the same nested dict of names and shapes as
``apertis_llm_tpu/models/params.py::init_params`` for the text-only model:
per-layer tensors stacked along a leading ``num_hidden_layers`` axis, linear
weights in the (in, out) layout, and the same distributions
(reference: src/model/core.py:1045-1062, 314-318): normal(0,
initializer_range) for linears and embeddings, zero biases, unit norm
scales, dt bias ~ U(log 1e-3, log 1e-2), A_log ~ U(log 0.5, log 0.99), D = 1,
conv taps ~ U(+-1/sqrt(K)). The numbers differ from JAX's, which draws from
its own generator. ``models/convert.py::from_jax_params`` turns the tree into
the model's modules.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from apertis_llm_torch.config import ApertisConfig

Params = Dict[str, Any]


def check_supported(config: ApertisConfig) -> None:
    """Raise unless ``config`` is the variant ported so far: the text-only
    selective-SSM decoder with a dense FFN, rotary (unused) positions and a
    tied LM head. The MHA, MoE, SwiGLU, multimodal and absolute-position
    variants are later slices of the port (ROADMAP.md)."""
    missing = []
    if config.attention_type != "selective_ssm":
        missing.append(f"attention_type={config.attention_type!r}")
    if config.use_swiglu:
        missing.append("use_swiglu")
    if config.use_expert_system and config.num_experts > 0:
        missing.append("use_expert_system")
    if config.multimodal:
        missing.append("multimodal")
    if config.position_embedding_type == "absolute":
        missing.append("absolute position embeddings")
    if not config.tie_word_embeddings:
        missing.append("an untied LM head")
    if missing:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(missing) + " (see ROADMAP.md)")


class _Init:
    """Draws every tensor from one generator on one device in one dtype."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, torch.device(device), dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.device,
                           dtype=self.dtype) * std

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.g, device=self.device, dtype=self.dtype)
        return u * (hi - lo) + lo

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def linear(self, lead, fan_in: int, fan_out: int, std: float, bias: bool) -> Params:
        p = {"w": self.normal((*lead, fan_in, fan_out), std)}
        if bias:
            p["b"] = self.full((*lead, fan_out), 0.0)
        return p

    def norm(self, lead, dim: int, rms: bool) -> Params:
        if rms:
            return {"scale": self.full((*lead, dim), 1.0)}
        return {"w": self.full((*lead, dim), 1.0), "b": self.full((*lead, dim), 0.0)}


def init_params(config: ApertisConfig, generator: torch.Generator,
                device="cpu", dtype: torch.dtype = torch.float32) -> Params:
    """Initialise the model variant this package serves (see
    :func:`check_supported`); other variants raise ``NotImplementedError``."""
    check_supported(config)
    init = _Init(generator, device, dtype)
    nl = (config.num_hidden_layers,)
    h, std = config.hidden_size, config.initializer_range
    c, heads, n = config.ssm_d_inner, config.num_attention_heads, config.ssm_d_state
    r, k = config.ssm_dt_rank, config.ssm_conv_kernel
    rms = config.use_rmsnorm

    embed = init.normal((config.vocab_size, h), std)
    embed[config.pad_token_id] = 0.0
    params: Params = {"embed": {"tok": embed}}

    conv_bound = 1.0 / math.sqrt(k)
    attn = {
        "pre_norm": init.norm(nl, h, rms),
        "in_proj_x": init.linear(nl, h, c, std, bias=False),
        "in_proj_z": init.linear(nl, h, c, std, bias=False),
        "conv": {"w": init.uniform((*nl, c, k), -conv_bound, conv_bound),
                 "b": init.uniform((*nl, c), -conv_bound, conv_bound)},
        "x_param_proj": init.linear(nl, c, r + 2 * heads * n, std, bias=False),
        "dt_proj": {"w": init.normal((*nl, r, heads), std),
                    "b": init.uniform((*nl, heads), math.log(1e-3), math.log(1e-2))},
        "A_log": init.uniform((*nl, heads, n), math.log(0.5), math.log(0.99)),
        "D": init.full((*nl, c), 1.0),
        "out_proj": init.linear(nl, c, h, std, bias=False),
    }
    inter = config.intermediate_size
    ffn = {
        "pre_norm": init.norm(nl, h, rms),
        "w1": init.linear(nl, h, inter, std, bias=True),
        "w2": init.linear(nl, inter, h, std, bias=True),
    }
    params["layers"] = {"attn": attn, "ffn": ffn}
    params["final_norm"] = init.norm((), h, rms)
    return params


def count_params(params: Params) -> int:
    total = 0
    for v in params.values():
        total += count_params(v) if isinstance(v, dict) else v.numel()
    return total
