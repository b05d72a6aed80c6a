"""Int8 weights for serving: the ``apertis_llm_tpu/models/quantize.py`` copy.

Symmetric per-output-channel int8 with the JAX package's formulas and skip
rules, on a tree of torch tensors on any device. ``quantize_params`` turns
each eligible linear's ``{"w"}`` into ``{"w_q": int8, "w_s": float32}``;
``models/convert.py::from_jax_params`` builds the int8 modules from such a
tree. Embeddings, norms, biases, ``dt_proj`` and the conv taps stay in their
own dtype. :func:`fuse_qkv` builds the fused QKV projection an int8 MHA
layer serves at decode. The int4 layouts are a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from apertis_llm_torch.ops.quant import divide

Params = Dict[str, Any]

# Linear-dict keys the quantizer may touch, with the ranks it accepts
# (stacked over layers adds one); the contraction axis is -2 in every case.
_QUANT_KEYS = {"w": (2, 3), "w1": (3, 4), "w2": (3, 4), "in_proj_w": (2, 3)}
# Parent names whose weights stay high-precision.
_SKIP_PARENTS = {"embed", "abs_pos", "final_norm", "pre_norm", "router",
                 "router_ln", "dt_proj", "conv", "lm_head"}
# Whole subtrees left untouched unless ``quantize_vision`` opts the ViT in.
_SKIP_SUBTREES = {"vision", "vision_proj", "cross_modal", "encoder"}
_VISION_SUBTREES = {"vision", "vision_proj"}


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8, ``w ~= w_q * w_s``: the scales
    reduce over the contraction axis (-2), so (in, out) weights get (1, out)
    scales. The arithmetic runs in ``w``'s dtype, as in JAX; ``torch.round``
    rounds half to even like ``jnp.round``."""
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = divide(torch.clamp(absmax, min=1e-8), 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_params(params: Params, min_size: int = 1 << 16,
                    quantize_vision: bool = False) -> Params:
    """Return a copy of the tree with eligible projection weights stored as
    ``{"w_q": int8, "w_s": float32}``. ``min_size`` skips small matrices;
    ``quantize_vision`` also quantizes the ViT encoder and projection."""

    def walk(tree, name):
        if not isinstance(tree, dict):
            return tree
        if name in _SKIP_SUBTREES and not (
                quantize_vision and name in _VISION_SUBTREES):
            return tree
        out = {}
        for key, value in tree.items():
            if (key in _QUANT_KEYS and isinstance(value, torch.Tensor)
                    and value.dim() in _QUANT_KEYS[key]
                    and value.numel() >= min_size
                    and value.is_floating_point()
                    and name not in _SKIP_PARENTS):
                out[key + "_q"], out[key + "_s"] = quantize_weight(value)
            elif isinstance(value, dict):
                out[key] = walk(value, key)
            else:
                out[key] = value
        return out

    return walk(params, "")


def tree_is_quantized(params: Params) -> bool:
    """True if any linear in the tree carries int8 serving weights."""
    if not isinstance(params, dict):
        return False
    if any(k.endswith("_q") for k in params):
        return True
    return any(tree_is_quantized(v) for v in params.values() if isinstance(v, dict))


def quantize_tied_head(params: Params) -> Params:
    """Attach ``lm_head = {"w_q": (H, V) int8, "w_s": (1, V)}``, an int8 copy
    of the tied LM head; the float embedding table stays for the lookups."""
    if "lm_head" in params or "embed" not in params:
        return params
    emb = params["embed"].get("tok")
    if emb is None or not emb.is_floating_point():
        return params
    q, s = quantize_weight(emb.T)
    out = dict(params)
    out["lm_head"] = {"w_q": q.contiguous(), "w_s": s}
    return out


def fuse_qkv(parts: Sequence[Params]) -> Optional[Params]:
    """The fused QKV projection of ``attach_qkv_mha`` (``models/quantize.py:
    220-247``): the int8 q, k, v linears ``{w_q, w_s, b?}`` concatenated along
    the output axis into ``{w_q (H, 3H), w_s (1, 3H), b (3H,)}``, so that a
    decode step runs one int8 product for all three. Returns None unless all
    three are int8 and either all or none has a bias: the JAX function drops
    the biases of a partial set, which would change the result."""
    if not all(p.get("w_q") is not None for p in parts):
        return None
    biases = [p.get("b") for p in parts]
    if any(b is None for b in biases) and any(b is not None for b in biases):
        return None
    fused = {"w_q": torch.cat([p["w_q"] for p in parts], dim=-1),
             "w_s": torch.cat([p["w_s"] for p in parts], dim=-1),
             "b": None if biases[0] is None else torch.cat(biases, dim=-1)}
    return fused
