"""The expert stacks that the MoE kernels read (``models/moe_fuse.py`` in JAX).

The all-expert combine ``sum_e combine[s, e] * (act(LN_e(x) @ W1_e + b1_e)
@ W2_e + b2_e)`` re-associates into two plain 2D products over the
flattened E*I hidden axis, ``(S, H) @ (H, E*I)`` and ``(S, E*I) @ (E*I, H)``,
once each expert's LayerNorm affine is folded into its W1:

    LN_e(x) @ W1_e = xhat @ (diag(ln_w_e) W1_e) + (ln_b_e @ W1_e)

with ``xhat`` the un-affine LayerNorm shared by every expert. Both fat
matrices are quantized per output channel (``quantize_weight``): W1t per
(expert, hidden column), W2t with ONE scale per output channel shared across
experts, because its contraction mixes experts. That is the documented
coarsening of the fat layout (moe_fuse.py:88-96). ``b2`` stays outside, as
``combine @ b2``. With ``bits=4`` (w4a8 serving) both fat matrices are
packed to int4 instead (``quantize_weight_int4``), where H and I are
multiples of 128; elsewhere the stack stays int8, as in the JAX package.

The per-expert stack of ``moe_mode="kernel"`` (:func:`fuse_one`, the JAX
engine's ``attach_fused_decode_params(mode="kernel")``) keeps the experts
apart: W1 with the LayerNorm affine folded in, requantized per (expert,
output channel), and the int8 W2 as it is (quantized here for a float tree).
"""

from __future__ import annotations

from typing import Dict

import torch

from apertis_llm_torch.models.quantize import (
    INT4_GROUP, quantize_weight, quantize_weight_int4)

Params = Dict[str, torch.Tensor]


def _dequant(experts: Params, key: str) -> torch.Tensor:
    if key + "_q" in experts:
        return experts[key + "_q"].float() * experts[key + "_s"].float()
    return experts[key].float()


def fuse_one(experts: Params) -> Params:
    """One layer's (E, ...) expert stack, float or int8, as the per-expert
    stack (``moe_fuse.py::_fuse_one``): ``w1f_q`` (E, H, I) int8 with
    ``w1f_s`` (E, 1, I), ``b1f`` (E, I) f32, ``w2f_q`` (E, I, H) int8 with
    ``w2f_s`` (E, 1, H). All arithmetic in f32."""
    ln_w, ln_b = experts["ln_w"].float(), experts["ln_b"].float()   # (E, H)
    w1 = _dequant(experts, "w1")                                    # (E, H, I)
    b1f = experts["b1"].float() + torch.einsum("eh,ehi->ei", ln_b, w1)
    q1, s1 = quantize_weight(ln_w[:, :, None] * w1)
    if "w2_q" in experts:
        q2, s2 = experts["w2_q"], experts["w2_s"].float()
    else:
        q2, s2 = quantize_weight(experts["w2"].float())
    return {"w1f_q": q1, "w1f_s": s1, "b1f": b1f, "w2f_q": q2, "w2f_s": s2}


def fuse_moe_decode_params(experts: Params) -> Params:
    """The per-expert stack of an expert stack with a leading layer axis,
    layer by layer (``fuse_moe_decode_params``)."""
    layers = [fuse_one({k: v[i] for k, v in experts.items()})
              for i in range(experts["ln_w"].shape[0])]
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}


def fat_bits(hidden: int, inter: int, bits: int) -> int:
    """The fat stack's width: int4 only where H and I are multiples of 128
    (``fuse_moe_decode_params_fat``, moe_fuse.py:136-142), else 8."""
    return 4 if bits == 4 and not (hidden % INT4_GROUP or inter % INT4_GROUP) else 8


def fuse_one_fat(experts: Params, bits: int = 8) -> Params:
    """One layer's (E, ...) expert stack, float or int8, as the fat stack:
    ``w1t_q`` (H, E*I) int8, ``w1t_s`` (1, E*I), ``b1t`` (E*I,) f32,
    ``w2t_q`` (E*I, H) int8, ``w2t_s`` (1, H); with ``bits=4`` where
    :func:`fat_bits` allows it, ``w1t_q4`` (H/2, E*I) and ``w2t_q4``
    (E*I/2, H) with their shifts ``w1t_sh``, ``w2t_sh`` in place of the int8
    matrices. All arithmetic in f32, as the JAX package does it."""
    ln_w, ln_b = experts["ln_w"].float(), experts["ln_b"].float()   # (E, H)
    e, h = ln_w.shape
    w1 = _dequant(experts, "w1")                                    # (E, H, I)
    w1f = ln_w[:, :, None] * w1
    b1f = experts["b1"].float() + torch.einsum("eh,ehi->ei", ln_b, w1)
    w1_flat = w1f.permute(1, 0, 2).reshape(h, -1)
    w2_flat = _dequant(experts, "w2").reshape(-1, h)
    if fat_bits(h, w1.shape[-1], bits) == 4:
        q1, s1, sh1 = quantize_weight_int4(w1_flat)
        q2, s2, sh2 = quantize_weight_int4(w2_flat)
        return {"w1t_q4": q1, "w1t_s": s1, "w1t_sh": sh1, "b1t": b1f.reshape(-1),
                "w2t_q4": q2, "w2t_s": s2, "w2t_sh": sh2}
    q1, s1 = quantize_weight(w1_flat)
    q2, s2 = quantize_weight(w2_flat)
    return {"w1t_q": q1, "w1t_s": s1, "b1t": b1f.reshape(-1), "w2t_q": q2, "w2t_s": s2}


def fuse_moe_decode_params_fat(experts: Params, bits: int = 8) -> Params:
    """The fat stack of an expert stack with a leading layer axis, layer by
    layer (``fuse_moe_decode_params_fat``)."""
    layers = [fuse_one_fat({k: v[i] for k, v in experts.items()}, bits)
              for i in range(experts["ln_w"].shape[0])]
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}
