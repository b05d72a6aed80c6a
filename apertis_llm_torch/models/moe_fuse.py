"""The int8 fat stack that both MoE kernels read (``models/moe_fuse.py`` in JAX).

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
``combine @ b2``. The int4 fat layout is a later slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from apertis_llm_torch.models.quantize import quantize_weight

Params = Dict[str, torch.Tensor]


def _dequant(experts: Params, key: str) -> torch.Tensor:
    if key + "_q" in experts:
        return experts[key + "_q"].float() * experts[key + "_s"].float()
    return experts[key].float()


def fuse_one_fat(experts: Params) -> Params:
    """One layer's (E, ...) expert stack, float or int8, as the fat stack:
    ``w1t_q`` (H, E*I) int8, ``w1t_s`` (1, E*I), ``b1t`` (E*I,) f32,
    ``w2t_q`` (E*I, H) int8, ``w2t_s`` (1, H). All arithmetic in f32, as the
    JAX package does it."""
    ln_w, ln_b = experts["ln_w"].float(), experts["ln_b"].float()   # (E, H)
    e, h = ln_w.shape
    w1 = _dequant(experts, "w1")                                    # (E, H, I)
    w1f = ln_w[:, :, None] * w1
    b1f = experts["b1"].float() + torch.einsum("eh,ehi->ei", ln_b, w1)
    q1, s1 = quantize_weight(w1f.permute(1, 0, 2).reshape(h, -1))
    q2, s2 = quantize_weight(_dequant(experts, "w2").reshape(-1, h))
    return {"w1t_q": q1, "w1t_s": s1, "b1t": b1f.reshape(-1), "w2t_q": q2, "w2t_s": s2}


def fuse_moe_decode_params_fat(experts: Params) -> Params:
    """The fat stack of an expert stack with a leading layer axis, layer by
    layer (``fuse_moe_decode_params_fat`` at 8 bits)."""
    layers = [fuse_one_fat({k: v[i] for k, v in experts.items()})
              for i in range(experts["ln_w"].shape[0])]
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}
