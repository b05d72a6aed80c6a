"""Int8 weights for serving: the ``apertis_llm_tpu/models/quantize.py`` copy.

Symmetric per-output-channel int8 with the JAX package's formulas and skip
rules, on a tree of torch tensors on any device. ``quantize_params`` turns
each eligible linear's ``{"w"}`` into ``{"w_q": int8, "w_s": float32}``;
``models/convert.py::from_jax_params`` builds the int8 modules from such a
tree. Embeddings, norms, biases, ``dt_proj`` and the conv taps stay in their
own dtype. :func:`fuse_qkv` builds the fused QKV projection an int8 MHA
layer serves at decode. The int4 layout (w4a8 serving, the JAX package's
``APERTIS_QUANT_BITS=4``) is a decode copy beside the int8 tree:
:func:`quantize_weight_int4` packs two 4-bit values a byte with a
power-of-two shift per (128-row group, output channel), :func:`unpack_int4`
inverts it, and :func:`attach_int4_ffn` attaches the dense FFN's pack.
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


INT4_GROUP = 128  # contraction rows per packing group


def quantize_weight_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4, ``w ~= unpack_int4(w_q4, w_sh) * w_s``
    (``quantize.py::quantize_weight_int4``). Per output channel the base
    scale is ``max(channel absmax, 1e-8) / 56``; each (128-row group,
    channel) takes the smallest shift ``2^e`` (e in 0..3) with ``7 * scale *
    2^e >= group absmax``, ``e = clip(ceil(log2(max(gmax / (7 scale), 1))),
    0, 3)`` in f32 in the JAX order, and values ``clip(rint(w / (scale *
    2^e)), -7, 7)``. Two values pack into one byte within each group: byte
    row ``64 g + j`` (j < 64) holds contraction row ``128 g + j`` in its low
    nibble and ``128 g + j + 64`` in its high nibble. Returns ``(w_q4
    (..., K/2, N) int8, w_s (..., 1, N) f32, w_sh (..., K/128, N) int8)``;
    the contraction axis (-2) must be a multiple of 128."""
    k = w.shape[-2]
    if k % INT4_GROUP:
        raise ValueError(f"int4 contraction axis must be a multiple of {INT4_GROUP}, got {k}")
    lead, n = tuple(w.shape[:-2]), w.shape[-1]
    wg = w.float().reshape(*lead, k // INT4_GROUP, INT4_GROUP, n)
    gmax = wg.abs().amax(dim=-2)                                  # lead + (G, n)
    cmax = gmax.amax(dim=-2, keepdim=True)                        # lead + (1, n)
    scale = divide(torch.clamp(cmax, min=1e-8), 56.0)
    e = torch.clamp(torch.ceil(torch.log2(torch.clamp(gmax / (7.0 * scale), min=1.0))), 0, 3)
    shift = torch.exp2(e)                                         # lead + (G, n) f32
    grid = scale[..., None, :, :] * shift[..., None, :]           # lead + (G, 1, n)
    q = torch.clamp(torch.round(wg / grid), -7, 7).to(torch.int32)
    q = q.reshape(*lead, k // INT4_GROUP, 2, INT4_GROUP // 2, n)
    packed = ((q[..., 0, :, :] & 0xF) | (q[..., 1, :, :] << 4)).to(torch.int8)
    return packed.reshape(*lead, k // 2, n), scale, shift.to(torch.int8)


def unpack_int4(packed: torch.Tensor, shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Invert :func:`quantize_weight_int4`'s packing: (..., K/2, N) bytes ->
    (..., K, N) int8 values in [-7, 7], or times the per-(group, channel)
    ``shifts`` in [-56, 56]. The low nibble is sign-extended by
    ``(p << 28) >> 28`` of the int32 byte, the high one by ``p >> 4``."""
    lead, (kh, n) = tuple(packed.shape[:-2]), packed.shape[-2:]
    p = packed.to(torch.int32)
    half = INT4_GROUP // 2
    lo = ((p << 28) >> 28).reshape(*lead, kh // half, 1, half, n)
    hi = (p >> 4).reshape(*lead, kh // half, 1, half, n)
    full = torch.cat([lo, hi], dim=-3)
    if shifts is not None:
        full = full * shifts.to(torch.int32).reshape(*lead, kh // half, 1, 1, n)
    return full.to(torch.int8).reshape(*lead, 2 * kh, n)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    shifts: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The full (in, out) weight of an int4 pack."""
    return unpack_int4(packed, shifts).to(dtype) * scale.to(dtype)


def int4_ffn_pack(w1: Params, w2: Params) -> Optional[Params]:
    """The int4 decode pack of one dense FFN, ``{"w1": {w_q4, w_s, w_sh, b},
    "w2": ...}``, requantized from the int8 ``{w_q, w_s, b}`` linears
    (``w_q * w_s`` in f32 onto the 4-bit grid; stacked or not), or None
    where the JAX package attaches none: a linear that is not int8 with a
    bias, or a contraction that is not a multiple of 128."""
    if not all(isinstance(w, dict) and w.get("w_q") is not None and w.get("b") is not None
               for w in (w1, w2)):
        return None
    if w1["w_q"].shape[-2] % INT4_GROUP or w2["w_q"].shape[-2] % INT4_GROUP:
        return None
    pack = {}
    for name, w in (("w1", w1), ("w2", w2)):
        q4, s, sh = quantize_weight_int4(w["w_q"].float() * w["w_s"])
        pack[name] = {"w_q4": q4, "w_s": s, "w_sh": sh, "b": w["b"]}
    return pack


def attach_int4_ffn(params: Params) -> Params:
    """Attach the dense FFN's int4 decode pack under ``layers.ffn["w4"]``
    beside the int8 tree (``quantize.py::attach_int4_ffn``); prefill keeps
    reading int8. A no-op where the JAX function is one: no dense FFN, a
    pack already attached, or :func:`int4_ffn_pack` gives none."""
    ffn = params.get("layers", {}).get("ffn")
    if not isinstance(ffn, dict) or "w4" in ffn:
        return params
    pack = int4_ffn_pack(ffn.get("w1"), ffn.get("w2"))
    if pack is None:
        return params
    out = dict(params)
    out["layers"] = dict(params["layers"])
    out["layers"]["ffn"] = dict(ffn, w4=pack)
    return out


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
