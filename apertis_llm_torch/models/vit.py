"""The ViT image prefix: preprocessing and the vision encoder.

The counterpart of ``apertis_llm_tpu/models/vit.py`` (reference:
src/multimodal/module.py:10-119): the patch embedding as a reshape and a
linear in (c, dy, dx) order, not a convolution (vit.py:128-138); CLS and
learned position embeddings; ``vision_layers`` pre-norm transformer layers
with the math of ``torch.nn.TransformerEncoderLayer(norm_first=True)`` in
eval mode (LayerNorm eps 1e-5, packed q/k/v ``in_proj``, exact GELU, 4x
FFN; ``_vit_layer``, vit.py:101-119); the final LayerNorm (vit.py:182-184).
Attention is plain products and a softmax with f32 scores and the
probabilities cast to the value dtype, as the JAX package computes them
(vit.py:56-98), not ``scaled_dot_product_attention``, which rounds
elsewhere.

The int8 form (``quantize_params(quantize_vision=True)``): the linears are
``QuantLinear``s and ``in_proj`` its ``{in_proj_w_q, in_proj_w_s,
in_proj_b}``; where the mode fuses the pre-norms at the rows (``ops/quant.py::
fuses_pre_norm``) ``ln1`` and ``ln2`` run the fused norm + quantize
(``ops/kernels/ln_quant.py``) and feed ``in_proj`` and ``linear1`` their
int8 rows (``pre_q``), as ``_maybe_ln_quant`` does; the other linears
quantize their rows at run time. Elsewhere the plain norm runs, as in the
decoder.

TPU-only, not ported: the padding of the token axis from 197 to 200 with a
``-inf`` key bias (vit.py:144-156), which leaves the real tokens' outputs
unchanged; the L-first layout of the layer stack (vit.py:158-162); and
``APERTIS_VIT_UNROLL`` (vit.py:165-181), which only chooses how XLA
traces the same layers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.ops.activations import gelu
from apertis_llm_torch.ops.kernels.ln_quant import ln_quantize
from apertis_llm_torch.ops.norms import layer_norm
from apertis_llm_torch.ops.quant import fuses_pre_norm, linear_int8, linear_pre_q

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VIT_LN_EPS = 1e-5   # torch TransformerEncoderLayer's default


def preprocess_images(images: torch.Tensor, image_size: int) -> torch.Tensor:
    """Resize and ImageNet-normalise a batch of (B, H, W, 3) uint8 or float
    images in [0, 255] or [0, 1] (the batch's maximum above 1.5 means
    [0, 255]); returns channels-first (B, 3, S, S) float32 (vit.py:30-43).
    The resize is bilinear with antialiasing where an axis shrinks, as
    ``jax.image.resize`` does."""
    x = images.float()
    x = torch.where(x.max() > 1.5, x / 255.0, x)
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(image_size, image_size), mode="bilinear",
                      align_corners=False, antialias=True)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)[None, :, None, None]
    return (x - mean) / std


class VitLayer(nn.Module):
    """One pre-norm ViT layer (``vision/layers`` in JAX): ``ln1``, the packed
    ``in_proj_w`` / ``in_proj_b`` (``in_proj_w_q``, ``in_proj_w_s`` in
    int8), ``attn_out``, ``ln2``, ``linear1``, ``linear2``; with
    ``config.vision_heads`` heads unless ``heads`` names another count."""

    quant_matmul = "auto"    # set by ApertisForCausalLM.set_modes

    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool,
                 heads: Optional[int] = None):
        super().__init__()
        from apertis_llm_torch.models.apertis import Norm, _linear, _param

        dv = config.vision_embed_dim
        self.heads, self.quantized = heads or config.vision_heads, quantized
        self.ln1 = Norm(dv, False, VIT_LN_EPS, device, dtype)
        if quantized:
            self.in_proj_w_q = _param((dv, 3 * dv), device, torch.int8)
            self.in_proj_w_s = _param((1, 3 * dv), device, torch.float32)
        else:
            self.in_proj_w = _param((dv, 3 * dv), device, dtype)
        self.in_proj_b = _param((3 * dv,), device, dtype)
        self.attn_out = _linear(dv, dv, True, device, dtype, quantized)
        self.ln2 = Norm(dv, False, VIT_LN_EPS, device, dtype)
        self.linear1 = _linear(dv, 4 * dv, True, device, dtype, quantized)
        self.linear2 = _linear(4 * dv, dv, True, device, dtype, quantized)

    def _pre_norm(self, norm, x: torch.Tensor):
        """``(normed, None)``, or ``(None, (x_q, x_s))`` where the norm fuses
        with its consumer's row quantization (int8, where the mode fuses it
        at x's rows: ``fuses_pre_norm``)."""
        if self.quantized and fuses_pre_norm(self.quant_matmul, x.numel() // x.shape[-1]):
            return None, ln_quantize(x, norm.w, norm.b, VIT_LN_EPS)
        return norm(x), None

    def _attention(self, h: Optional[torch.Tensor], xq, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        if xq is not None:
            qkv = linear_pre_q(*xq, self.in_proj_w_q, self.in_proj_w_s, self.in_proj_b, x.dtype)
        elif self.quantized:
            qkv = linear_int8(h, self.in_proj_w_q, self.in_proj_w_s, self.in_proj_b,
                              self.quant_matmul)
        else:
            qkv = h @ self.in_proj_w + self.in_proj_b
        head_dim = d // self.heads
        q, k, v = (t.reshape(b, l, self.heads, head_dim) for t in qkv.split(d, dim=-1))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (head_dim ** -0.5)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)
        return self.attn_out(out.reshape(b, l, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, xq = self._pre_norm(self.ln1, x)
        x = x + self._attention(h, xq, x)
        h, xq = self._pre_norm(self.ln2, x)
        h = gelu(self.linear1.pre_q(*xq, x.dtype) if xq is not None else self.linear1(h))
        return x + self.linear2(h)


class VisionEncoder(nn.Module):
    """The ViT (``params["vision"]``): ``patch_embed``, ``cls_token``,
    ``pos_embed``, ``layers`` and ``final_ln``, in the model's dtype; the
    linears int8 with ``quantized``."""

    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool = False):
        super().__init__()
        from apertis_llm_torch.models.apertis import Norm, _linear, _param

        dv, p = config.vision_embed_dim, config.vision_patch_size
        self.patch, self.image_size = p, config.image_size
        patches = (config.image_size // p) ** 2
        self.patch_embed = _linear(3 * p * p, dv, True, device, dtype, quantized)
        self.cls_token = _param((1, 1, dv), device, dtype)
        self.pos_embed = _param((1, patches + 1, dv), device, dtype)
        self.layers = nn.ModuleList(VitLayer(config, device, dtype, quantized)
                                    for _ in range(config.vision_layers))
        self.final_ln = Norm(dv, False, VIT_LN_EPS, device, dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) pixels -> (B, patches + 1, vision_embed_dim)
        (``vit_encode``)."""
        b, p = pixel_values.shape[0], self.patch
        sp = self.image_size // p
        x = pixel_values.reshape(b, 3, sp, p, sp, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, sp * sp, 3 * p * p).to(self.cls_token.dtype)
        x = self.patch_embed(x)
        cls = self.cls_token.expand(b, 1, x.shape[-1]).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        return layer_norm(x, self.final_ln.w, self.final_ln.b, VIT_LN_EPS)
