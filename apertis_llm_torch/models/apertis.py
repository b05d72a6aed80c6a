"""Apertis decoder-only LM in PyTorch: the selective-SSM and MHA models, each
also with the ViT image prefix.

The counterpart of ``apertis_llm_tpu/models/apertis.py`` for the variants
ported so far (``models/params.py::check_supported``): pre-norm residual
Mamba-style selective mixer or standard MHA (full-width interleaved RoPE, or
absolute positions added to the embeddings), pre-norm residual dense, SwiGLU
or top-k MoE FFN beside either mixer, final post-norm, tied or untied LM
head. Module and parameter names follow the JAX parameter
tree, so ``layers.3.attn.in_proj_x.w`` is layer 3 of
``layers/attn/in_proj_x/w``, and linear weights keep the (in, out) layout.

Three paths, with the JAX package's semantics:
  * ``forward``: full-sequence logits; like the reference, the SSM mixer
    ignores the attention mask here (apertis.py:393-398, 772); MHA honours
    it, and without one runs the causal flash kernel (bf16 or f32) where the
    gate holds. With ``labels`` it is the training forward
    (apertis.py:772-874): the shifted cross-entropy plus a MoE model's
    load-balancing and router z-losses, dropout, routing noise and expert
    dropout at the JAX package's places, drawn from a ``(step seed, layer)``
    pair, the MoE FFN's training dispatch, and per-layer
    rematerialisation when ``config.remat`` and ``training``. The float
    parameters are trainable; the scan and the flash attention run as
    ``torch.autograd.Function``s whose backward is a kernel too.
  * ``prefill``: masked full-sequence pass that fills the decode cache: the
    SSM's ``{conv, ssm}`` (padded steps are identity transitions and each
    row's conv window is gathered at its true length), or MHA's flat K/V
    cache (plain attention under the causal x padding bias).
  * ``decode_step``: one token per row through the fused mixer step, or the
    MHA decode-attention kernel over the flat cache (its plain version at
    head widths the kernel does not take, as the JAX package serves them
    through XLA), and the fused decode FFN (``ops/kernels``), whose
    semantics are those of the JAX package's
    fused-kernel decode path (for MHA, ``APERTIS_MHA_STEP=force`` with the
    default ``APERTIS_MHA_LNQ=xla`` and ``APERTIS_MHA_QKV=1``). Where the
    fused FFN's width test fails (``ffn_fused.py::fused_eligible``: a hidden
    size that is not a multiple of 128, or an intermediate size with no
    128-multiple tile), the mixer step runs without its FFN epilogue and the
    FFN runs as the JAX package's ``_ffn`` does then: the plain pre-norm and
    the two linears (w8a8 in int8).

The MoE FFN computes in the tree's dtype until a serving stack is attached,
as the JAX package's ``forward`` and ``prefill`` do on a raw tree: up to
``max(E, moe_dense_threshold_tokens)`` tokens ``moe_dense``, above it
``moe_ragged``, and in training with the capacity limit ``moe_dispatch``.
``InferenceEngine`` attaches a stack by ``moe_mode``
(:meth:`ApertisForCausalLM.set_modes`), as the JAX engine's
``attach_fused_decode_params`` does. ``fatk`` (the default) is the JAX
package's arithmetic under ``APERTIS_MOE_GROUPED=force``,
``APERTIS_SSM_STEP=force`` and ``APERTIS_MOE_FUSED=fatk``: both of its
kernels read the int8 fat stack of ``models/moe_fuse.py`` (in a bf16 model
too, :meth:`ApertisForCausalLM.attach_moe_fat`), a derived buffer of each
MoE layer. Over full sequences the FFN runs the combine-folded fat kernel up
to that token count and the grouped kernel above it; at decode the mixer
step's moe epilogue emits the expert input and the top-2 combine weights,
and the fat kernel follows. ``kernel`` (``APERTIS_MOE_FUSED=kernel``) reads
the per-expert stack instead (:meth:`ApertisForCausalLM.attach_moe_fused`):
up to that token count the per-expert kernel (``ops/moe.py::
moe_dense_fused``), above it ``moe_ragged``. ``fat``
(``APERTIS_MOE_FUSED=fat``) reads the fat stack with its two products in
plain torch up to that token count (``ops/moe.py::moe_dense_fat``), and
the grouped kernel above it. ``0`` attaches and reads no stack. Without a
fat stack under ``fatk``, or with a top-k other than 2, the decode step
runs the mixer step without its epilogue and the FFN as over full
sequences (apertis.py:1224-1230); an MHA model's decode step always runs
its MoE FFN so, after the attention (apertis.py:1380-1385).

w4a8 serving (the JAX package's ``APERTIS_QUANT_BITS=4``, the engine's
``quant_bits=4``) keeps the int8 tree for prefill and attaches int4 decode
copies: a dense FFN's pack (:meth:`ApertisForCausalLM.attach_int4_ffn`),
which the decode FFN kernel's int4 layout reads, and a MoE model's int4 fat
stack where H and I are multiples of 128, which the fat kernel's int4 layout
reads; above the fat kernel's token count an int4 fat stack's layer runs
``moe_ragged`` over the int8 experts, since the grouped kernel takes int8
stacks only (``moe_grouped.py::grouped_eligible``).

With int8 weights (``quantized``: the four mixer projections and the FFN's
linears are ``QuantLinear``, a MoE FFN's expert stacks int8 tensors) the
model computes by default (``quant_matmul="auto"``, the JAX package's
default) each int8 linear by the card's measured rule: the weight-only
kernel on rows not quantized already (``ops/quant.py::resolve_mode``), and
a pre-norm fused with its consumers' row quantization from a row count
(``fuses_pre_norm``). Under ``quant_matmul="dyn"`` it
computes what the JAX package computes under ``APERTIS_QUANT_MATMUL=dyn``,
``APERTIS_LN_QUANT=force``, ``APERTIS_SSM_STEP=force`` and
``APERTIS_FFN_FUSED=force``, at every row count: each pre-norm that feeds
int8 projections is fused with their row
quantization (``ln_quantize``), the other int8 projections quantize their
input rows at run time (w8a8), ``dt_proj`` stays float, and the decode step
and FFN run their int8 layouts. An MHA layer's pre-norm is always the plain
norm; its decode step quantizes the normed rows and the attention context
with ``quantize_rows`` and serves q/k/v through the fused QKV product when
one is attached. An attached int8 tied head
(:meth:`ApertisForCausalLM.quantize_tied_head`) serves the logits the same
way. The other ``quant_matmul`` modes, the JAX package's values of
``APERTIS_QUANT_MATMUL``, change every int8 linear that runs on rows not
quantized already (``ops/quant.py::linear_int8``): the full-sequence
projections, the int8 head, the unfused decode FFN and ``moe_ragged``'s
experts (dequantized outside ``dyn``); and, as ``_maybe_ln_quant`` does,
outside ``dyn`` the pre-norms take the plain norm and no ``ln_quantize``.
The decode projections that take rows quantized already (MHA's q/k/v/o,
``pre_q``) and the decode kernels stay as they are in every mode.

A multimodal model (``config.multimodal``, either mixer) puts the ViT's
tokens (``models/vit.py``; ``vision_proj`` to the hidden width where the
widths differ) before the token embeddings when ``pixel_values`` is given
(``assemble_inputs``, apertis.py:704-745): raw (B, H, W, 3) or uint8 images
are preprocessed first, and a given attention mask grows by ones over the
prefix, so the SSM's ``seq_lens`` count it. The prefix takes positions
0..num_img - 1 and the text num_img on (RoPE for MHA). ``forward`` returns
the text positions' logits, ``prefill`` takes ``logit_positions`` as text
positions; an MHA cache holds the prefix's K/V in its first slots, an SSM
decode reads only its state. In training the ViT and ``vision_proj`` of a
float tree take gradients through their plain torch ops (no dropout, no
remat: JAX remats the decoder's layers only). The ViT's linears are int8 or
float as its tree is (``vision_quantized``), independently of the
decoder's.

The hand-written kernels run on CUDA tensors; on CPU tensors their plain
PyTorch versions run. Under ``dyn`` every int8 linear (``QuantLinear``, the
fused QKV, the int8 head, ``moe_ragged``'s groups) runs the w8a8 kernel
(``ops/kernels/quant_matmul.py``), under ``pallas`` and ``fused`` the
weight-only and the block-quantizing kernels of the same module; plain torch
(``torch.matmul``) does the float projections, the float prefill FFN, the
tied float head and the ``weightonly`` products, which the JAX package
leaves to XLA outside its kernels.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.moe_fuse import fuse_one, fuse_one_fat
from apertis_llm_torch.models.params import (
    check_serving_modes, check_supported, is_mha, is_moe, resolve_device)
from apertis_llm_torch.models.quantize import fuse_qkv, int4_ffn_pack, quantize_weight
from apertis_llm_torch.models.vit import VisionEncoder, VitLayer, preprocess_images
from apertis_llm_torch.ops import attention as attn_ops
from apertis_llm_torch.ops import moe as moe_ops
from apertis_llm_torch.ops import ssm as ssm_ops
from apertis_llm_torch.ops.activations import get_activation, silu
from apertis_llm_torch.ops.kernels.ffn_fused import (
    ffn_decode, ffn_decode_int4, ffn_decode_int8, pick_block_n)
from apertis_llm_torch.ops.kernels.flash_attention import FlashAttention
from apertis_llm_torch.ops.kernels.ln_quant import ln_quantize
from apertis_llm_torch.ops.kernels.mha_step import (
    NEG, kernel_takes, mha_decode_ctx, mha_decode_ctx_int8, mha_decode_ctx_reference,
    quantize_heads)
from apertis_llm_torch.ops.kernels.ssm_step import MixerWeights, RouterWeights, ssm_decode_step
from apertis_llm_torch.ops.norms import layer_norm, rms_norm
from apertis_llm_torch.ops.quant import fuses_pre_norm, linear_int8, linear_pre_q, quantize_rows
from apertis_llm_torch.ops.rope import apply_rope, rope_tables, rotate
from apertis_llm_torch.parallel.context import ParallelContext
from apertis_llm_torch.parallel.context import current as parallel_current
from apertis_llm_torch.parallel.sequence import previous_rows, ssm_scan_sequence_parallel

Cache = Dict[str, torch.Tensor]


class PrefillOutput(NamedTuple):
    logits: torch.Tensor     # (B, L, V), or (B, 1, V) with logit_positions
    cache: Cache
    length: int              # tokens written to the cache


class LMOutput(NamedTuple):
    """The training forward's result (``apertis.py::LMOutput`` without the
    attention and hidden-state outputs)."""
    loss: torch.Tensor       # () f32 shifted cross-entropy (+ the MoE losses)
    logits: torch.Tensor     # (B, L, V)
    lb_loss: torch.Tensor    # () f32; zero for a dense FFN
    rz_loss: torch.Tensor    # () f32; zero for a dense FFN


def _param(shape, device, dtype) -> nn.Parameter:
    # Float parameters are trainable; an int8 model turns them off again.
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=dtype.is_floating_point)


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              ignore_index: int = -100) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(nll, valid)``: each position's cross-entropy in f32 of ``logits``
    (B, L, V) against ``targets`` (B, L), the token each position predicts,
    0 where the target is ``ignore_index``, and the mask of valid targets."""
    targets = targets.long()
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Shifted next-token cross-entropy in f32, averaged over the labels that
    are not ``ignore_index`` (at least one) (``apertis.py::
    cross_entropy_loss``)."""
    nll, valid = token_nll(logits[:, :-1, :], labels[:, 1:], ignore_index)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def fold_seed(seed: int, index: int) -> int:
    """A 63-bit seed for stream ``index`` of step seed ``seed`` (splitmix64's
    finaliser): the counterpart of ``jax.random.fold_in``."""
    z = (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & (2 ** 63 - 1)


class Dropout:
    """The JAX package's ``_dropout`` (apertis.py:247-251): keep each element
    with probability ``1 - rate`` and scale it by ``1 / (1 - rate)``, in the
    input's dtype. The masks come from a generator made here from a fixed
    seed, not from the default generator, so a rematerialised layer
    (``torch.utils.checkpoint``) that makes a new one from the same seed
    draws the same masks again; successive calls draw successive masks."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=x.device) < (1.0 - rate)
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Linear(nn.Module):
    """``x @ w (+ b)`` with ``w`` in the (in, out) layout."""

    def __init__(self, fan_in: int, fan_out: int, bias: bool, device, dtype):
        super().__init__()
        self.w = _param((fan_in, fan_out), device, dtype)
        self.b = _param((fan_out,), device, dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y + self.b if self.b is not None else y


class QuantLinear(nn.Module):
    """The int8 linear: ``w_q`` int8 (in, out), ``w_s`` f32 (1, out), the
    JAX tree's ``{w_q, w_s, b}``. ``forward`` computes the linear of its
    ``quant_matmul`` mode (``ops/quant.py::linear_int8``; ``dyn`` quantizes
    the input rows at run time); ``pre_q`` takes rows quantized already,
    through the w8a8 kernel in every mode. The kernels read the row-major
    ``w_q`` as it is."""

    quant_matmul = "auto"    # set by ApertisForCausalLM.set_modes

    def __init__(self, fan_in: int, fan_out: int, bias: bool, device, dtype):
        super().__init__()
        self.w_q = _param((fan_in, fan_out), device, torch.int8)
        self.w_s = _param((1, fan_out), device, torch.float32)
        self.b = _param((fan_out,), device, dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_int8(x, self.w_q, self.w_s, self.b, self.quant_matmul)

    def pre_q(self, x_q: torch.Tensor, x_s: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
        return linear_pre_q(x_q, x_s, self.w_q, self.w_s, self.b, out_dtype)


def _linear(fan_in: int, fan_out: int, bias: bool, device, dtype, quantized: bool):
    return (QuantLinear if quantized else Linear)(fan_in, fan_out, bias, device, dtype)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``w``, ``b``), ops/norms.py."""

    def __init__(self, dim: int, rms: bool, eps: float, device, dtype):
        super().__init__()
        self.eps = eps
        if rms:
            self.scale = _param((dim,), device, dtype)
        else:
            self.w = _param((dim,), device, dtype)
            self.b = _param((dim,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "scale"):
            return rms_norm(x, self.scale, self.eps)
        return layer_norm(x, self.w, self.b, self.eps)

    def weights(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(weight, bias); bias is None for RMSNorm."""
        if hasattr(self, "scale"):
            return self.scale, None
        return self.w, self.b


class DepthwiseConv(nn.Module):
    """Per-channel causal conv taps ``w`` (C, K) and bias ``b`` (C,)."""

    def __init__(self, channels: int, k: int, device, dtype):
        super().__init__()
        self.w = _param((channels, k), device, dtype)
        self.b = _param((channels,), device, dtype)


class SelectiveSSM(nn.Module):
    """The selective mixer with its pre-norm (``layers/attn`` in JAX)."""

    quant_matmul = "auto"    # set by ApertisForCausalLM.set_modes

    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool = False):
        super().__init__()
        h, c = config.hidden_size, config.ssm_d_inner
        heads, n = config.num_attention_heads, config.ssm_d_state
        r, k = config.ssm_dt_rank, config.ssm_conv_kernel
        self.heads, self.d_state, self.dt_rank, self.k = heads, n, r, k
        self.quantized = quantized
        self.pre_norm = Norm(h, config.use_rmsnorm, config.layer_norm_eps, device, dtype)
        self.in_proj_x = _linear(h, c, False, device, dtype, quantized)
        self.in_proj_z = _linear(h, c, False, device, dtype, quantized)
        self.conv = DepthwiseConv(c, k, device, dtype)
        self.x_param_proj = _linear(c, r + 2 * heads * n, False, device, dtype, quantized)
        self.dt_proj = Linear(r, heads, True, device, dtype)      # float in both layouts
        self.A_log = _param((heads, n), device, dtype)
        self.D = _param((c,), device, dtype)
        self.out_proj = _linear(c, h, False, device, dtype, quantized)

    def forward(self, h: torch.Tensor, *, seq_mask: Optional[torch.Tensor] = None,
                seq_lens: Optional[torch.Tensor] = None, want_cache: bool = False,
                drop: Optional[Dropout] = None, sp: Optional[ParallelContext] = None):
        """Pre-norm and mixer over a full sequence h (B, L, D)
        (``apertis.py::_layer_full``'s SSM branch and ``_ssm_full``). Returns
        ``(out, cache)``; with ``seq_mask`` padded steps are identity
        transitions and the conv window is gathered at ``seq_lens``. The
        mixer has no dropout of its own: ``drop`` is not read. With ``sp``,
        an active sequence-parallel context, ``h`` is this rank's chunk of
        the sequence and the mixer takes :meth:`_sequence_parallel`."""
        if sp is not None:
            return self._sequence_parallel(h, seq_mask, sp), None
        b, l, _ = h.shape
        heads, n, r, k = self.heads, self.d_state, self.dt_rank, self.k
        if self.quantized and fuses_pre_norm(self.quant_matmul, b * l):
            # One fused norm + row quantization feeds both in-projections
            # (_maybe_ln_quant: where the linears run dyn).
            x_q, x_s = ln_quantize(h, *self.pre_norm.weights(), self.pre_norm.eps)
            x_proj = self.in_proj_x.pre_q(x_q, x_s, h.dtype)       # (B, L, C)
            z = self.in_proj_z.pre_q(x_q, x_s, h.dtype)
        else:
            x = self.pre_norm(h)
            x_proj = self.in_proj_x(x)
            z = self.in_proj_z(x)
        x_act = silu(ssm_ops.depthwise_causal_conv(x_proj, self.conv.w, self.conv.b))
        raw = self.x_param_proj(x_act)
        delta = torch.nn.functional.softplus(self.dt_proj(raw[..., :r]).float())
        a_cont = -torch.exp(self.A_log.float())
        y, h_last = ssm_ops.ssm_mix(
            delta, a_cont, raw[..., r:r + heads * n].reshape(b, l, heads, n),
            raw[..., r + heads * n:].reshape(b, l, heads, n),
            seq_mask=seq_mask, out_dtype=h.dtype)
        y = y + self.D * x_act
        out = self.out_proj(y * silu(z))
        if not want_cache:
            return out, None
        # The conv window carries the last K-1 pre-conv inputs.
        pad = torch.nn.functional.pad(x_proj, (0, 0, k - 1, 0))   # (B, L+K-1, C)
        if k <= 1:
            conv_state = x_proj.new_zeros((b, 0, x_proj.shape[-1]))
        elif seq_lens is None:
            conv_state = pad[:, -(k - 1):, :]
        else:
            # Rows [len, len+K-2] of the padded input are positions
            # [len-K+1, len-1]: the window ending at the last real token.
            idx = seq_lens.long()[:, None] + torch.arange(k - 1, device=h.device)[None, :]
            conv_state = torch.gather(
                pad, 1, idx[:, :, None].expand(b, k - 1, pad.shape[-1]))
        return out, {"conv": conv_state, "ssm": h_last}

    def _sequence_parallel(self, h: torch.Tensor, seq_mask: Optional[torch.Tensor],
                           sp: ParallelContext) -> torch.Tensor:
        """The mixer on this rank's chunk as the JAX package routes it under
        sequence parallelism (apertis.py:415-433), in its order of casts:
        ``a_bar = exp(delta * A)``, ``b_term`` (cast to ``a_bar``'s f32) and
        ``c_mod`` in the (B, H, L, N) layout, masked steps made identity
        transitions, the chunk-composed scan, then ``y = c_mod * h`` in f32
        cast to the compute dtype. The conv reads the previous chunk's last
        K-1 pre-conv rows (the halo GSPMD exchanges in JAX)."""
        b, l, _ = h.shape
        heads, n, r, k = self.heads, self.d_state, self.dt_rank, self.k
        x = self.pre_norm(h)
        x_proj = self.in_proj_x(x)
        z = self.in_proj_z(x)
        halo = previous_rows(x_proj, k - 1, sp.mesh, sp.sp_axis) if k > 1 else None
        x_act = silu(ssm_ops.depthwise_causal_conv(x_proj, self.conv.w, self.conv.b, halo))
        raw = self.x_param_proj(x_act)
        delta = torch.nn.functional.softplus(self.dt_proj(raw[..., :r]).float())
        a_bar = torch.exp(delta[..., None] * -torch.exp(self.A_log.float()))   # (B, L, H, N)
        a_bar = a_bar.transpose(1, 2)                                          # (B, H, L, N)
        b_term = raw[..., r:r + heads * n].reshape(b, l, heads, n).transpose(1, 2)
        b_term = b_term.to(a_bar.dtype)
        c_mod = raw[..., r + heads * n:].reshape(b, l, heads, n).transpose(1, 2)
        if seq_mask is not None:
            m = seq_mask[:, None, :, None].to(a_bar.dtype)
            a_bar = a_bar * m + (1.0 - m)   # identity transition on pads
            b_term = b_term * m
        hs, _ = ssm_scan_sequence_parallel(a_bar.contiguous(), b_term.contiguous(), sp.mesh,
                                           sp.sp_axis)
        y = (c_mod.to(hs.dtype) * hs).to(h.dtype)                            # (B, H, L, N)
        y = y.transpose(1, 2).reshape(b, l, heads * n)
        y = y + self.D * x_act
        return self.out_proj(y * silu(z))

    def mixer_weights(self) -> MixerWeights:
        norm_w, norm_b = self.pre_norm.weights()
        if not self.quantized:
            return MixerWeights(
                norm_w, norm_b, self.in_proj_x.w, self.in_proj_z.w, self.conv.w,
                self.conv.b, self.x_param_proj.w, self.dt_proj.w, self.dt_proj.b,
                self.A_log, self.D, self.out_proj.w)
        return MixerWeights(
            norm_w, norm_b, self.in_proj_x.w_q, self.in_proj_z.w_q, self.conv.w,
            self.conv.b, self.x_param_proj.w_q, self.dt_proj.w, self.dt_proj.b,
            self.A_log, self.D, self.out_proj.w_q, self.in_proj_x.w_s,
            self.in_proj_z.w_s, self.x_param_proj.w_s, self.out_proj.w_s)


def flash_eligible(config: ApertisConfig, seq_len: int) -> bool:
    """The JAX package's gate for the flash kernel (``apertis.py::
    _flash_eligible``) without its TPU clause: enabled, at least 128
    positions, and a head width that is a multiple of 8 up to 256. The
    kernels take bf16 and f32 q/k/v on the card (``FlashAttention`` picks
    them by dtype), and their plain versions either on the CPU. The caller
    also requires that there is no attention mask."""
    head_dim = config.head_dim
    return (config.use_flash_attention and seq_len >= 128 and head_dim % 8 == 0
            and head_dim <= 256)


_QKV_NAMES = ("qkv_w_q", "qkv_w_s", "qkv_b")


class MultiHeadAttention(nn.Module):
    """Standard MHA with its pre-norm (``layers/attn`` of an MHA tree):
    ``pre_norm`` and the (H, H) linears ``q``, ``k``, ``v``, ``o``, with
    biases when ``config.qkv_bias``; ``QuantLinear`` in the int8 layout. An
    int8 layer can also hold the fused QKV projection (:meth:`attach_qkv`)
    in non-persistent buffers. With rotary positions RoPE rotates q and k
    over the full width before the heads are split; with absolute ones the
    positions are in the embeddings and nothing rotates (``apertis.py::
    _mha_full``)."""

    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool = False):
        super().__init__()
        h = config.hidden_size
        self.heads, self.head_dim = config.num_attention_heads, config.head_dim
        self.rotary = config.position_embedding_type == "rotary"
        self.attn_dropout = config.attention_probs_dropout_prob
        self.quantized = quantized
        self.pre_norm = Norm(h, config.use_rmsnorm, config.layer_norm_eps, device, dtype)
        self.q = _linear(h, h, config.qkv_bias, device, dtype, quantized)
        self.k = _linear(h, h, config.qkv_bias, device, dtype, quantized)
        self.v = _linear(h, h, config.qkv_bias, device, dtype, quantized)
        self.o = _linear(h, h, config.qkv_bias, device, dtype, quantized)
        for name in _QKV_NAMES:
            self.register_buffer(name, None, persistent=False)
        self._qkv_key = None     # the q/k/v tensors the fused pack was built from

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        b, l, _ = t.shape
        return t.reshape(b, l, self.heads, self.head_dim).transpose(1, 2).contiguous()

    def forward(self, h: torch.Tensor, *, bias: Optional[torch.Tensor], pos_ids: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]], flash: bool,
                want_cache: bool = False, drop: Optional[Dropout] = None):
        """Pre-norm and attention over a full sequence h (B, L, D)
        (``apertis.py::_mha_full``): the plain pre-norm in both layouts, q/k/v
        (int8: as the ``quant_matmul`` mode runs them), RoPE on q and k at
        ``pos_ids`` (rotary positions only), then the causal flash
        kernel when ``flash`` (the caller's gate) holds and there is no bias,
        else the plain attention with ``bias``; then ``o``. Returns ``(out,
        cache)``, the cache being the post-RoPE ``(k, v)`` (B, L, D) with
        ``want_cache``. With ``drop`` (training) the attention context is
        dropped at the attention-dropout rate, the JAX package's stand-in
        for dropping the probabilities (apertis.py:344-348). The flash path
        is :class:`FlashAttention`, whose backward is the dQ and
        dK/dV kernels."""
        b, l, d = h.shape
        x = self.pre_norm(h)
        q, k, v = self.q(x), self.k(x), self.v(x)
        if self.rotary:
            q, k = apply_rope(q, pos_ids, *rope), apply_rope(k, pos_ids, *rope)
        qh, kh, vh = self._split_heads(q), self._split_heads(k), self._split_heads(v)
        if bias is None and flash:
            ctx = FlashAttention.apply(qh, kh, vh)
        else:
            ctx = attn_ops.mha(qh, kh, vh, bias=bias, causal=True)
        if drop is not None:
            ctx = drop(ctx, self.attn_dropout)
        out = self.o(ctx.transpose(1, 2).reshape(b, l, d))
        return out, ((k, v) if want_cache else None)

    def _qkv_sources(self):
        return tuple((p.data_ptr(), p._version)
                     for m in (self.q, self.k, self.v) for p in m.parameters())

    @torch.no_grad()
    def attach_qkv(self) -> bool:
        """Build the fused QKV projection (``models/quantize.py::fuse_qkv``)
        that the int8 decode step uses in place of three products. False,
        and no pack, for a float layer or a partial bias set."""
        fused = None
        if self.quantized:
            fused = fuse_qkv([{"w_q": m.w_q, "w_s": m.w_s, "b": m.b}
                              for m in (self.q, self.k, self.v)])
        if fused is None:
            self.qkv_w_q = self.qkv_w_s = self.qkv_b = None
            self._qkv_key = None
            return False
        self.qkv_w_q, self.qkv_w_s, self.qkv_b = fused["w_q"], fused["w_s"], fused["b"]
        self._qkv_key = self._qkv_sources()
        return True

    def fused_qkv(self) -> Optional[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]]:
        """The attached fused pack ``(w_q, w_s, b)``, rebuilt if q, k or v
        changed since; None when none is attached."""
        if self._qkv_key is None:
            return None
        if self._qkv_key != self._qkv_sources() and not self.attach_qkv():
            return None
        return self.qkv_w_q, self.qkv_w_s, self.qkv_b

    def decode(self, h: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               scales: Optional[Tuple[torch.Tensor, torch.Tensor]], bias: torch.Tensor,
               rope_rows: Optional[Tuple[torch.Tensor, torch.Tensor]], t: int) -> torch.Tensor:
        """One token per row over this layer's flat cache (``apertis.py::
        _mha_decode_step_paired``): plain pre-norm, q/k/v (int8: the rows
        quantized by ``quantize_rows``, then the fused QKV product when one is
        attached), RoPE with the positions' table rows ``rope_rows`` (None for
        absolute positions), the decode attention over the masked cache plus
        the self-term: the kernel where it takes the head width
        (``mha_step.py::kernel_takes``), else its arithmetic in plain torch
        (``mha_decode_ctx_reference``), as the JAX package serves other widths
        through XLA; and ``o`` (int8: on the quantized context). Then slot
        ``t`` of the cache,
        masked out of this attention, gets the token's K/V: as they are, or
        quantized per head with their scales into ``scales`` (``k_ps``,
        ``v_ps`` of the layer). Returns the attention output (B, D)."""
        dt = h.dtype
        x = self.pre_norm(h)
        if self.quantized:
            x_q, x_s = quantize_rows(x)
            fused = self.fused_qkv()
            if fused is not None:
                q, k, v = linear_pre_q(x_q, x_s, *fused, dt).chunk(3, dim=-1)
            else:
                q, k, v = (m.pre_q(x_q, x_s, dt) for m in (self.q, self.k, self.v))
        else:
            q, k, v = self.q(x), self.k(x), self.v(x)
        if rope_rows is not None:
            q, k = rotate(q, *rope_rows), rotate(k, *rope_rows)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kernel = kernel_takes(self.head_dim)
        if scales is None:
            k, v = k.to(k_cache.dtype), v.to(v_cache.dtype)
            attend = mha_decode_ctx if kernel else mha_decode_ctx_reference
            ctx = attend(q.to(dt), k_cache, v_cache, k.to(dt), v.to(dt), bias, self.head_dim)
            k_cache[:, t] = k
            v_cache[:, t] = v
        else:
            ks, vs = scales
            if kernel:
                ctx = mha_decode_ctx_int8(q.to(dt), k_cache, v_cache, k.to(dt), v.to(dt), bias,
                                          ks, vs, self.head_dim)
            else:
                ctx = mha_decode_ctx_reference(q.to(dt), k_cache, v_cache, k.to(dt), v.to(dt),
                                               bias, self.head_dim, ks, vs)
            for val, cache, scale in ((k, k_cache, ks), (v, v_cache, vs)):
                val_q, val_s = quantize_heads(val, self.head_dim)
                cache[:, t] = val_q
                scale[:, :, t] = val_s
        if self.quantized:
            return self.o.pre_q(*quantize_rows(ctx), dt)
        return self.o(ctx.to(dt))


_INT4_NAMES = ("w1_q4", "w1_sh", "w1_s4", "w2_q4", "w2_sh", "w2_s4")


class DenseFFN(nn.Module):
    """Pre-normed dense FFN ``act(x @ w1 + b1) @ w2 + b2`` (``layers/ffn``).
    An int8 layer can also hold the int4 decode pack (:meth:`attach_int4`)
    in non-persistent buffers; the biases are the int8 linears'."""

    quant_matmul = "auto"    # set by ApertisForCausalLM.set_modes

    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool = False):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        self.hidden_act = config.hidden_act
        self.dropout = config.hidden_dropout_prob
        self.quantized = quantized
        # The width test of the JAX package's fused decode FFN gate
        # (ffn_fused.py::fused_eligible), for every weight layout.
        self.fused_decode = h % 128 == 0 and pick_block_n(inter) > 0
        self.pre_norm = Norm(h, config.use_rmsnorm, config.layer_norm_eps, device, dtype)
        self.w1 = _linear(h, inter, True, device, dtype, quantized)
        self.w2 = _linear(inter, h, True, device, dtype, quantized)
        for name in _INT4_NAMES:
            self.register_buffer(name, None, persistent=False)
        self._int4_key = None    # the int8 tensors the int4 pack was built from

    def _int4_sources(self):
        return tuple((p.data_ptr(), p._version) for p in (self.w1.w_q, self.w1.w_s,
                                                           self.w2.w_q, self.w2.w_s))

    @torch.no_grad()
    def attach_int4(self) -> bool:
        """Build the int4 decode pack (``models/quantize.py::int4_ffn_pack``)
        that the decode FFN reads in place of the int8 weights. False, and no
        pack, where the JAX package attaches none: a float layer, or a
        contraction that is not a multiple of 128."""
        pack = None
        if self.quantized:
            pack = int4_ffn_pack({"w_q": self.w1.w_q, "w_s": self.w1.w_s, "b": self.w1.b},
                                 {"w_q": self.w2.w_q, "w_s": self.w2.w_s, "b": self.w2.b})
        if pack is None:
            for name in _INT4_NAMES:
                setattr(self, name, None)
            self._int4_key = None
            return False
        for w in ("w1", "w2"):
            setattr(self, w + "_q4", pack[w]["w_q4"].contiguous())
            setattr(self, w + "_sh", pack[w]["w_sh"].contiguous())
            setattr(self, w + "_s4", pack[w]["w_s"])
        self._int4_key = self._int4_sources()
        return True

    def int4_pack(self) -> Optional[Tuple[torch.Tensor, ...]]:
        """The attached pack ``(w1_q4, w1_sh, w1_s, w2_q4, w2_sh, w2_s)``,
        rebuilt if the int8 weights changed since; None when none is
        attached."""
        if self._int4_key is None:
            return None
        if self._int4_key != self._int4_sources() and not self.attach_int4():
            return None
        return (self.w1_q4, self.w1_sh, self.w1_s4, self.w2_q4, self.w2_sh, self.w2_s4)

    def unfused(self, x: torch.Tensor) -> torch.Tensor:
        """``act(x @ w1 + b1) @ w2 + b2`` of rows normed already, each linear
        as it is (w8a8 in int8): the JAX package's ``_ffn`` without a fused
        stack, which its decode step runs where the fused FFN's width test
        fails."""
        return self.w2(get_activation(self.hidden_act)(self.w1(x)))

    def forward(self, h: torch.Tensor, drop: Optional[Dropout] = None) -> torch.Tensor:
        """Pre-norm and FFN over full sequences (``apertis.py::_ffn``); with
        ``drop`` (training) the activation is dropped before ``w2``."""
        act = get_activation(self.hidden_act)
        if self.quantized and fuses_pre_norm(self.quant_matmul, h.numel() // h.shape[-1]):
            x_q, x_s = ln_quantize(h, *self.pre_norm.weights(), self.pre_norm.eps)
            return self.w2(act(self.w1.pre_q(x_q, x_s, h.dtype)))
        hidden = act(self.w1(self.pre_norm(h)))
        return self.w2(hidden if drop is None else drop(hidden, self.dropout))

    def decode(self, ffn_in: Tuple[torch.Tensor, ...], out_dtype: torch.dtype) -> torch.Tensor:
        """The fused decode FFN on (S, D) rows (``ops/kernels/ffn_fused.py``):
        ``ffn_in`` is the decode step's FFN input, ``(normed,)`` in the float
        layout and ``(x_q, x_s)`` in the int8 one, which reads the int4 pack
        when one is attached (apertis.py:1242-1268)."""
        if self.quantized:
            x_q, x_s = ffn_in
            pack = self.int4_pack()
            if pack is not None:
                w1_q4, w1_sh, w1_s, w2_q4, w2_sh, w2_s = pack
                return ffn_decode_int4(x_q, x_s, w1_q4, w1_sh, w1_s, self.w1.b, w2_q4, w2_sh,
                                       w2_s, self.w2.b, self.hidden_act, out_dtype)
            return ffn_decode_int8(x_q, x_s, self.w1.w_q, self.w1.w_s, self.w1.b,
                                   self.w2.w_q, self.w2.w_s, self.w2.b, self.hidden_act,
                                   out_dtype)
        (x,) = ffn_in
        return ffn_decode(x, self.w1.w, self.w1.b, self.w2.w, self.w2.b,
                          self.hidden_act, out_dtype)


class SwiGLUFFN(nn.Module):
    """Pre-normed SwiGLU FFN ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``,
    its linears without biases and ``config.swiglu_ffn_dim`` wide
    (``layers/ffn`` of a SwiGLU tree, ``apertis.py::_ffn``). No fused decode
    kernel takes it: at decode it runs :meth:`unfused` on the plain
    pre-norm, as the JAX decode step runs ``_ffn``."""

    quant_matmul = "auto"    # set by ApertisForCausalLM.set_modes
    fused_decode = False

    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool = False):
        super().__init__()
        h, f = config.hidden_size, config.swiglu_ffn_dim
        self.dropout = config.hidden_dropout_prob
        self.quantized = quantized
        self.pre_norm = Norm(h, config.use_rmsnorm, config.layer_norm_eps, device, dtype)
        self.w_gate = _linear(h, f, False, device, dtype, quantized)
        self.w_up = _linear(h, f, False, device, dtype, quantized)
        self.w_down = _linear(f, h, False, device, dtype, quantized)

    def unfused(self, x: torch.Tensor) -> torch.Tensor:
        """The FFN of rows normed already, each linear as its mode runs it."""
        return self.w_down(silu(self.w_gate(x)) * self.w_up(x))

    def forward(self, h: torch.Tensor, drop: Optional[Dropout] = None) -> torch.Tensor:
        """Pre-norm and FFN over full sequences; in int8 where the mode
        fuses the pre-norm (``fuses_pre_norm``), one fused norm + row
        quantization (#5) feeds both ``w_gate`` and ``w_up``
        (``_maybe_ln_quant``'s two consumers).
        With ``drop`` (training) the output is dropped here, and the layer
        drops it again, as ``_ffn`` and ``_layer_full`` do."""
        if self.quantized and fuses_pre_norm(self.quant_matmul, h.numel() // h.shape[-1]):
            x_q, x_s = ln_quantize(h, *self.pre_norm.weights(), self.pre_norm.eps)
            hidden = (silu(self.w_gate.pre_q(x_q, x_s, h.dtype))
                      * self.w_up.pre_q(x_q, x_s, h.dtype))
            return self.w_down(hidden)
        out = self.unfused(self.pre_norm(h))
        return out if drop is None else drop(out, self.dropout)


_FAT_NAMES = ("w1t_q", "w1t_q4", "w1t_sh", "w1t_s", "b1t", "w2t_q", "w2t_q4", "w2t_sh",
              "w2t_s")
_FUSED_NAMES = ("w1f_q", "w1f_s", "b1f", "w2f_q", "w2f_s")


class Experts(nn.Module):
    """The stacked expert FFNs (``layers/ffn/experts``): LayerNorm ``ln_w``,
    ``ln_b`` (E, H), ``w1`` (E, H, I) and ``w2`` (E, I, H), or their int8
    forms ``w1_q``/``w1_s`` (E, 1, I) and ``w2_q``/``w2_s`` (E, 1, H), and
    biases ``b1`` (E, I), ``b2`` (E, H). The serving kernels read the fat
    stack (:meth:`fat`), held in non-persistent buffers: int8, or int4 where
    ``fat_bits`` is 4 and H and I allow it; under ``moe_mode="kernel"`` the
    per-expert stack (:meth:`fused`), held the same way. A stack is used
    only once it is attached (built by :meth:`fat` or :meth:`fused`, as
    ``InferenceEngine`` does), as the JAX package uses one only once its
    engine attaches it; :meth:`attached_fat` and :meth:`attached_fused`
    return None before."""

    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool = False):
        super().__init__()
        e, h, inter = config.num_experts, config.hidden_size, config.intermediate_size
        self.ln_w = _param((e, h), device, dtype)
        self.ln_b = _param((e, h), device, dtype)
        for name, shape in (("w1", (e, h, inter)), ("w2", (e, inter, h))):
            if quantized:
                setattr(self, name + "_q", _param(shape, device, torch.int8))
                setattr(self, name + "_s", _param((e, 1, shape[2]), device, torch.float32))
            else:
                setattr(self, name, _param(shape, device, dtype))
        self.b1 = _param((e, inter), device, dtype)
        self.b2 = _param((e, h), device, dtype)
        for name in _FAT_NAMES + _FUSED_NAMES:
            self.register_buffer(name, None, persistent=False)
        self.fat_bits = 8        # 4 under w4a8 serving (ApertisForCausalLM.attach_moe_fat)
        self._fat_key = self._fused_key = None

    def _sources(self):
        return tuple((p.data_ptr(), p._version) for p in self.parameters())

    @torch.no_grad()
    def fat(self) -> Dict[str, torch.Tensor]:
        """The fat stack of these experts (``models/moe_fuse.py``), built at
        first use and again whenever an expert tensor or ``fat_bits``
        changes."""
        key = (self.fat_bits,) + self._sources()
        if self._fat_key != key:
            fat = fuse_one_fat(dict(self.named_parameters()), self.fat_bits)
            for name in _FAT_NAMES:
                setattr(self, name, fat[name].contiguous() if name in fat else None)
            self._fat_key = key
        return {name: getattr(self, name) for name in _FAT_NAMES
                if getattr(self, name) is not None}

    @torch.no_grad()
    def fused(self) -> Dict[str, torch.Tensor]:
        """The per-expert stack of these experts (``models/moe_fuse.py::
        fuse_one``), built at first use and again whenever an expert tensor
        changes."""
        key = self._sources()
        if self._fused_key != key:
            fused = fuse_one(dict(self.named_parameters()))
            for name in _FUSED_NAMES:
                setattr(self, name, fused[name].contiguous())
            self._fused_key = key
        return {name: getattr(self, name) for name in _FUSED_NAMES}

    def attached_fat(self) -> Optional[Dict[str, torch.Tensor]]:
        """The fat stack if one was attached, rebuilt if the experts changed
        since; else None."""
        return self.fat() if self._fat_key is not None else None

    def attached_fused(self) -> Optional[Dict[str, torch.Tensor]]:
        """The per-expert stack if one was attached, rebuilt if the experts
        changed since; else None."""
        return self.fused() if self._fused_key is not None else None


class MoEFFN(nn.Module):
    """Pre-normed top-k MoE FFN (``layers/ffn`` of a MoE tree): ``pre_norm``,
    the router's LayerNorm ``router_ln`` and linear ``router`` (float in both
    layouts), ``w_noise`` (the noisy routing's learnt scale, read in
    training) and :class:`Experts`, with the config's routing, capacity and
    expert-dropout knobs."""

    quant_matmul = "auto"    # both set by ApertisForCausalLM.set_modes
    moe_mode = "fatk"

    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool = False):
        super().__init__()
        h, e = config.hidden_size, config.num_experts
        self.hidden_act, self.top_k = config.hidden_act, config.experts_per_token
        self.eps = config.layer_norm_eps
        self.fat_max_tokens = max(e, config.moe_dense_threshold_tokens)
        self.routing_kw = dict(
            noisy_routing_alpha=config.noisy_routing_alpha,
            load_balancing_loss_coef=config.load_balancing_loss_coef,
            router_z_loss_coef=config.router_z_loss_coef,
            use_load_balancing_loss=config.use_load_balancing_loss,
            use_router_z_loss=config.use_router_z_loss)
        self.capacity_factor = (config.expert_capacity_factor
                                if config.use_expert_capacity_limit else None)
        self.expert_dropout = config.expert_dropout_prob if config.use_expert_dropout else 0.0
        self.pre_norm = Norm(h, config.use_rmsnorm, self.eps, device, dtype)
        self.router_ln = Norm(h, False, self.eps, device, dtype)
        self.router = Linear(h, e, True, device, dtype)
        self.w_noise = (_param((e,), device, dtype) if config.use_noisy_top_k_routing
                        else None)
        self.experts = Experts(config, device, dtype, quantized)

    def router_weights(self) -> RouterWeights:
        return RouterWeights(self.router_ln.w, self.router_ln.b, self.router.w, self.router.b)

    def fat_stack(self) -> Optional[Dict[str, torch.Tensor]]:
        """The attached fat stack under ``moe_mode="fatk"``, else None."""
        return self.experts.attached_fat() if self.moe_mode == "fatk" else None

    def forward(self, h: torch.Tensor, drop: Optional[Dropout] = None,
                training: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pre-norm, routing and experts over full sequences (``apertis.py::
        _ffn``): ``(out, lb_loss, rz_loss)``. In training, with ``drop`` (the
        layer's generator of a step seed), the routing noise and then the
        expert-dropout permutation are drawn from it; with no seed neither
        is, as the JAX package draws neither with ``rng=None``. Then, in the
        JAX package's order: training with the capacity limit,
        :func:`moe_dispatch`; else up to ``max(E, moe_dense_threshold_tokens)``
        tokens, where a fat stack is attached, the fat kernel (``fatk``) or
        its two products in plain torch (``fat``, ``moe_dense_fat``), the
        per-expert kernel where a per-expert stack is (``kernel``), else
        ``moe_dense``; above it the grouped kernel over an attached int8 fat
        stack (under ``fat`` too, as JAX's prefill; its decode step, past
        that many rows, runs ``moe_ragged`` there), else ``moe_ragged``. The
        float dispatches run in the tree's dtype; the serving stacks are not
        read in training. The pre-norm is the plain norm in both layouts:
        the router reads the normed tensor."""
        b, l, d = h.shape
        s = b * l
        num_experts = self.experts.b2.shape[0]
        x = self.pre_norm(h).reshape(s, d)
        noise = active = None
        if training and drop is not None:
            alpha = self.routing_kw["noisy_routing_alpha"]
            if self.w_noise is not None and alpha > 0:
                noise = torch.randn((s, num_experts), generator=drop.gen, device=x.device)
            if self.expert_dropout > 0:
                active = moe_ops.expert_dropout_mask(drop.gen, num_experts, self.expert_dropout)
        routing = moe_ops.route(x, *self.router_weights(), self.top_k, layer_norm_eps=self.eps,
                                training=training, noise=noise, w_noise=self.w_noise,
                                **self.routing_kw)
        experts = dict(self.experts.named_parameters())
        fat = fused = None
        if not training:
            fat = (self.experts.attached_fat() if self.moe_mode in ("fatk", "fat") else None)
            fused = self.experts.attached_fused() if self.moe_mode == "kernel" else None
        if training and self.capacity_factor is not None:
            capacity = max(1, int((s / num_experts) * self.capacity_factor))
            out = moe_ops.moe_dispatch(x, routing, experts, self.hidden_act, self.eps, capacity,
                                       active)
        elif s <= self.fat_max_tokens and fat is not None and self.moe_mode == "fat":
            out = moe_ops.moe_dense_fat(x, routing, fat, self.experts.b2, self.hidden_act,
                                        self.eps)
        elif s <= self.fat_max_tokens and fat is not None:
            out = moe_ops.moe_dense_fat_kernel(x, routing, fat, self.experts.b2,
                                               self.hidden_act, self.eps)
        elif s <= self.fat_max_tokens and fused is not None:
            out = moe_ops.moe_dense_fused(x, routing, fused, self.experts.b2,
                                          self.hidden_act, self.eps)
        elif s <= self.fat_max_tokens:
            out = moe_ops.moe_dense(x, routing, experts, self.hidden_act, self.eps, active,
                                    self.quant_matmul)
        elif fat is not None and "w1t_q4" not in fat:
            out = moe_ops.moe_grouped_fat(x, routing, fat, self.experts.b2, self.hidden_act,
                                          self.eps)
        else:
            out = moe_ops.moe_ragged(x, routing, experts, self.hidden_act, self.eps,
                                     self.quant_matmul, active)
        return out.reshape(b, l, d), routing.lb_loss, routing.rz_loss

    def decode(self, ffn_in: Tuple[torch.Tensor, ...], out_dtype: torch.dtype) -> torch.Tensor:
        """The fat kernel on the decode step's moe epilogue ``(x_q, x_s,
        combine)`` over the attached fat stack, plus ``combine @ b2`` in f32
        (apertis.py:1477-1493)."""
        x_q, x_s, comb = ffn_in
        y = moe_ops.fat_ffn(x_q, x_s, comb, self.fat_stack(), comb.shape[1], self.hidden_act)
        return (y + comb @ self.experts.b2.float()).to(out_dtype)


class DecoderLayer(nn.Module):
    def __init__(self, config: ApertisConfig, device, dtype, quantized: bool = False):
        super().__init__()
        mixer = MultiHeadAttention if is_mha(config) else SelectiveSSM
        self.attn = mixer(config, device, dtype, quantized)
        ffn = SwiGLUFFN if config.use_swiglu else MoEFFN if is_moe(config) else DenseFFN
        self.ffn = ffn(config, device, dtype, quantized)
        self.dropout = config.hidden_dropout_prob

    def forward(self, h: torch.Tensor, drop: Optional[Dropout] = None, training: bool = False,
                **mixer_kw):
        """One layer over full sequences: ``(h + mixer + FFN, cache,
        losses)``, ``losses`` the MoE FFN's ``(lb_loss, rz_loss)`` (None for a
        dense FFN). With ``drop`` (training with a step seed) its draws come
        in a fixed order: the MHA context's mask, the mixer output's, then
        the dense FFN activation's mask, the SwiGLU output's or the MoE
        routing noise and expert permutation, then the FFN output's mask
        (apertis.py:683, 696 and the FFN's :503, 506-528, 633/636)."""
        out, cache = self.attn(h, drop=drop, **mixer_kw)
        h = h + (out if drop is None else drop(out, self.dropout))
        losses = None
        if isinstance(self.ffn, MoEFFN):
            out, lb_loss, rz_loss = self.ffn(h, drop=drop, training=training)
            losses = (lb_loss, rz_loss)
        else:
            out = self.ffn(h, drop=drop)
        return h + (out if drop is None else drop(out, self.dropout)), cache, losses


def _run_layer(layer: DecoderLayer, h: torch.Tensor, seed: Optional[int], training: bool,
               kw: Dict, params: Optional[Dict[str, torch.Tensor]] = None):
    """One layer of the full-sequence forward, ``(h, losses)``, with its
    dropout masks, routing noise and expert permutation drawn from ``seed``
    (none when it is None) and, with ``params``, the layer's parameters
    replaced by them: the form ``torch.utils.checkpoint`` reruns under
    remat, drawing the same values again."""
    drop = None if seed is None else Dropout(seed, h.device)
    kw = dict(drop=drop, training=training, **kw)
    if params is None:
        out = layer(h, **kw)
    else:
        out = torch.func.functional_call(layer, params, (h,), kw)
    return out[0], out[2]


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, device, dtype):
        super().__init__()
        self.tok = _param((vocab, dim), device, dtype)


class PositionTable(nn.Module):
    """The absolute position embeddings ``abs_pos/emb`` (P, D)."""

    def __init__(self, positions: int, dim: int, device, dtype):
        super().__init__()
        self.emb = _param((positions, dim), device, dtype)


class ApertisForCausalLM(nn.Module):
    """The Apertis LM (selective SSM or MHA) in eval mode. Parameters are
    allocated uninitialised; ``models/convert.py::from_jax_params`` fills
    them. The model is built on the card unless ``device`` names another.
    With ``quantized`` the four mixer projections and the FFN's linears (the
    dense ``w1``/``w2``, SwiGLU's three or the experts' stacks) are int8;
    ``int8_head`` allocates the int8 tied head ``lm_head``, an untied config
    the float ``lm_head`` (never quantized, as in JAX). With absolute
    positions it holds their table ``abs_pos``. ``quant_matmul`` and
    ``moe_mode`` are the serving modes of :meth:`set_modes` (``auto`` and
    ``fatk``, the JAX package's defaults). A multimodal model holds the ViT
    (``vision``) and, where its width is not the hidden size,
    ``vision_proj``; ``vision_quantized`` makes their linears int8."""

    def __init__(self, config: ApertisConfig, device="cuda",
                 dtype: torch.dtype = torch.float32, quantized: bool = False,
                 int8_head: bool = False, quant_matmul: str = "auto", moe_mode: str = "fatk",
                 vision_quantized: bool = False):
        super().__init__()
        check_supported(config, quantized)
        check_serving_modes(quant_matmul, moe_mode)
        device = resolve_device(device)
        self.config = config
        self.quantized = quantized
        self.embed = Embedding(config.vocab_size, config.hidden_size, device, dtype)
        self.abs_pos = (PositionTable(config.max_position_embeddings, config.hidden_size,
                                      device, dtype)
                        if config.position_embedding_type == "absolute" else None)
        self.vision = self.vision_proj = None
        if config.multimodal:
            self.vision = VisionEncoder(config, device, dtype, vision_quantized)
            if config.vision_embed_dim != config.hidden_size:
                self.vision_proj = _linear(config.vision_embed_dim, config.hidden_size, True,
                                           device, dtype, vision_quantized)
        self.layers = nn.ModuleList(
            DecoderLayer(config, device, dtype, quantized)
            for _ in range(config.num_hidden_layers))
        self.final_norm = Norm(config.hidden_size, config.use_rmsnorm,
                               config.layer_norm_eps, device, dtype)
        self.lm_head = None
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size, False, device, dtype)
        elif int8_head:
            self.lm_head = QuantLinear(config.hidden_size, config.vocab_size, False, device,
                                       dtype)
        if quantized:
            self.requires_grad_(False)    # training takes float trees only
        self.set_modes(quant_matmul, moe_mode)
        if is_mha(config) and config.position_embedding_type == "rotary":
            # The RoPE tables, built once (f32, (max_position_embeddings, H/2)).
            cos, sin = rope_tables(config.hidden_size, config.max_position_embeddings,
                                   config.rope_theta, device)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def set_modes(self, quant_matmul: str, moe_mode: str) -> None:
        """Choose the serving arithmetic the JAX package picks by environment
        variable. ``quant_matmul`` (``APERTIS_QUANT_MATMUL``): ``auto``,
        ``dyn``, ``weightonly``, ``pallas`` or ``fused``, for every int8
        linear on rows not quantized already (``QuantLinear.forward``, the
        head included; ``ops/quant.py::resolve_mode``), for whether an
        int8 pre-norm fuses its row quantization (``fuses_pre_norm``) and
        for
        ``moe_ragged``'s int8 branch (``dyn`` only, as in JAX). ``moe_mode``
        (``APERTIS_MOE_FUSED``): ``fatk``, ``fat``, ``kernel`` or ``0``,
        which stack a MoE FFN reads once one is attached (none under ``0``)
        and how, see the module docstring. An unknown value raises
        ``ValueError``."""
        check_serving_modes(quant_matmul, moe_mode)
        self.quant_matmul, self.moe_mode = quant_matmul, moe_mode
        for module in self.modules():
            if isinstance(module, (QuantLinear, SelectiveSSM, DenseFFN, SwiGLUFFN, MoEFFN,
                                   VitLayer)):
                module.quant_matmul = quant_matmul
            if isinstance(module, MoEFFN):
                module.moe_mode = moe_mode

    @torch.no_grad()
    def quantize_tied_head(self) -> None:
        """Attach ``lm_head``, an int8 copy of the tied head (``models/
        quantize.py::quantize_tied_head``); the float table stays for the
        embedding lookups. A no-op for an untied head, which stays float."""
        if not self.config.tie_word_embeddings:
            return
        tok = self.embed.tok
        q, s = quantize_weight(tok.T)
        self.lm_head = QuantLinear(tok.shape[1], tok.shape[0], False, tok.device, tok.dtype)
        self.lm_head.w_q.copy_(q)
        self.lm_head.w_s.copy_(s)
        self.lm_head.quant_matmul = self.quant_matmul

    def attach_moe_fat(self, bits: int = 8) -> None:
        """Build every MoE layer's fat stack now (``models/moe_fuse.py``), so
        that the first request does not: ``InferenceEngine`` calls it at
        construction under ``moe_mode`` ``fatk`` and ``fat``, as the JAX
        engine attaches its fat stacks. ``bits=4``
        packs it to int4 where H and I are multiples of 128 (else int8)."""
        for layer in self.layers:
            if isinstance(layer.ffn, MoEFFN):
                layer.ffn.experts.fat_bits = bits
                layer.ffn.experts.fat()

    def attach_moe_fused(self) -> None:
        """Build every MoE layer's per-expert stack now (``models/moe_fuse.py::
        fuse_one``), as the JAX engine attaches it under
        ``APERTIS_MOE_FUSED=kernel``: ``InferenceEngine`` calls it at
        construction under ``moe_mode="kernel"``."""
        for layer in self.layers:
            if isinstance(layer.ffn, MoEFFN):
                layer.ffn.experts.fused()

    def attach_int4_ffn(self) -> bool:
        """Attach every int8 dense FFN's int4 decode pack
        (:meth:`DenseFFN.attach_int4`, ``models/quantize.py::
        attach_int4_ffn``); a no-op, returning False, where the JAX function
        is one (a float or MoE model, contractions not multiples of 128)."""
        attached = False
        for layer in self.layers:
            if isinstance(layer.ffn, DenseFFN):
                attached = layer.ffn.attach_int4() or attached
        return attached

    def attach_qkv(self) -> None:
        """Attach every int8 MHA layer's fused QKV projection
        (:meth:`MultiHeadAttention.attach_qkv`), as the JAX engine attaches
        ``attach_qkv_mha``; a no-op for other models."""
        for layer in self.layers:
            if isinstance(layer.attn, MultiHeadAttention):
                layer.attn.attach_qkv()

    def assemble_inputs(self, input_ids: torch.Tensor,
                        attention_mask: Optional[torch.Tensor],
                        pixel_values: Optional[torch.Tensor]):
        """``(embeds, attention_mask, num_img)``: the token embeddings with
        the image prefix before them when the model is multimodal and
        ``pixel_values`` (B, 3, S, S), or raw (B, H, W, 3) or uint8 images,
        is given, and the mask grown by ones over the prefix
        (``apertis.py::assemble_inputs``); then, with absolute positions,
        the table's rows 0..num_img + L - 1 added (the prefix's positions,
        then the text's). None stays None, so that an MHA ``forward`` without
        a mask stays causal and keeps the flash route over prefix and text
        (JAX's ``mask_was_none``, apertis.py:787-801); the SSM's prefill
        passes its mask in."""
        h = self.embed.tok[input_ids]
        num_img = 0
        if self.vision is not None and pixel_values is not None:
            if pixel_values.dtype == torch.uint8 or pixel_values.shape[-1] == 3:
                pixel_values = preprocess_images(pixel_values, self.config.image_size)
            img = self.vision(pixel_values.to(h.device))
            if self.vision_proj is not None:
                img = self.vision_proj(img)
            b, num_img = h.shape[0], img.shape[1]
            if attention_mask is not None:
                attention_mask = torch.cat([torch.ones((b, num_img), dtype=attention_mask.dtype,
                                                       device=h.device), attention_mask], dim=1)
            h = torch.cat([img.to(h.dtype), h], dim=1)
        if self.abs_pos is not None:
            h = h + self.abs_pos.emb[:h.shape[1]]
        return h, attention_mask, num_img

    def _lm_head(self, h: torch.Tensor) -> torch.Tensor:
        if self.lm_head is not None:
            return self.lm_head(h)
        return h @ self.embed.tok.T     # tied

    def _mha_kwargs(self, attention_mask: Optional[torch.Tensor], length: int) -> Dict:
        """The full-sequence arguments of the MHA layers: the causal x padding
        bias (None without a mask), positions 0..L-1, the RoPE tables (None
        for absolute positions) and the flash gate."""
        bias = None if attention_mask is None else attn_ops.build_bias(attention_mask, length)
        return dict(bias=bias, pos_ids=torch.arange(length, device=self.device),
                    rope=self._rope(), flash=flash_eligible(self.config, length))

    def _rope(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        return (self.rope_cos, self.rope_sin) if hasattr(self, "rope_cos") else None

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, *, training: bool = False,
                seed: Optional[int] = None, pixel_values: Optional[torch.Tensor] = None):
        """Full-sequence logits (B, L, V), over the text positions only where
        ``pixel_values`` puts an image prefix before them (apertis.py:
        786-788, 860-864). An MHA model honours the mask
        (causal x padding bias); without one it runs causal attention, through
        the flash kernel where :func:`flash_eligible` holds. The SSM mixer
        ignores the mask, as the reference does.

        With ``labels`` (B, L) it returns an :class:`LMOutput` whose loss is
        the shifted cross-entropy plus, for a MoE model, the layers' summed
        load-balancing and router z-losses (``apertis.py::forward``).
        ``training`` turns on the MoE routing's training form and, when
        ``seed`` (the step's seed) is given, dropout, the routing noise and
        expert dropout; with ``config.remat`` it runs each layer under
        ``torch.utils.checkpoint``. Layer ``i`` draws from ``(seed, i)``, the
        embedding's mask from ``(seed, embedding)``, so the recomputation
        draws the same values (``fold_in(rng, idx)``, apertis.py:830)."""
        cfg = self.config
        h, attention_mask, num_img = self.assemble_inputs(input_ids, attention_mask,
                                                          pixel_values)
        kw = self._mha_kwargs(attention_mask, h.shape[1]) if is_mha(cfg) else {}
        sp = parallel_current()
        if sp.active:
            if is_mha(cfg) or is_moe(cfg):
                raise NotImplementedError("sequence parallelism is ported for the dense "
                                          "selective-SSM model only (see ROADMAP.md)")
            kw["sp"] = sp
        drawing = training and seed is not None
        if drawing:
            h = Dropout(fold_seed(seed, 0), h.device)(h, cfg.hidden_dropout_prob)
        remat = training and cfg.remat and torch.is_grad_enabled()
        lb_loss = rz_loss = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, layer in enumerate(self.layers):
            layer_seed = fold_seed(seed, i + 1) if drawing else None
            if remat:
                # The layer's parameters go in as inputs, so that the
                # recomputation reads the tensors this forward read (under
                # torch.func.functional_call those are casts of the masters,
                # gone from the module by the time the backward runs).
                h, losses = checkpoint(_run_layer, layer, h, layer_seed, training, kw,
                                       dict(layer.named_parameters()), use_reentrant=False)
            else:
                h, losses = _run_layer(layer, h, layer_seed, training, kw)
            if losses is not None:
                lb_loss, rz_loss = lb_loss + losses[0], rz_loss + losses[1]
        logits = self._lm_head(self.final_norm(h)[:, num_img:])
        if labels is None:
            return logits
        loss = cross_entropy_loss(logits, labels)
        if is_moe(cfg):
            loss = loss + lb_loss + rz_loss
        return LMOutput(loss, logits, lb_loss, rz_loss)

    def init_cache(self, batch_size: int, max_length: Optional[int] = None,
                   kv_int8: bool = False) -> Cache:
        """Zeroed decode cache, stacked over layers. Selective SSM: ``conv``
        (nl, B, K-1, C) in the model's dtype (the dtype JAX's prefill leaves
        it in, whatever ``config.dtype``: apertis.py:1082) and ``ssm`` (nl,
        B, H, N) float32
        (``max_length`` and ``kv_int8`` do not apply). MHA: the JAX package's
        flat layout, ``k``, ``v`` (nl, B, L, H * Dh) with L = ``max_length``
        (default ``config.decode_max_length``), in the model's dtype, or int8
        with ``kv_int8`` and then f32 per-(head, slot) scales ``k_ps``,
        ``v_ps`` (nl, B, H, L)."""
        cfg = self.config
        nl = cfg.num_hidden_layers
        if is_mha(cfg):
            length = max_length or cfg.decode_max_length
            shape = (nl, batch_size, length, cfg.hidden_size)
            dtype = torch.int8 if kv_int8 else self.embed.tok.dtype
            cache = {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                     "v": torch.zeros(shape, dtype=dtype, device=self.device)}
            if kv_int8:
                for name in ("k_ps", "v_ps"):
                    cache[name] = torch.zeros((nl, batch_size, cfg.num_attention_heads, length),
                                              dtype=torch.float32, device=self.device)
            return cache
        return {
            "conv": torch.zeros((nl, batch_size, max(cfg.ssm_conv_kernel - 1, 0),
                                 cfg.ssm_d_inner),
                                dtype=self.embed.tok.dtype, device=self.device),
            "ssm": torch.zeros((nl, batch_size, cfg.num_attention_heads, cfg.ssm_d_state),
                               dtype=torch.float32, device=self.device),
        }

    @torch.no_grad()
    def prefill(self, cache: Cache, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                logit_positions: Optional[torch.Tensor] = None,
                pixel_values: Optional[torch.Tensor] = None) -> PrefillOutput:
        """Run right-padded prompts through the model, writing each layer's
        ``{conv, ssm}`` state into ``cache`` in place. With ``logit_positions``
        (B,) only those positions reach the LM head and ``logits`` is
        (B, 1, V). With ``pixel_values`` the image prefix runs first; the
        logits and ``logit_positions`` are over the text positions, and the
        length written counts the prefix (apertis.py:1008-1080): an MHA
        cache then holds the prefix in slots [0, num_img) and the prompt
        after it."""
        b, l = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, l), dtype=torch.int32, device=input_ids.device)
        h, attention_mask, num_img = self.assemble_inputs(input_ids, attention_mask,
                                                          pixel_values)
        if is_mha(self.config):
            # The post-RoPE K/V of the prefix and the prompt, at positions
            # 0..num_img + L - 1, fill slots [0, num_img + L) of each layer.
            total = h.shape[1]
            kw = self._mha_kwargs(attention_mask, total)
            head_dim = self.config.head_dim
            for i, layer in enumerate(self.layers):
                h, (k, v), _ = layer(h, want_cache=True, **kw)
                for name, val in (("k", k), ("v", v)):
                    if name + "_ps" in cache:
                        val_q, val_s = quantize_heads(val, head_dim)
                        cache[name][i, :, :total] = val_q
                        cache[name + "_ps"][i, :, :, :total] = val_s.transpose(1, 2)
                    else:
                        cache[name][i, :, :total] = val
        else:
            seq_lens = attention_mask.to(torch.int64).sum(dim=1)
            for i, layer in enumerate(self.layers):
                h, layer_cache, _ = layer(h, seq_mask=attention_mask, seq_lens=seq_lens,
                                          want_cache=True)
                cache["conv"][i].copy_(layer_cache["conv"])
                cache["ssm"][i].copy_(layer_cache["ssm"])
        h = self.final_norm(h)[:, num_img:]
        if logit_positions is not None:
            h = h[torch.arange(b, device=h.device), logit_positions.long()][:, None, :]
        return PrefillOutput(self._lm_head(h), cache, num_img + l)

    @torch.no_grad()
    def decode_step(self, cache: Cache, token_ids: torch.Tensor, t: Optional[int] = None,
                    attn_mask_row: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
        """One autoregressive step for tokens (B,): returns logits (B, V) and
        ``cache``, updated in place. Selective SSM: each layer is one fused
        mixer step that also emits the FFN's input (normed, or normed and
        quantized; for MoE the expert input and the combine weights), then the
        fused decode FFN; ``t`` and ``attn_mask_row`` do not apply, and
        ``positions`` (default ``t``) only with absolute positions, whose
        table rows are added to the embeddings (apertis.py:1155-1162). A MoE
        model past ``moe_dense_threshold_tokens`` rows, with no fat stack
        attached (``moe_mode`` ``fat``, ``kernel`` or ``0``, or no engine),
        or with a top-k other than 2 runs the step without its epilogue and
        the FFN as over full sequences, as the JAX package does
        (apertis.py:1224-1230); a dense FFN
        that fails the fused FFN's width test (``DenseFFN.fused_decode``),
        and a SwiGLU FFN, run the step without its epilogue and then the
        plain pre-norm and the FFN's ``unfused`` (apertis.py:1234-1268,
        1497-1500). MHA: see :meth:`_mha_decode_step`."""
        if is_mha(self.config):
            return self._mha_decode_step(cache, token_ids, t, attn_mask_row, positions)
        cfg = self.config
        eps = cfg.layer_norm_eps
        h = self._decode_embeds(token_ids, t, positions)           # (B, D)
        b = h.shape[0]
        for i, layer in enumerate(self.layers):
            moe_full = is_moe(cfg) and (b > cfg.moe_dense_threshold_tokens
                                        or cfg.experts_per_token != 2
                                        or layer.ffn.fat_stack() is None)
            conv = cache["conv"][i]
            ssm = cache["ssm"][i].view(b, -1)          # updated in place
            epilogue = not moe_full and (is_moe(cfg) or layer.ffn.fused_decode)
            ffn = {"ffn_norm": layer.ffn.pre_norm.weights()} if epilogue else {}
            if is_moe(cfg) and epilogue:
                ffn["router"] = layer.ffn.router_weights()
            outs = ssm_decode_step(h, conv, ssm, layer.attn.mixer_weights(), eps,
                                   ssm_out=ssm, **ffn)
            h2, xp_new = outs[0], outs[1]
            if conv.shape[1] > 0:
                conv.copy_(torch.cat([conv[:, 1:], xp_new[:, None, :]], dim=1))
            if epilogue:
                h = h2 + layer.ffn.decode(outs[3:], h2.dtype)
            elif moe_full:
                h = h2 + layer.ffn(h2[:, None, :])[0][:, 0]
            else:
                h = h2 + layer.ffn.unfused(layer.ffn.pre_norm(h2))
        return self._lm_head(self.final_norm(h)), cache

    def _decode_embeds(self, token_ids: torch.Tensor, t: Optional[int],
                       positions: Optional[torch.Tensor]) -> torch.Tensor:
        """The decode step's input rows: the tokens' embeddings, plus the
        absolute position table's rows at ``positions`` (default ``t``)."""
        h = self.embed.tok[token_ids]
        if self.abs_pos is None:
            return h
        if positions is None:
            if t is None:
                raise ValueError("decode_step with absolute positions needs positions or t")
            positions = torch.full(token_ids.shape, t, device=h.device)
        return h + self.abs_pos.emb[positions.long()]

    def _mha_decode_step(self, cache: Cache, token_ids: torch.Tensor, t: Optional[int],
                         attn_mask_row: Optional[torch.Tensor],
                         positions: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
        """The MHA step (``apertis.py::decode_step``'s flat-cache path):
        ``t`` is the physical cache slot of the tokens, ``attn_mask_row``
        (B, L) the validity of every slot including ``t`` (default: slots up
        to ``t``), ``positions`` (B,) the logical positions for RoPE (default
        ``t``; they differ for right-padded rows). Slot ``t`` is masked out of
        the cached attention (its token enters as the self-term) with the
        additive ``NEG``. With absolute positions the table's rows at the
        positions are added to the embeddings and nothing rotates. Each
        layer: the attention (:meth:`MultiHeadAttention.decode`, which then
        writes slot ``t``), the residual, then the FFN: a MoE FFN as over
        full sequences (its plain pre-norm, routing, then the fat kernel up
        to ``max(E, moe_dense_threshold_tokens)`` rows, or what ``moe_mode``
        takes: apertis.py:545-580, 1193-1230); else the plain pre-norm and
        the decode FFN kernel (int8: on rows quantized by ``quantize_rows``),
        or the FFN's ``unfused`` where the fused FFN's width test fails and
        for SwiGLU; the residual."""
        if t is None:
            raise ValueError("decode_step of an MHA model needs the cache slot t")
        h = self._decode_embeds(token_ids, t, positions)           # (B, D)
        b = h.shape[0]
        dev = h.device
        slots = torch.arange(cache["k"].shape[2], device=dev)[None, :]
        valid = slots <= t if attn_mask_row is None else attn_mask_row > 0
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        bias = torch.where(valid & (slots != t), zero, torch.full_like(zero, NEG))
        bias = bias.expand(b, -1).contiguous()
        rope_rows = None
        if self._rope() is not None:
            pos = (torch.full((b,), t, device=dev) if positions is None else positions).long()
            rope_rows = (self.rope_cos[pos], self.rope_sin[pos])
        int8_kv = "k_ps" in cache
        for i, layer in enumerate(self.layers):
            scales = (cache["k_ps"][i], cache["v_ps"][i]) if int8_kv else None
            h = h + layer.attn.decode(h, cache["k"][i], cache["v"][i], scales, bias,
                                      rope_rows, t)
            ffn = layer.ffn
            if isinstance(ffn, MoEFFN):
                h = h + ffn(h[:, None, :])[0][:, 0]
                continue
            x = ffn.pre_norm(h)
            if not ffn.fused_decode:
                h = h + ffn.unfused(x)
            else:
                h = h + ffn.decode(quantize_rows(x) if ffn.quantized else (x,), h.dtype)
        return self._lm_head(self.final_norm(h)), cache
