"""Apertis decoder-only LM in PyTorch: the text-only selective-SSM model.

The counterpart of ``apertis_llm_tpu/models/apertis.py`` for the variant
ported so far (``models/params.py::check_supported``): pre-norm residual
Mamba-style selective mixer, pre-norm residual dense FFN, final post-norm,
tied LM head. Module and parameter names follow the JAX parameter tree, so
``layers.3.attn.in_proj_x.w`` is layer 3 of ``layers/attn/in_proj_x/w``, and
linear weights keep the (in, out) layout.

Three paths, with the JAX package's semantics:
  * ``forward``: full-sequence logits; like the reference, the SSM mixer
    ignores the attention mask here (apertis.py:393-398, 772).
  * ``prefill``: masked full-sequence pass that fills the ``{conv, ssm}``
    decode cache; padded steps are identity transitions and each row's conv
    window is gathered at its true length.
  * ``decode_step``: one token per row through the fused mixer step and the
    fused decode FFN (``ops/kernels``), whose semantics are those of the JAX
    package's fused-kernel decode path.

The three hand-written kernels run on CUDA tensors; on CPU tensors their
plain PyTorch versions run. Plain ``torch.matmul`` does the prefill
projections, the prefill FFN and the LM head, which the JAX package leaves to
XLA outside its kernels.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.params import check_supported
from apertis_llm_torch.ops import ssm as ssm_ops
from apertis_llm_torch.ops.activations import get_activation, silu
from apertis_llm_torch.ops.kernels.ffn_fused import ffn_decode
from apertis_llm_torch.ops.kernels.ssm_step import MixerWeights, ssm_decode_step
from apertis_llm_torch.ops.norms import layer_norm, rms_norm

Cache = Dict[str, torch.Tensor]


class PrefillOutput(NamedTuple):
    logits: torch.Tensor     # (B, L, V), or (B, 1, V) with logit_positions
    cache: Cache
    length: int              # tokens written to the cache


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Linear(nn.Module):
    """``x @ w (+ b)`` with ``w`` in the (in, out) layout."""

    def __init__(self, fan_in: int, fan_out: int, bias: bool, device, dtype):
        super().__init__()
        self.w = _param((fan_in, fan_out), device, dtype)
        self.b = _param((fan_out,), device, dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y + self.b if self.b is not None else y


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

    def __init__(self, config: ApertisConfig, device, dtype):
        super().__init__()
        h, c = config.hidden_size, config.ssm_d_inner
        heads, n = config.num_attention_heads, config.ssm_d_state
        r, k = config.ssm_dt_rank, config.ssm_conv_kernel
        self.heads, self.d_state, self.dt_rank, self.k = heads, n, r, k
        self.pre_norm = Norm(h, config.use_rmsnorm, config.layer_norm_eps, device, dtype)
        self.in_proj_x = Linear(h, c, False, device, dtype)
        self.in_proj_z = Linear(h, c, False, device, dtype)
        self.conv = DepthwiseConv(c, k, device, dtype)
        self.x_param_proj = Linear(c, r + 2 * heads * n, False, device, dtype)
        self.dt_proj = Linear(r, heads, True, device, dtype)
        self.A_log = _param((heads, n), device, dtype)
        self.D = _param((c,), device, dtype)
        self.out_proj = Linear(c, h, False, device, dtype)

    def forward(self, x: torch.Tensor, *, seq_mask: Optional[torch.Tensor] = None,
                seq_lens: Optional[torch.Tensor] = None, want_cache: bool = False):
        """Mixer over a full pre-normed sequence x (B, L, D)
        (``apertis.py::_ssm_full``). Returns ``(out, cache)``; with
        ``seq_mask`` padded steps are identity transitions and the conv
        window is gathered at ``seq_lens``."""
        b, l, _ = x.shape
        heads, n, r, k = self.heads, self.d_state, self.dt_rank, self.k
        x_proj = self.in_proj_x(x)                             # (B, L, C)
        z = self.in_proj_z(x)
        x_act = silu(ssm_ops.depthwise_causal_conv(x_proj, self.conv.w, self.conv.b))
        raw = self.x_param_proj(x_act)
        delta = torch.nn.functional.softplus(self.dt_proj(raw[..., :r]).float())
        a_cont = -torch.exp(self.A_log.float())
        y, h_last = ssm_ops.ssm_mix(
            delta, a_cont, raw[..., r:r + heads * n].reshape(b, l, heads, n),
            raw[..., r + heads * n:].reshape(b, l, heads, n),
            seq_mask=seq_mask, out_dtype=x.dtype)
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
            idx = seq_lens.long()[:, None] + torch.arange(k - 1, device=x.device)[None, :]
            conv_state = torch.gather(
                pad, 1, idx[:, :, None].expand(b, k - 1, pad.shape[-1]))
        return out, {"conv": conv_state, "ssm": h_last}

    def mixer_weights(self) -> MixerWeights:
        norm_w, norm_b = self.pre_norm.weights()
        return MixerWeights(
            norm_w, norm_b, self.in_proj_x.w, self.in_proj_z.w, self.conv.w,
            self.conv.b, self.x_param_proj.w, self.dt_proj.w, self.dt_proj.b,
            self.A_log, self.D, self.out_proj.w)


class DenseFFN(nn.Module):
    """Pre-normed dense FFN ``act(x @ w1 + b1) @ w2 + b2`` (``layers/ffn``)."""

    def __init__(self, config: ApertisConfig, device, dtype):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        self.hidden_act = config.hidden_act
        self.pre_norm = Norm(h, config.use_rmsnorm, config.layer_norm_eps, device, dtype)
        self.w1 = Linear(h, inter, True, device, dtype)
        self.w2 = Linear(inter, h, True, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(get_activation(self.hidden_act)(self.w1(x)))

    def decode(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        """The fused decode FFN on (S, D) rows (``ops/kernels/ffn_fused.py``)."""
        return ffn_decode(x, self.w1.w, self.w1.b, self.w2.w, self.w2.b,
                          self.hidden_act, out_dtype)


class DecoderLayer(nn.Module):
    def __init__(self, config: ApertisConfig, device, dtype):
        super().__init__()
        self.attn = SelectiveSSM(config, device, dtype)
        self.ffn = DenseFFN(config, device, dtype)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, device, dtype):
        super().__init__()
        self.tok = _param((vocab, dim), device, dtype)


class ApertisForCausalLM(nn.Module):
    """The selective-SSM Apertis LM in eval mode. Parameters are allocated
    uninitialised; ``models/convert.py::from_jax_params`` fills them."""

    def __init__(self, config: ApertisConfig, device="cpu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(config)
        self.config = config
        self.embed = Embedding(config.vocab_size, config.hidden_size, device, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(config, device, dtype) for _ in range(config.num_hidden_layers))
        self.final_norm = Norm(config.hidden_size, config.use_rmsnorm,
                               config.layer_norm_eps, device, dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def _lm_head(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.embed.tok.T     # tied

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence logits (B, L, V). The mask is accepted for the
        reference's signature; the SSM mixer ignores it, as the reference
        does."""
        del attention_mask
        h = self.embed.tok[input_ids]
        for layer in self.layers:
            out, _ = layer.attn(layer.attn.pre_norm(h))
            h = h + out
            h = h + layer.ffn(layer.ffn.pre_norm(h))
        return self._lm_head(self.final_norm(h))

    def init_cache(self, batch_size: int) -> Cache:
        """Zeroed decode cache, stacked over layers: ``conv`` (nl, B, K-1, C)
        in ``config.dtype`` and ``ssm`` (nl, B, H, N) float32."""
        cfg = self.config
        nl = cfg.num_hidden_layers
        return {
            "conv": torch.zeros((nl, batch_size, max(cfg.ssm_conv_kernel - 1, 0),
                                 cfg.ssm_d_inner),
                                dtype=getattr(torch, cfg.dtype), device=self.device),
            "ssm": torch.zeros((nl, batch_size, cfg.num_attention_heads, cfg.ssm_d_state),
                               dtype=torch.float32, device=self.device),
        }

    @torch.no_grad()
    def prefill(self, cache: Cache, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                logit_positions: Optional[torch.Tensor] = None) -> PrefillOutput:
        """Run right-padded prompts through the model, writing each layer's
        ``{conv, ssm}`` state into ``cache`` in place. With ``logit_positions``
        (B,) only those positions reach the LM head and ``logits`` is
        (B, 1, V)."""
        b, l = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, l), dtype=torch.int32, device=input_ids.device)
        seq_lens = attention_mask.to(torch.int64).sum(dim=1)
        h = self.embed.tok[input_ids]
        for i, layer in enumerate(self.layers):
            out, layer_cache = layer.attn(layer.attn.pre_norm(h), seq_mask=attention_mask,
                                          seq_lens=seq_lens, want_cache=True)
            h = h + out
            h = h + layer.ffn(layer.ffn.pre_norm(h))
            cache["conv"][i].copy_(layer_cache["conv"])
            cache["ssm"][i].copy_(layer_cache["ssm"])
        h = self.final_norm(h)
        if logit_positions is not None:
            h = h[torch.arange(b, device=h.device), logit_positions.long()][:, None, :]
        return PrefillOutput(self._lm_head(h), cache, l)

    @torch.no_grad()
    def decode_step(self, cache: Cache, token_ids: torch.Tensor
                    ) -> Tuple[torch.Tensor, Cache]:
        """One autoregressive step for tokens (B,): returns logits (B, V) and
        ``cache``, updated in place. Each layer is one fused mixer step that
        also emits the FFN's normed input, then the fused decode FFN."""
        eps = self.config.layer_norm_eps
        h = self.embed.tok[token_ids]                              # (B, D)
        b = h.shape[0]
        for i, layer in enumerate(self.layers):
            conv = cache["conv"][i]
            ssm = cache["ssm"][i].view(b, -1)          # updated in place
            h2, xp_new, _, ffn_in = ssm_decode_step(
                h, conv, ssm, layer.attn.mixer_weights(), eps,
                ffn_norm=layer.ffn.pre_norm.weights(), ssm_out=ssm)
            if conv.shape[1] > 0:
                conv.copy_(torch.cat([conv[:, 1:], xp_new[:, None, :]], dim=1))
            h = h2 + layer.ffn.decode(ffn_in, h2.dtype)
        return self._lm_head(self.final_norm(h)), cache
