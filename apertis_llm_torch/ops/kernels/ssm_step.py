"""One decode step of the whole selective-SSM mixer.

``ssm_decode_step`` launches the CUDA kernel in ``csrc/ssm_step.cu`` (three
launches per layer) for CUDA tensors and runs
:func:`ssm_decode_step_reference`, its plain PyTorch version, for CPU tensors.
It replaces ``apertis_llm_tpu/ops/pallas/ssm_step.py::ssm_decode_step_fused``
with the bf16 weight layout and ``ffn_mode`` "none" or "dense" (``ffn_norm``
given). The semantics are the fused kernel's, not those of the unfused
``models/apertis.py::_ssm_decode_step``: the two round through bf16 at
different points.

The weights are one layer's tensors as the model holds them, in the (in, out)
layout, so no weight pack is built: the x_param projection is cut into its
dt / B / C column ranges by pointer offset, the conv taps are read in their
(C, K) layout and ``-exp(A_log)`` is computed in the kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.norms import layer_norm, rms_norm

_ROWS = 8          # batch rows per block (csrc/ssm_step.cu kRows)


class MixerWeights(NamedTuple):
    """One layer's selective-SSM weights, JAX (in, out) layout."""
    norm_w: torch.Tensor            # (D,) pre-norm weight (RMS: scale)
    norm_b: Optional[torch.Tensor]  # (D,) LayerNorm bias; None = RMSNorm
    inx_w: torch.Tensor             # (D, C)
    inz_w: torch.Tensor             # (D, C)
    conv_w: torch.Tensor            # (C, K)
    conv_b: torch.Tensor            # (C,)
    xparam_w: torch.Tensor          # (C, R + 2C): dt | B | C columns
    dt_w: torch.Tensor              # (R, H)
    dt_b: torch.Tensor              # (H,)
    a_log: torch.Tensor             # (H, N)
    d_skip: torch.Tensor            # (C,)
    out_w: torch.Tensor             # (C, D)


def _norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], eps: float):
    return rms_norm(x, w, eps) if b is None else layer_norm(x, w, b, eps)


def _bdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dot in the weight's dtype with f32 accumulation, f32 result."""
    return x.to(w.dtype).float() @ w.float()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # Overflow-safe log(1 + e^x): above the knee it is x to f32 precision.
    return torch.where(x > 20.0, x, torch.log(1.0 + torch.exp(torch.clamp(x, max=20.0))))


def ssm_decode_step_reference(
    h: torch.Tensor,            # (B, D) residual stream
    conv_state: torch.Tensor,   # (B, K-1, C) carried conv window
    ssm_state: torch.Tensor,    # (B, C) float32
    w: MixerWeights,
    eps: float,
    ffn_norm: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    ssm_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Returns ``(h + mixer_out, new_x_proj, new_ssm_state)`` and, with
    ``ffn_norm``, the bf16 FFN input ``ffn_pre_norm(h + mixer_out)``. With
    ``ssm_out`` (which may be ``ssm_state``) the new state is written there
    and returned."""
    x = h.float()
    nrm = _norm(x, w.norm_w, w.norm_b, eps)
    x_proj = _bdot(nrm, w.inx_w)
    z = _bdot(nrm, w.inz_w)
    xp_b = x_proj.to(conv_state.dtype)
    cw = w.conv_w.float()
    k = cw.shape[1]
    yc = xp_b.float() * cw[:, k - 1]
    if k > 1:
        taps = conv_state[:, 0].float() * cw[:, 0]
        for j in range(1, k - 1):
            taps = taps + conv_state[:, j].float() * cw[:, j]
        yc = taps + yc
    yc = yc + w.conv_b.float()
    x_act = yc * torch.sigmoid(yc)
    r = w.dt_w.shape[0]
    c = w.inx_w.shape[1]
    dt_feats = _bdot(x_act, w.xparam_w[:, :r])
    b_seg = _bdot(x_act, w.xparam_w[:, r:r + c])
    c_seg = _bdot(x_act, w.xparam_w[:, r + c:])
    delta = _softplus(_bdot(dt_feats, w.dt_w) + w.dt_b.float())     # (B, H)
    delta_c = delta.repeat_interleave(c // w.dt_w.shape[1], dim=1)    # (B, C)
    a_row = -torch.exp(w.a_log.float()).reshape(-1)
    h_new = torch.exp(delta_c * a_row) * ssm_state + b_seg
    y = c_seg * h_new + w.d_skip.float() * x_act
    g = y * (z * torch.sigmoid(z))
    hsum = x + _bdot(g, w.out_w)
    if ssm_out is not None:
        h_new = ssm_out.copy_(h_new)
    outs = (hsum.to(h.dtype), xp_b, h_new)
    if ffn_norm is not None:
        # Rounded through bf16, as the FFN kernel's input.
        outs += (_norm(hsum, ffn_norm[0], ffn_norm[1], eps).to(torch.bfloat16),)
    return outs


def ssm_decode_step(
    h: torch.Tensor,
    conv_state: torch.Tensor,
    ssm_state: torch.Tensor,
    w: MixerWeights,
    eps: float,
    ffn_norm: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    ssm_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One mixer decode step: kernel on CUDA tensors, plain version on CPU.

    The kernel takes bf16 ``h``, ``conv_state`` and weights, an f32
    ``ssm_state`` (and ``ssm_out``, which may be the same tensor), all
    contiguous, and one norm kind for both norms.
    """
    if h.device.type == "cpu":
        return ssm_decode_step_reference(h, conv_state, ssm_state, w, eps, ffn_norm,
                                         ssm_out)
    bf16 = (torch.bfloat16,)
    bsz, d = h.shape
    c = w.inx_w.shape[1]
    k = w.conv_w.shape[1]
    r, heads = w.dt_w.shape
    n = c // max(heads, 1)
    rms = w.norm_b is None
    dev = h.device
    _build.check_tensor(h, (bsz, d), bf16, "h", dev)
    _build.check_tensor(conv_state, (bsz, k - 1, c), bf16, "conv_state", dev)
    _build.check_tensor(ssm_state, (bsz, c), (torch.float32,), "ssm_state", dev)
    if ssm_out is not None:
        _build.check_tensor(ssm_out, (bsz, c), (torch.float32,), "ssm_out", dev)
    shapes = {"norm_w": (d,), "norm_b": (d,), "inx_w": (d, c), "inz_w": (d, c),
              "conv_w": (c, k), "conv_b": (c,), "xparam_w": (c, r + 2 * c),
              "dt_w": (r, heads), "dt_b": (heads,), "a_log": (heads, n),
              "d_skip": (c,), "out_w": (c, d)}
    for name, shape in shapes.items():
        t = getattr(w, name)
        if t is not None:
            _build.check_tensor(t, shape, bf16, name, dev)
    if ffn_norm is not None:
        if (ffn_norm[1] is None) != rms:
            raise ValueError("ssm_decode_step: both norms must be of one kind")
        _build.check_tensor(ffn_norm[0], (d,), bf16, "ffn_norm weight", dev)
        if ffn_norm[1] is not None:
            _build.check_tensor(ffn_norm[1], (d,), bf16, "ffn_norm bias", dev)
    if bsz == 0 or heads * n != c:
        raise ValueError(f"ssm_decode_step: unsupported shape B={bsz} C={c} H={heads}")

    h_out = torch.empty_like(h)
    xp_out = torch.empty((bsz, c), dtype=conv_state.dtype, device=dev)
    if ssm_out is None:
        ssm_out = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    z = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    g = torch.empty((bsz, c), dtype=torch.bfloat16, device=dev)
    tickets = torch.empty((-(-bsz // _ROWS),), dtype=torch.int32, device=dev)
    ffn_in = hsum = None
    if ffn_norm is not None:
        ffn_in = torch.empty((bsz, d), dtype=torch.bfloat16, device=dev)
        hsum = torch.empty((bsz, d), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn_w, fn_b = ffn_norm if ffn_norm is not None else (None, None)
    err = _build.load_library().apertis_ssm_decode_step(
        ptr(h), ptr(conv_state), ptr(ssm_state), ptr(w.norm_w), ptr(w.norm_b),
        ptr(w.inx_w), ptr(w.inz_w), ptr(w.conv_w), ptr(w.conv_b), ptr(w.xparam_w),
        ptr(w.dt_w), ptr(w.dt_b), ptr(w.a_log), ptr(w.d_skip), ptr(w.out_w),
        ptr(fn_w), ptr(fn_b), ptr(h_out), ptr(xp_out), ptr(ssm_out), ptr(ffn_in),
        ptr(z), ptr(g), ptr(hsum), ptr(tickets), bsz, d, c, k, r, heads, n,
        int(rms), float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssm_decode_step")
    ssm_decode_step.launches += 1
    outs = (h_out, xp_out, ssm_out)
    return outs + (ffn_in,) if ffn_in is not None else outs


ssm_decode_step.launches = 0
