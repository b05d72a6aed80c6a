"""One decode step of the whole selective-SSM mixer.

``ssm_decode_step`` launches the CUDA kernel in ``csrc/ssm_step.cu`` (three
launches per layer) for CUDA tensors and runs
:func:`ssm_decode_step_reference`, its plain PyTorch version, for CPU tensors.
It replaces ``apertis_llm_tpu/ops/pallas/ssm_step.py::ssm_decode_step_fused``
with ``ffn_mode`` "none" or "dense" (``ffn_norm`` given) in both weight
layouts, picked from the weights' dtype as the TPU kernel picks it from the
pack: bf16, or int8 with per-output-channel scales (launched and counted by
:func:`ssm_decode_step_int8`). The semantics are the fused kernel's, not
those of the unfused ``models/apertis.py::_ssm_decode_step``: the two round
through bf16 at different points.

The weights are one layer's tensors as the model holds them, in the (in, out)
layout, so no weight pack is built: the x_param projection and its scales
are cut into their dt / B / C column ranges by pointer offset, the conv taps
are read in their (C, K) layout and ``-exp(A_log)`` is computed in the kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.norms import layer_norm, rms_norm
from apertis_llm_torch.ops.quant import int_mm

_ROWS = 8          # batch rows per block (csrc/ssm_step.cu kRows)


class MixerWeights(NamedTuple):
    """One layer's selective-SSM weights, JAX (in, out) layout. In the int8
    layout the four projections are int8 and carry (1, out) f32 scales."""
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
    inx_s: Optional[torch.Tensor] = None      # (1, C) int8 layout only
    inz_s: Optional[torch.Tensor] = None      # (1, C)
    xparam_s: Optional[torch.Tensor] = None   # (1, R + 2C)
    out_s: Optional[torch.Tensor] = None      # (1, D)

    @property
    def quantized(self) -> bool:
        return self.inx_w.dtype == torch.int8


def _norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], eps: float):
    return rms_norm(x, w, eps) if b is None else layer_norm(x, w, b, eps)


def _bdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dot in the weight's dtype with f32 accumulation, f32 result."""
    return x.to(w.dtype).float() @ w.float()


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of f32 rows as the TPU kernel has it (ssm_step.py:39-43):
    ``s = max(absmax, 1e-8) * (1/127)``, ``q = rint(x * (1/s))``."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x * (1.0 / scale)), -127, 127).to(torch.int8)
    return q, scale


def _idot(q: torch.Tensor, scale: torch.Tensor, w_q: torch.Tensor,
          w_s: torch.Tensor) -> torch.Tensor:
    """``int32(q @ w_q) * scale * w_s`` in f32 (ssm_step.py:46-49)."""
    return int_mm(q, w_q).float() * scale * w_s.reshape(1, -1).float()


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
    ``ffn_norm``, the FFN input ``ffn_pre_norm(h + mixer_out)`` rounded
    through bf16: as it is in the bf16 layout, quantized per row
    ``(x_q int8 (B, D), x_s f32 (B, 1))`` in the int8 layout. With
    ``ssm_out`` (which may be ``ssm_state``) the new state is written there
    and returned."""
    quant = w.quantized
    x = h.float()
    nrm = _norm(x, w.norm_w, w.norm_b, eps)
    if quant:
        nq, ns = _quant_rows(nrm)
        x_proj = _idot(nq, ns, w.inx_w, w.inx_s)
        z = _idot(nq, ns, w.inz_w, w.inz_s)
    else:
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
    if quant:
        aq, ascale = _quant_rows(x_act)

        def x_param(lo, hi):
            return _idot(aq, ascale, w.xparam_w[:, lo:hi], w.xparam_s[:, lo:hi])
    else:
        def x_param(lo, hi):
            return _bdot(x_act, w.xparam_w[:, lo:hi])
    dt_feats = x_param(0, r)
    b_seg = x_param(r, r + c)
    c_seg = x_param(r + c, r + 2 * c)
    # dt_proj stays bf16 in both layouts; dt_feats is rounded to its dtype.
    delta = _softplus(_bdot(dt_feats, w.dt_w) + w.dt_b.float())     # (B, H)
    delta_c = delta.repeat_interleave(c // w.dt_w.shape[1], dim=1)    # (B, C)
    a_row = -torch.exp(w.a_log.float()).reshape(-1)
    h_new = torch.exp(delta_c * a_row) * ssm_state + b_seg
    y = c_seg * h_new + w.d_skip.float() * x_act
    g = y * (z * torch.sigmoid(z))
    out = _idot(*_quant_rows(g), w.out_w, w.out_s) if quant else _bdot(g, w.out_w)
    hsum = x + out
    if ssm_out is not None:
        h_new = ssm_out.copy_(h_new)
    outs = (hsum.to(h.dtype), xp_b, h_new)
    if ffn_norm is not None:
        # Rounded through bf16, as the FFN kernel's input (then quantized).
        n2 = _norm(hsum, ffn_norm[0], ffn_norm[1], eps).to(torch.bfloat16)
        outs += _quant_rows(n2.float()) if quant else (n2,)
    return outs


def _check_step(h, conv_state, ssm_state, w, ffn_norm, ssm_out, proj_dtype):
    """Raise unless the step's tensors are what its kernel takes; returns
    (B, D, C, K, R, H, N)."""
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
    projections = {"inx_w": (d, c), "inz_w": (d, c), "xparam_w": (c, r + 2 * c),
                   "out_w": (c, d)}
    shapes = {"norm_w": (d,), "norm_b": (d,), "conv_w": (c, k), "conv_b": (c,),
              "dt_w": (r, heads), "dt_b": (heads,), "a_log": (heads, n), "d_skip": (c,)}
    for name, shape in {**shapes, **projections}.items():
        t = getattr(w, name)
        if t is not None:
            _build.check_tensor(t, shape, (proj_dtype,) if name in projections else bf16,
                                name, dev)
    if proj_dtype == torch.int8:
        for name, shape in projections.items():
            _build.check_tensor(getattr(w, name[:-2] + "_s"), (1, shape[1]),
                                (torch.float32,), name[:-2] + "_s", dev)
        if d % 4 or c % 4:
            raise ValueError("ssm_decode_step: int8 layout needs D, C multiples of 4")
    if ffn_norm is not None:
        if (ffn_norm[1] is None) != rms:
            raise ValueError("ssm_decode_step: both norms must be of one kind")
        _build.check_tensor(ffn_norm[0], (d,), bf16, "ffn_norm weight", dev)
        if ffn_norm[1] is not None:
            _build.check_tensor(ffn_norm[1], (d,), bf16, "ffn_norm bias", dev)
    if bsz == 0 or heads * n != c:
        raise ValueError(f"ssm_decode_step: unsupported shape B={bsz} C={c} H={heads}")
    return bsz, d, c, k, r, heads, n


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    contiguous, and one norm kind for both norms. Int8 projection weights
    go to :func:`ssm_decode_step_int8`.
    """
    if h.device.type == "cpu":
        return ssm_decode_step_reference(h, conv_state, ssm_state, w, eps, ffn_norm,
                                         ssm_out)
    if w.quantized:
        return ssm_decode_step_int8(h, conv_state, ssm_state, w, eps, ffn_norm, ssm_out)
    bsz, d, c, k, r, heads, n = _check_step(h, conv_state, ssm_state, w, ffn_norm,
                                            ssm_out, torch.bfloat16)
    dev = h.device
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

    fn_w, fn_b = ffn_norm if ffn_norm is not None else (None, None)
    err = _build.load_library().apertis_ssm_decode_step(
        _ptr(h), _ptr(conv_state), _ptr(ssm_state), _ptr(w.norm_w), _ptr(w.norm_b),
        _ptr(w.inx_w), _ptr(w.inz_w), _ptr(w.conv_w), _ptr(w.conv_b), _ptr(w.xparam_w),
        _ptr(w.dt_w), _ptr(w.dt_b), _ptr(w.a_log), _ptr(w.d_skip), _ptr(w.out_w),
        _ptr(fn_w), _ptr(fn_b), _ptr(h_out), _ptr(xp_out), _ptr(ssm_out), _ptr(ffn_in),
        _ptr(z), _ptr(g), _ptr(hsum), _ptr(tickets), bsz, d, c, k, r, heads, n,
        int(w.norm_b is None), float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssm_decode_step")
    ssm_decode_step.launches += 1
    outs = (h_out, xp_out, ssm_out)
    return outs + (ffn_in,) if ffn_in is not None else outs


def ssm_decode_step_int8(
    h: torch.Tensor,
    conv_state: torch.Tensor,
    ssm_state: torch.Tensor,
    w: MixerWeights,
    eps: float,
    ffn_norm: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    ssm_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The step with the int8 weight layout (``csrc/ssm_step.cu``,
    ``apertis_ssm_decode_step_int8``): int8 projections with (1, out) f32
    scales, D and C multiples of 4, the rest as :func:`ssm_decode_step`.
    With ``ffn_norm`` it returns the FFN input as ``(x_q, x_s)``."""
    if h.device.type == "cpu":
        return ssm_decode_step_reference(h, conv_state, ssm_state, w, eps, ffn_norm,
                                         ssm_out)
    bsz, d, c, k, r, heads, n = _check_step(h, conv_state, ssm_state, w, ffn_norm,
                                            ssm_out, torch.int8)
    dev = h.device
    h_out = torch.empty_like(h)
    xp_out = torch.empty((bsz, c), dtype=conv_state.dtype, device=dev)
    if ssm_out is None:
        ssm_out = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    z = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    g = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    tickets = torch.empty((-(-bsz // _ROWS),), dtype=torch.int32, device=dev)
    x_q = x_s = hsum = None
    if ffn_norm is not None:
        x_q = torch.empty((bsz, d), dtype=torch.int8, device=dev)
        x_s = torch.empty((bsz, 1), dtype=torch.float32, device=dev)
        hsum = torch.empty((bsz, d), dtype=torch.float32, device=dev)

    fn_w, fn_b = ffn_norm if ffn_norm is not None else (None, None)
    err = _build.load_library().apertis_ssm_decode_step_int8(
        _ptr(h), _ptr(conv_state), _ptr(ssm_state), _ptr(w.norm_w), _ptr(w.norm_b),
        _ptr(w.inx_w), _ptr(w.inx_s), _ptr(w.inz_w), _ptr(w.inz_s), _ptr(w.conv_w),
        _ptr(w.conv_b), _ptr(w.xparam_w), _ptr(w.xparam_s), _ptr(w.dt_w), _ptr(w.dt_b),
        _ptr(w.a_log), _ptr(w.d_skip), _ptr(w.out_w), _ptr(w.out_s), _ptr(fn_w),
        _ptr(fn_b), _ptr(h_out), _ptr(xp_out), _ptr(ssm_out), _ptr(x_q), _ptr(x_s),
        _ptr(z), _ptr(g), _ptr(hsum), _ptr(tickets), bsz, d, c, k, r, heads, n,
        int(w.norm_b is None), float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssm_decode_step_int8")
    ssm_decode_step_int8.launches += 1
    outs = (h_out, xp_out, ssm_out)
    return outs + (x_q, x_s) if x_q is not None else outs


ssm_decode_step.launches = 0
ssm_decode_step_int8.launches = 0
