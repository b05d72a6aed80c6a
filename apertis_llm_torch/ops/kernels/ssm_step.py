"""One decode step of the whole selective-SSM mixer.

``ssm_decode_step`` launches the CUDA kernel in ``csrc/ssm_step.cu`` for
CUDA tensors and runs :func:`ssm_decode_step_reference`, its plain PyTorch
version, for CPU tensors.
It replaces ``apertis_llm_tpu/ops/pallas/ssm_step.py::ssm_decode_step_fused``
with ``ffn_mode`` "none", "dense" (``ffn_norm`` given) or "moe" (``ffn_norm``
and ``router`` given) in both weight layouts, picked from the weights' dtype
as the TPU kernel picks it from the pack: bf16, or int8 with
per-output-channel scales (launched and counted by
:func:`ssm_decode_step_int8`). Both layouts run row kernels that compute
each product's input rows once (quantized in the int8 layout, rounded to
bf16 in the bf16 one) and three swapped-operand ``wgmma`` products on
Hopper that stream them beside the weights (int8 products, or bf16 rows
against the bf16 weight), on the plans of
``ops/kernels/decode_plan.py::ssm_step_plan`` and ``bf16_step_plan``. The
"moe" epilogue emits the int8 expert input ``(x_q, x_s)`` and the router's
top-2 combine weights in both layouts. The semantics are the fused kernel's,
not those of the unfused ``models/apertis.py::_ssm_decode_step``: the two
round through bf16 at different points.

A step whose tensors are not all bf16 (f32 projections, or int8 ones beside
f32 rows and norms, as an f32 tree and its int8 quantization hold them;
:func:`hopper_layout`) runs the f32 form (:func:`ssm_decode_step_f32`,
:func:`ssm_decode_step_int8_f32`), as the TPU kernel takes any dtype: f32
row kernels in the same stages and the same three Hopper products, int8 on
the int8 step's plan or f32 in split TF32 on the tensor cores
(``decode_plan.py::f32_step_plan``).

The weights are one layer's tensors as the model holds them, in the (in, out)
layout, so no weight pack is built: the x_param projection and its scales
are cut into their dt / B / C column ranges by pointer offset, the conv taps
are read in their (C, K) layout and ``-exp(A_log)`` is computed in the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build, decode_plan
from apertis_llm_torch.ops.kernels.flash_attention import RESOURCE_KEYS
from apertis_llm_torch.ops.moe import _combine_weights, route
from apertis_llm_torch.ops.norms import layer_norm, rms_norm
from apertis_llm_torch.ops.quant import int_mm

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


class RouterWeights(NamedTuple):
    """One layer's MoE router: its LayerNorm and its (D, E) linear."""
    ln_w: torch.Tensor    # (D,)
    ln_b: torch.Tensor    # (D,)
    w: torch.Tensor       # (D, E)
    b: torch.Tensor       # (E,)


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


def _moe_epilogue(n2: torch.Tensor, router: RouterWeights, eps: float):
    """The expert input and combine weights from the FFN input n2 (f32,
    bf16-rounded), ssm_step.py:198-231: ``x - mean`` quantized per row by
    this kernel's formula with ``rsqrt(var + eps)`` folded into the scale,
    and the eval-mode top-2 routing of n2 (``ops/moe.py::route``: the same
    LayerNorm, logits, softmax, top-2 and renormalisation)."""
    mean = n2.mean(dim=-1, keepdim=True)
    cen = n2 - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    inv = torch.where(var > 0, torch.rsqrt(var + eps), torch.zeros_like(var))
    x_q, scale = _quant_rows(cen)
    routing = route(n2, *router, 2, layer_norm_eps=eps)
    return x_q, scale * inv, _combine_weights(routing, router.w.shape[-1], torch.float32)


def ssm_decode_step_reference(
    h: torch.Tensor,            # (B, D) residual stream
    conv_state: torch.Tensor,   # (B, K-1, C) carried conv window
    ssm_state: torch.Tensor,    # (B, C) float32
    w: MixerWeights,
    eps: float,
    ffn_norm: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    ssm_out: Optional[torch.Tensor] = None,
    router: Optional[RouterWeights] = None,
) -> Tuple[torch.Tensor, ...]:
    """Returns ``(h + mixer_out, new_x_proj, new_ssm_state)`` and, with
    ``ffn_norm``, the FFN input ``ffn_pre_norm(h + mixer_out)`` rounded
    through bf16: as it is in the bf16 layout, quantized per row
    ``(x_q int8 (B, D), x_s f32 (B, 1))`` in the int8 layout. With
    ``router`` as well (the moe epilogue, both layouts) it returns the
    expert input ``(x_q, x_s)`` and the (B, E) f32 combine weights instead.
    With ``ssm_out`` (which may be ``ssm_state``) the new state is written
    there and returned."""
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
        if router is not None:
            outs += _moe_epilogue(n2.float(), router, eps)
        else:
            outs += _quant_rows(n2.float()) if quant else (n2,)
    return outs


def _check_step(h, conv_state, ssm_state, w, ffn_norm, ssm_out, proj_dtype, router,
                row_dtypes=(torch.bfloat16,), param_dtypes=(torch.bfloat16,)):
    """Raise unless the step's tensors are what its kernel takes: h and the
    conv cache of ``row_dtypes``, the projections of ``proj_dtype``, the
    other weights of ``param_dtypes``; returns (B, D, C, K, R, H, N)."""
    bf16 = param_dtypes
    bsz, d = h.shape
    c = w.inx_w.shape[1]
    k = w.conv_w.shape[1]
    r, heads = w.dt_w.shape
    n = c // max(heads, 1)
    rms = w.norm_b is None
    dev = h.device
    _build.check_tensor(h, (bsz, d), row_dtypes, "h", dev)
    _build.check_tensor(conv_state, (bsz, k - 1, c), row_dtypes, "conv_state", dev)
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
    if ffn_norm is not None:
        if (ffn_norm[1] is None) != rms:
            raise ValueError("ssm_decode_step: both norms must be of one kind")
        _build.check_tensor(ffn_norm[0], (d,), bf16, "ffn_norm weight", dev)
        if ffn_norm[1] is not None:
            _build.check_tensor(ffn_norm[1], (d,), bf16, "ffn_norm bias", dev)
    if router is not None:
        if ffn_norm is None:
            raise ValueError("ssm_decode_step: the moe epilogue needs ffn_norm")
        e = router.w.shape[-1]
        for name, t, shape in (("router ln_w", router.ln_w, (d,)), ("router ln_b", router.ln_b, (d,)),
                               ("router w", router.w, (d, e)), ("router b", router.b, (e,))):
            _build.check_tensor(t, shape, bf16, name, dev)
        if e < 2:
            raise ValueError(f"ssm_decode_step: the moe epilogue takes 2 or more experts, got {e}")
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
    router: Optional[RouterWeights] = None,
) -> Tuple[torch.Tensor, ...]:
    """One mixer decode step: kernel on CUDA tensors, plain version on CPU.

    The kernel takes bf16 ``h``, ``conv_state`` and weights, an f32
    ``ssm_state`` (and ``ssm_out``, which may be the same tensor), all
    contiguous, at any D and C (as the TPU kernel, which pads only rows),
    and one norm kind for both norms; ``router`` (bf16, any number of
    experts from 2) selects the moe epilogue. Int8
    projection weights go to :func:`ssm_decode_step_int8`; a step whose
    tensors are not all bf16 (:func:`hopper_layout`), to the f32 forms
    :func:`ssm_decode_step_f32` and :func:`ssm_decode_step_int8_f32`.
    """
    if h.device.type == "cpu":
        return ssm_decode_step_reference(h, conv_state, ssm_state, w, eps, ffn_norm,
                                         ssm_out, router)
    if not hopper_layout(h, conv_state, w, ffn_norm, router):
        step = ssm_decode_step_int8_f32 if w.quantized else ssm_decode_step_f32
        return step(h, conv_state, ssm_state, w, eps, ffn_norm, ssm_out, router)
    if w.quantized:
        return ssm_decode_step_int8(h, conv_state, ssm_state, w, eps, ffn_norm, ssm_out,
                                    router)
    err, outs = _launch_step("apertis_ssm_decode_step", h, conv_state, ssm_state, w, eps,
                             ffn_norm, ssm_out, router)
    _build.check(err, "ssm_decode_step")
    ssm_decode_step.launches += 1
    return outs


def _router_ptrs(router):
    return (None,) * 4 if router is None else tuple(_ptr(t) for t in router)


def _num_experts(router) -> int:
    return 0 if router is None else router.w.shape[-1]


def _step_buffers(h, conv_state, dims, ffn_norm, ssm_out, router, quant):
    """The outputs of one step, in the C entry points' order: h_out, xp_out,
    ssm_out, ffn_in, ffn_scale, comb (None where the mode has none). ffn_in
    is bf16 in the bf16 layout's dense epilogue and int8 otherwise."""
    bsz, d, c = dims[:3]
    dev = h.device
    ffn_in = ffn_scale = comb = None
    if ffn_norm is not None:
        quant_in = router is not None or quant
        ffn_in = torch.empty((bsz, d), dtype=torch.int8 if quant_in else torch.bfloat16,
                             device=dev)
        if quant_in:
            ffn_scale = torch.empty((bsz, 1), dtype=torch.float32, device=dev)
        if router is not None:
            comb = torch.empty((bsz, router.w.shape[-1]), dtype=torch.float32, device=dev)
    if ssm_out is None:
        ssm_out = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    return (torch.empty_like(h), torch.empty((bsz, c), dtype=conv_state.dtype, device=dev),
            ssm_out, ffn_in, ffn_scale, comb)


def _step_outputs(bufs):
    return tuple(t for t in bufs[:6] if t is not None)


@functools.lru_cache(maxsize=None)
def _scratch_bytes(batch: int, d: int, c: int, r: int, int8: bool) -> int:
    """The bytes of a step's scratch (``csrc/ssm_step.cu::StepScratch``)."""
    return _build.load_library().apertis_ssm_step_scratch(batch, d, c, r, int(int8))


def step_plan(h: torch.Tensor, w: MixerWeights, f32_form: bool = False) -> decode_plan.StepPlan:
    """The plan of the step in w's layout for these rows on h's card; with
    ``f32_form``, the f32 form's (float projections: bf16 ones as the bf16
    layout's, f32 ones in split TF32)."""
    dims = (h.shape[0], h.shape[1], w.inx_w.shape[1], w.dt_w.shape[0],
            _build.sm_count(h.device.index or 0))
    if w.quantized:
        return decode_plan.ssm_step_plan(*dims)
    if f32_form:
        return decode_plan.f32_step_plan(*dims, tf32=w.inx_w.dtype == torch.float32)
    return decode_plan.bf16_step_plan(*dims)


def ssm_step_resources(kernel: str, plan: decode_plan.GemmPlan, int8: bool,
                       tf32: bool = False) -> Dict[str, int]:
    """What the card gives the step's product ``kernel`` ("in", "mix" or
    "out") of the int8 or the bf16 layout, or the f32 form's split TF32
    (``tf32``), at its plan: registers a thread, shared memory a block in
    bytes, resident blocks an SM, threads a block and spilled bytes a
    thread."""
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = _build.load_library().apertis_ssm_step_resources(
        ("in", "mix", "out").index(kernel) + (6 if tf32 else 0 if int8 else 3), plan.rows,
        plan.smem, ctypes.addressof(out))
    _build.check(err, "ssm_step_resources")
    return dict(zip(RESOURCE_KEYS, out))


def _launch_step(entry, h, conv_state, ssm_state, w, eps, ffn_norm, ssm_out, router):
    """Check the step's tensors, allocate its outputs and scratch and launch
    ``entry`` on its plan; returns (the error, the outputs)."""
    int8 = w.quantized
    dims = _check_step(h, conv_state, ssm_state, w, ffn_norm, ssm_out,
                       torch.int8 if int8 else torch.bfloat16, router)
    bsz, d, c, _, r = dims[:5]
    outs = _step_buffers(h, conv_state, dims, ffn_norm, ssm_out, router, int8)
    scratch = torch.empty((_scratch_bytes(bsz, d, c, r, int8),), dtype=torch.int8,
                          device=h.device)
    plan = step_plan(h, w)
    splits = (ctypes.c_int * 3)(*(p.split for p in plan))
    stages = (ctypes.c_int * 3)(*(p.stages for p in plan))
    fn_w, fn_b = ffn_norm if ffn_norm is not None else (None, None)
    weights = ((w.inx_w, w.inx_s, w.inz_w, w.inz_s, w.conv_w, w.conv_b, w.xparam_w,
                w.xparam_s, w.dt_w, w.dt_b, w.a_log, w.d_skip, w.out_w, w.out_s) if int8 else
               (w.inx_w, w.inz_w, w.conv_w, w.conv_b, w.xparam_w, w.dt_w, w.dt_b, w.a_log,
                w.d_skip, w.out_w))
    err = getattr(_build.load_library(), entry)(
        _ptr(h), _ptr(conv_state), _ptr(ssm_state), _ptr(w.norm_w), _ptr(w.norm_b),
        *(_ptr(t) for t in weights), _ptr(fn_w), _ptr(fn_b), *_router_ptrs(router),
        *(_ptr(t) for t in outs), _ptr(scratch), *dims, _num_experts(router),
        int(w.norm_b is None), float(eps), plan.inp.rows, ctypes.addressof(splits),
        ctypes.addressof(stages), torch.cuda.current_stream(h.device).cuda_stream)
    return err, _step_outputs(outs)


def ssm_decode_step_int8(
    h: torch.Tensor,
    conv_state: torch.Tensor,
    ssm_state: torch.Tensor,
    w: MixerWeights,
    eps: float,
    ffn_norm: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    ssm_out: Optional[torch.Tensor] = None,
    router: Optional[RouterWeights] = None,
) -> Tuple[torch.Tensor, ...]:
    """The step with the int8 weight layout (``csrc/ssm_step.cu``,
    ``apertis_ssm_decode_step_int8``): int8 projections with (1, out) f32
    scales, the rest as :func:`ssm_decode_step`.
    With ``ffn_norm`` it returns the FFN input as ``(x_q, x_s)``, and with
    ``router`` the combine weights after it."""
    if h.device.type == "cpu":
        return ssm_decode_step_reference(h, conv_state, ssm_state, w, eps, ffn_norm,
                                         ssm_out, router)
    err, outs = _launch_step("apertis_ssm_decode_step_int8", h, conv_state, ssm_state, w, eps,
                             ffn_norm, ssm_out, router)
    _build.check(err, "ssm_decode_step_int8")
    ssm_decode_step_int8.launches += 1
    return outs


def _float_tensors(w: MixerWeights, ffn_norm, router):
    """The step's float weights other than the projections."""
    small = [w.norm_w, w.norm_b, w.conv_w, w.conv_b, w.dt_w, w.dt_b, w.a_log, w.d_skip]
    if ffn_norm is not None:
        small += list(ffn_norm)
    if router is not None:
        small += list(router)
    return [t for t in small if t is not None]


def hopper_layout(h, conv_state, w: MixerWeights, ffn_norm=None, router=None) -> bool:
    """Whether the Hopper layouts take the step: h, the conv cache and every
    float weight in bf16 (the projections bf16 or int8). Any other step
    runs the f32 forms."""
    floats = [h, conv_state, *_float_tensors(w, ffn_norm, router)]
    if not w.quantized:
        floats += [w.inx_w, w.inz_w, w.xparam_w, w.out_w]
    return all(t.dtype == torch.bfloat16 for t in floats)


_FLOAT = (torch.float32, torch.bfloat16)


def _launch_f32(h, conv_state, ssm_state, w, eps, ffn_norm, ssm_out, router):
    """Check the f32 form's tensors, allocate its outputs and scratch and
    launch ``apertis_ssm_decode_step_f32``; returns the outputs."""
    dev = h.device
    quant = w.quantized
    pdt = w.norm_w.dtype
    for t in _float_tensors(w, ffn_norm, router):
        if t.dtype != pdt:
            raise ValueError("ssm_decode_step_f32: the norms, conv, dt_proj, A_log, D and "
                             f"router weights must share one dtype, got {t.dtype} and {pdt}")
    proj = (w.inx_w, w.inz_w, w.xparam_w, w.out_w)
    wdt = torch.int8 if quant else w.inx_w.dtype
    if any(t.dtype != wdt for t in proj):
        raise ValueError("ssm_decode_step_f32: the four projections must share one dtype")
    dims = _check_step(h, conv_state, ssm_state, w, ffn_norm, ssm_out, wdt, router,
                       row_dtypes=_FLOAT, param_dtypes=(pdt,))
    bsz, d, c, _, r = dims[:5]
    code = _build.float_code
    codes = (code(h, "h"), code(conv_state, "conv_state"), code(w.norm_w, "norm_w"),
             0 if quant else code(w.inx_w, "inx_w"))
    outs = _step_buffers(h, conv_state, dims, ffn_norm, ssm_out, router, quant)
    scratch = torch.empty((_build.load_library().apertis_ssm_step_f32_scratch(bsz, d, c, r),),
                          dtype=torch.int8, device=dev)
    plan = step_plan(h, w, f32_form=True)
    splits = (ctypes.c_int * 3)(*(p.split for p in plan))
    stages = (ctypes.c_int * 3)(*(p.stages for p in plan))
    fn_w, fn_b = ffn_norm if ffn_norm is not None else (None, None)
    weights = (w.inx_w, w.inx_s, w.inz_w, w.inz_s, w.conv_w, w.conv_b, w.xparam_w, w.xparam_s,
               w.dt_w, w.dt_b, w.a_log, w.d_skip, w.out_w, w.out_s)
    err = _build.load_library().apertis_ssm_decode_step_f32(
        _ptr(h), _ptr(conv_state), _ptr(ssm_state), _ptr(w.norm_w), _ptr(w.norm_b),
        *(_ptr(t) for t in weights), _ptr(fn_w), _ptr(fn_b), *_router_ptrs(router),
        *(_ptr(t) for t in outs), _ptr(scratch), *dims, _num_experts(router),
        int(w.norm_b is None), float(eps), int(quant), *codes, plan.inp.rows,
        ctypes.addressof(splits), ctypes.addressof(stages),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssm_decode_step_f32")
    return _step_outputs(outs)


def ssm_decode_step_f32(
    h: torch.Tensor,
    conv_state: torch.Tensor,
    ssm_state: torch.Tensor,
    w: MixerWeights,
    eps: float,
    ffn_norm: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    ssm_out: Optional[torch.Tensor] = None,
    router: Optional[RouterWeights] = None,
) -> Tuple[torch.Tensor, ...]:
    """The step's f32 form with float projection weights (``csrc/
    ssm_step.cu``, ``apertis_ssm_decode_step_f32``): h, the conv cache, the
    projections and the other weights each f32 or bf16 (the other weights
    of one dtype), the three products on the tensor cores in each weight's
    dtype (f32 weights in split TF32) with f32 sums. The
    outputs are :func:`ssm_decode_step`'s: the dense epilogue's FFN input is
    the bf16-rounded pre-norm, as the TPU kernel writes it in every layout
    (ssm_step.py:186). Plain version on CPU tensors."""
    if h.device.type == "cpu":
        return ssm_decode_step_reference(h, conv_state, ssm_state, w, eps, ffn_norm,
                                         ssm_out, router)
    if w.quantized:
        raise ValueError("ssm_decode_step_f32: int8 projections go to ssm_decode_step_int8_f32")
    outs = _launch_f32(h, conv_state, ssm_state, w, eps, ffn_norm, ssm_out, router)
    ssm_decode_step_f32.launches += 1
    return outs


def ssm_decode_step_int8_f32(
    h: torch.Tensor,
    conv_state: torch.Tensor,
    ssm_state: torch.Tensor,
    w: MixerWeights,
    eps: float,
    ffn_norm: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    ssm_out: Optional[torch.Tensor] = None,
    router: Optional[RouterWeights] = None,
) -> Tuple[torch.Tensor, ...]:
    """The step's f32 form with int8 projection weights and (1, out) f32
    scales, beside f32 (or bf16) rows and weights, as an int8 tree quantized
    from an f32 one holds them (``apertis_ssm_decode_step_f32``): each
    product's input quantized per row, exact int32 sums. Outputs as
    :func:`ssm_decode_step_int8`'s. Plain version on CPU tensors."""
    if h.device.type == "cpu":
        return ssm_decode_step_reference(h, conv_state, ssm_state, w, eps, ffn_norm,
                                         ssm_out, router)
    if not w.quantized:
        raise ValueError("ssm_decode_step_int8_f32: float projections go to "
                         "ssm_decode_step_f32")
    outs = _launch_f32(h, conv_state, ssm_state, w, eps, ffn_norm, ssm_out, router)
    ssm_decode_step_int8_f32.launches += 1
    return outs


ssm_decode_step.launches = 0
ssm_decode_step_int8.launches = 0
ssm_decode_step_f32.launches = 0
ssm_decode_step_int8_f32.launches = 0
