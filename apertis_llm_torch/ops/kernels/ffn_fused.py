"""The dense FFN at decode: ``act(x @ W1 + b1) @ W2 + b2``.

``ffn_decode`` launches the CUDA kernel in ``csrc/ffn_fused.cu`` for CUDA
tensors and runs :func:`ffn_decode_reference`, its plain PyTorch version,
for CPU tensors. It replaces
``apertis_llm_tpu/ops/pallas/ffn_fused.py::ffn_decode_fused`` with the bf16
weight layout: two Hopper launches of swapped-operand bf16 ``wgmma``
products on ``csrc/decode_gemm.cuh`` (the tree's row-major bf16 weight tile,
staged by TMA, is wgmma's MN-major A operand in shared memory), GEMM1
writing the bf16 hidden and GEMM2 streaming it, each splitting K over a
cluster where its column tiles leave SMs idle, on the plan of
``ops/kernels/decode_plan.py::bf16_ffn_plan``. The int8 layout runs through
:func:`ffn_decode_int8` and the int4 layout through :func:`ffn_decode_int4`:
two Hopper launches of swapped-operand int8 ``wgmma`` products
(``csrc/quant_ffn.cuh``) that read each weight once per row tile (GEMM1
with the per-(row, hidden tile) requantization across a thread-block
cluster, then GEMM2 whose K split over a cluster adds the tiles' products in
tile order), on the plan of ``ops/kernels/decode_plan.py::ffn_plan``; the
int4 layout unpacks the nibbles into int8 fragments in registers. Weights,
biases or outputs that are not bf16 (an f32 tree, or its int8 quantization
with f32 biases) take the f32 forms: :func:`ffn_decode_f32`, the same two
products with an f32 weight in split TF32 on the tensor cores (and a bf16
one as the bf16 layout's), on the plan of
``ops/kernels/decode_plan.py::f32_ffn_plan``, and :func:`ffn_decode_int8_f32`,
the int8 layout's two launches with f32 biases and output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from apertis_llm_torch.models.quantize import unpack_int4
from apertis_llm_torch.ops.activations import get_activation
from apertis_llm_torch.ops.kernels import _build, decode_plan
from apertis_llm_torch.ops.kernels.flash_attention import RESOURCE_KEYS
from apertis_llm_torch.ops.quant import int_mm

_ACT_CODES = {"relu": 1, "silu": 2, "swish": 2}   # anything else: exact GELU


def ffn_decode_reference(
    x: torch.Tensor,    # (S, D)
    w1: torch.Tensor,   # (D, I)
    b1: torch.Tensor,   # (I,)
    w2: torch.Tensor,   # (I, D)
    b2: torch.Tensor,   # (D,)
    hidden_act: str = "gelu",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Both products in the weights' dtype with f32 accumulation; the hidden
    is rounded to W2's dtype before the second product."""
    act = get_activation(hidden_act)
    hid = act(x.to(w1.dtype).float() @ w1.float() + b1.float()).to(w2.dtype)
    out = hid.float() @ w2.float() + b2.float()
    return out.to(out_dtype or x.dtype)


def pick_block_n(inter: int) -> int:
    """Hidden tile width of the int8 layout: the largest multiple of 128
    dividing ``inter`` that is at most 1216 (``ffn_fused.py::_pick_block_n``
    at the TPU kernel's default target); 0 when there is none."""
    bn = (min(1216, inter) // 128) * 128
    while bn >= 128:
        if inter % bn == 0:
            return bn
        bn -= 128
    return 0


def ffn_decode_int8_reference(
    x_q: torch.Tensor,   # (S, D) int8
    x_s: torch.Tensor,   # (S, 1) f32
    w1_q: torch.Tensor,  # (D, I) int8
    w1_s: torch.Tensor,  # (1, I) f32
    b1: torch.Tensor,    # (I,)
    w2_q: torch.Tensor,  # (I, D) int8
    w2_s: torch.Tensor,  # (1, D) f32
    b2: torch.Tensor,    # (D,)
    hidden_act: str = "gelu",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The int8 layout of the TPU kernel, step by step (ffn_fused.py:42-99):
    ``h = act(int32(x_q @ W1_q) * x_s * w1_s + b1)``; per (row, hidden tile
    of ``pick_block_n(I)`` columns, as the kernel has it)
    ``hs = max(absmax, 1e-8) * (1/127)`` and ``hq = rint(h / hs)``;
    ``acc += int32(hq @ W2_q[tile]) * hs`` over the tiles in order;
    ``out = acc * w2_s + b2``."""
    bn = pick_block_n(w1_q.shape[1])
    if bn == 0:
        raise ValueError(f"ffn_decode_int8: I={w1_q.shape[1]} has no 128-multiple tile")
    act = get_activation(hidden_act)
    h = act(int_mm(x_q, w1_q).float() * x_s * w1_s.reshape(1, -1) + b1.float())
    acc = torch.zeros((x_q.shape[0], w2_q.shape[1]), dtype=torch.float32, device=x_q.device)
    for t0 in range(0, h.shape[1], bn):
        ht = h[:, t0:t0 + bn]
        hs = torch.clamp(ht.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        hq = torch.clamp(torch.round(ht / hs), -127, 127).to(torch.int8)
        acc = acc + int_mm(hq, w2_q[t0:t0 + bn]).float() * hs
    return (acc * w2_s.reshape(1, -1) + b2.float()).to(out_dtype)


def ffn_decode_int4_reference(
    x_q: torch.Tensor,    # (S, D) int8
    x_s: torch.Tensor,    # (S, 1) f32
    w1_q4: torch.Tensor,  # (D/2, I) int8, two int4 values a byte
    w1_sh: torch.Tensor,  # (D/128, I) int8 shifts
    w1_s: torch.Tensor,   # (1, I) f32
    b1: torch.Tensor,     # (I,)
    w2_q4: torch.Tensor,  # (I/2, D)
    w2_sh: torch.Tensor,  # (I/128, D)
    w2_s: torch.Tensor,   # (1, D) f32
    b2: torch.Tensor,     # (D,)
    hidden_act: str = "gelu",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The int4 layout of the TPU kernel (``int4=True``): the int8 layout's
    arithmetic over the unpacked weights, whose values are the nibbles times
    their group's shift (``models/quantize.py::unpack_int4``)."""
    return ffn_decode_int8_reference(x_q, x_s, unpack_int4(w1_q4, w1_sh), w1_s, b1,
                                     unpack_int4(w2_q4, w2_sh), w2_s, b2, hidden_act, out_dtype)


def ffn_decode(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    hidden_act: str = "gelu",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The decode FFN: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes contiguous bf16 ``x`` (S, D) and weights, with D and I
    multiples of 16 and every tensor 16-byte aligned, and returns bf16; any
    other dtype goes to the f32 form :func:`ffn_decode_f32`.
    """
    if x.device.type == "cpu":
        return ffn_decode_reference(x, w1, b1, w2, b2, hidden_act, out_dtype)
    if (out_dtype or x.dtype) != torch.bfloat16 or any(
            t.dtype != torch.bfloat16 for t in (x, w1, b1, w2, b2)):
        return ffn_decode_f32(x, w1, b1, w2, b2, hidden_act, out_dtype)
    bf16 = (torch.bfloat16,)
    s, d = x.shape
    inter = w1.shape[1]
    dev = x.device
    _build.check_tensor(x, (s, d), bf16, "x", dev)
    _build.check_tensor(w1, (d, inter), bf16, "w1", dev)
    _build.check_tensor(b1, (inter,), bf16, "b1", dev)
    _build.check_tensor(w2, (inter, d), bf16, "w2", dev)
    _build.check_tensor(b2, (d,), bf16, "b2", dev)
    if (out_dtype or x.dtype) != torch.bfloat16:
        raise ValueError(f"ffn_decode: out_dtype {out_dtype} not supported")
    if s == 0 or d == 0 or inter == 0 or d % 16 or inter % 16:
        raise ValueError(f"ffn_decode: unsupported shape S={s} D={d} I={inter}")
    _build.check_aligned("ffn_decode", x, w1, w2)
    plan = bf16_plan(x, d, inter)
    hidden = torch.empty((s, inter), dtype=torch.bfloat16, device=dev)
    out = torch.empty((s, d), dtype=torch.bfloat16, device=dev)
    err = _build.load_library().apertis_ffn_decode(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), hidden.data_ptr(), s, d, inter, _ACT_CODES.get(hidden_act, 0),
        plan.up.rows, plan.up.split, plan.down.split, plan.up.stages, plan.down.stages,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn_decode")
    ffn_decode.launches += 1
    return out


def bf16_plan(x: torch.Tensor, d: int, inter: int) -> decode_plan.FfnPlan:
    """The plan of the bf16 FFN for these rows on their card."""
    return decode_plan.bf16_ffn_plan(x.shape[0], d, inter,
                                     _build.sm_count(x.device.index or 0))


def quant_plan(x_q: torch.Tensor, d: int, inter: int, bits: int) -> decode_plan.FfnPlan:
    """The plan of the int8 (bits 8) or int4 FFN for these rows on their card."""
    s = x_q.shape[0]
    return decode_plan.ffn_plan(s, d, inter, pick_block_n(inter), bits,
                                _build.sm_count(x_q.device.index or 0))


def _quant_scratch(x_q: torch.Tensor, inter: int, d: int):
    """GEMM1's outputs, GEMM2's inputs: hq (S, I) int8 and hs (S, I / bn)
    f32; and the (S, D) bf16 output."""
    s, dev = x_q.shape[0], x_q.device
    return (torch.empty((s, inter), dtype=torch.int8, device=dev),
            torch.empty((s, inter // pick_block_n(inter)), dtype=torch.float32, device=dev),
            torch.empty((s, d), dtype=torch.bfloat16, device=dev))


def _plan_args(plan: decode_plan.FfnPlan) -> tuple:
    """The plan as the C entry points take it."""
    return plan.up.rows, plan.down.split, plan.up.stages, plan.down.stages


# The kernels of ffn_quant_resources: (bits, kernel) -> the C entry's code;
# bits 32 are the f32 form's split-TF32 products ("up" on f32 rows, "up_bf16"
# on bf16 rows).
_RESOURCE_CODES = {(8, "up"): 0, (8, "down"): 1, (4, "up"): 2, (4, "down"): 3, (16, "up"): 4,
                   (16, "down"): 5, (32, "up"): 6, (32, "up_bf16"): 7, (32, "down"): 8}


def ffn_quant_resources(bits: int, kernel: str, plan: decode_plan.GemmPlan) -> Dict[str, int]:
    """What the card gives the int8 (``bits`` 8), int4 (4), bf16 (16) or
    split-TF32 (32) FFN's ``kernel`` ("up", "down"; "up_bf16" for split TF32
    on bf16 rows) at its plan: registers a thread, shared memory a block in
    bytes, resident blocks an SM, threads a block and spilled bytes a
    thread."""
    code = _RESOURCE_CODES[(bits, kernel)]
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = _build.load_library().apertis_ffn_quant_resources(code, plan.rows, plan.smem,
                                                            ctypes.addressof(out))
    _build.check(err, "ffn_quant_resources")
    return dict(zip(RESOURCE_KEYS, out))


def ffn_decode_int8(
    x_q: torch.Tensor,
    x_s: torch.Tensor,
    w1_q: torch.Tensor,
    w1_s: torch.Tensor,
    b1: torch.Tensor,
    w2_q: torch.Tensor,
    w2_s: torch.Tensor,
    b2: torch.Tensor,
    hidden_act: str = "gelu",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The int8 decode FFN: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes contiguous, 16-byte aligned int8 ``x_q`` (S, D) and
    weights, f32 scales ``x_s`` (S, 1), ``w1_s`` (1, I), ``w2_s`` (1, D),
    bf16 biases, D a multiple of 16 and I a multiple of 128, and returns
    bf16; f32 biases or output go to the f32 form :func:`ffn_decode_int8_f32`.
    """
    if x_q.device.type == "cpu":
        return ffn_decode_int8_reference(x_q, x_s, w1_q, w1_s, b1, w2_q, w2_s, b2,
                                         hidden_act, out_dtype)
    if out_dtype != torch.bfloat16 or any(t.dtype != torch.bfloat16 for t in (b1, b2)):
        return ffn_decode_int8_f32(x_q, x_s, w1_q, w1_s, b1, w2_q, w2_s, b2, hidden_act,
                                   out_dtype)
    s, d = x_q.shape
    inter = w1_q.shape[1]
    dev = x_q.device
    i8, f32, bf16 = (torch.int8,), (torch.float32,), (torch.bfloat16,)
    _build.check_tensor(x_q, (s, d), i8, "x_q", dev)
    _build.check_tensor(x_s, (s, 1), f32, "x_s", dev)
    _build.check_tensor(w1_q, (d, inter), i8, "w1_q", dev)
    _build.check_tensor(w1_s, (1, inter), f32, "w1_s", dev)
    _build.check_tensor(b1, (inter,), bf16, "b1", dev)
    _build.check_tensor(w2_q, (inter, d), i8, "w2_q", dev)
    _build.check_tensor(w2_s, (1, d), f32, "w2_s", dev)
    _build.check_tensor(b2, (d,), bf16, "b2", dev)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"ffn_decode_int8: out_dtype {out_dtype} not supported")
    if s == 0 or d == 0 or d % 16 or pick_block_n(inter) == 0:
        raise ValueError(f"ffn_decode_int8: unsupported shape S={s} D={d} I={inter}")
    _build.check_aligned("ffn_decode_int8", x_q, w1_q, w2_q)
    hq, hs, out = _quant_scratch(x_q, inter, d)
    err = _build.load_library().apertis_ffn_decode_int8(
        x_q.data_ptr(), x_s.data_ptr(), w1_q.data_ptr(), w1_s.data_ptr(), b1.data_ptr(),
        w2_q.data_ptr(), w2_s.data_ptr(), b2.data_ptr(), out.data_ptr(), hq.data_ptr(),
        hs.data_ptr(), s, d, inter, pick_block_n(inter), _ACT_CODES.get(hidden_act, 0),
        *_plan_args(quant_plan(x_q, d, inter, 8)), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn_decode_int8")
    ffn_decode_int8.launches += 1
    return out


def ffn_decode_int4(
    x_q: torch.Tensor,
    x_s: torch.Tensor,
    w1_q4: torch.Tensor,
    w1_sh: torch.Tensor,
    w1_s: torch.Tensor,
    b1: torch.Tensor,
    w2_q4: torch.Tensor,
    w2_sh: torch.Tensor,
    w2_s: torch.Tensor,
    b2: torch.Tensor,
    hidden_act: str = "gelu",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The int4 decode FFN: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes contiguous, 16-byte aligned int8 ``x_q`` (S, D), the
    packs and shifts of ``models/quantize.py::quantize_weight_int4`` (shifts
    1, 2, 4 or 8), f32 scales, bf16 biases, D and I multiples of 128, and
    returns bf16.
    """
    if x_q.device.type == "cpu":
        return ffn_decode_int4_reference(x_q, x_s, w1_q4, w1_sh, w1_s, b1, w2_q4, w2_sh,
                                         w2_s, b2, hidden_act, out_dtype)
    s, d = x_q.shape
    inter = w1_q4.shape[1]
    dev = x_q.device
    i8, f32, bf16 = (torch.int8,), (torch.float32,), (torch.bfloat16,)
    if s == 0 or d % 128 or inter % 128:
        raise ValueError(f"ffn_decode_int4: unsupported shape S={s} D={d} I={inter}")
    _build.check_tensor(x_q, (s, d), i8, "x_q", dev)
    _build.check_tensor(x_s, (s, 1), f32, "x_s", dev)
    _build.check_tensor(w1_q4, (d // 2, inter), i8, "w1_q4", dev)
    _build.check_tensor(w1_sh, (d // 128, inter), i8, "w1_sh", dev)
    _build.check_tensor(w1_s, (1, inter), f32, "w1_s", dev)
    _build.check_tensor(b1, (inter,), bf16, "b1", dev)
    _build.check_tensor(w2_q4, (inter // 2, d), i8, "w2_q4", dev)
    _build.check_tensor(w2_sh, (inter // 128, d), i8, "w2_sh", dev)
    _build.check_tensor(w2_s, (1, d), f32, "w2_s", dev)
    _build.check_tensor(b2, (d,), bf16, "b2", dev)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"ffn_decode_int4: out_dtype {out_dtype} not supported")
    _build.check_aligned("ffn_decode_int4", x_q, w1_q4, w1_sh, w2_q4, w2_sh)
    hq, hs, out = _quant_scratch(x_q, inter, d)
    err = _build.load_library().apertis_ffn_decode_int4(
        x_q.data_ptr(), x_s.data_ptr(), w1_q4.data_ptr(), w1_sh.data_ptr(), w1_s.data_ptr(),
        b1.data_ptr(), w2_q4.data_ptr(), w2_sh.data_ptr(), w2_s.data_ptr(), b2.data_ptr(),
        out.data_ptr(), hq.data_ptr(), hs.data_ptr(), s, d, inter, pick_block_n(inter),
        _ACT_CODES.get(hidden_act, 0), *_plan_args(quant_plan(x_q, d, inter, 4)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn_decode_int4")
    ffn_decode_int4.launches += 1
    return out


_FLOAT = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _f32_scratch_bytes(s: int, d: int, inter: int, xbf: int, w1bf: int, w2bf: int) -> int:
    """The bytes of the f32 form's scratch (``csrc/ffn_fused.cu::FloatScratch``)."""
    return _build.load_library().apertis_ffn_f32_scratch(s, d, inter, xbf, w1bf, w2bf)


def f32_plan(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> decode_plan.FfnPlan:
    """The plan of the f32 form for these rows and weights on their card."""
    return decode_plan.f32_ffn_plan(x.shape[0], w1.shape[0], w1.shape[1],
                                    w1.dtype == torch.float32, w2.dtype == torch.float32,
                                    x.dtype != torch.bfloat16,
                                    _build.sm_count(x.device.index or 0))


def ffn_decode_f32(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    hidden_act: str = "gelu",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The decode FFN's f32 form (``csrc/ffn_fused.cu``,
    ``apertis_ffn_decode_f32``): contiguous, 16-byte aligned ``x``, weights,
    biases and output each f32 or bf16, D and I multiples of 4 (of 16 where
    both weights are bf16); each product on the tensor cores in its weight's
    dtype (an f32 weight in split TF32) with f32 sums, the hidden rounded to
    W2's dtype, as :func:`ffn_decode_reference`. Plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return ffn_decode_reference(x, w1, b1, w2, b2, hidden_act, out_dtype)
    s, d = x.shape
    inter = w1.shape[1]
    dev = x.device
    out_dtype = out_dtype or x.dtype
    for t, shape, name in ((x, (s, d), "x"), (w1, (d, inter), "w1"), (b1, (inter,), "b1"),
                           (w2, (inter, d), "w2"), (b2, (d,), "b2")):
        _build.check_tensor(t, shape, _FLOAT, name, dev)
    align = 16 if w1.dtype == w2.dtype == torch.bfloat16 else 4
    if s == 0 or d == 0 or inter == 0 or d % align or inter % align:
        raise ValueError(f"ffn_decode_f32: unsupported shape S={s} D={d} I={inter}")
    _build.check_aligned("ffn_decode_f32", x, w1, w2)
    plan = f32_plan(x, w1, w2)
    codes = tuple(_build.float_code(t, n) for t, n in ((x, "x"), (w1, "w1"), (w2, "w2")))
    scratch = torch.empty((_f32_scratch_bytes(s, d, inter, *codes),), dtype=torch.int8,
                          device=dev)
    out = torch.empty((s, d), dtype=out_dtype, device=dev)
    err = _build.load_library().apertis_ffn_decode_f32(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), s, d, inter, _ACT_CODES.get(hidden_act, 0),
        *(_build.float_code(t, n) for t, n in ((x, "x"), (w1, "w1"), (b1, "b1"), (w2, "w2"),
                                                (b2, "b2"), (out, "out_dtype"))),
        plan.up.rows, plan.up.split, plan.down.split, plan.up.stages, plan.down.stages,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn_decode_f32")
    ffn_decode_f32.launches += 1
    return out


def ffn_decode_int8_f32(
    x_q: torch.Tensor,
    x_s: torch.Tensor,
    w1_q: torch.Tensor,
    w1_s: torch.Tensor,
    b1: torch.Tensor,
    w2_q: torch.Tensor,
    w2_s: torch.Tensor,
    b2: torch.Tensor,
    hidden_act: str = "gelu",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The int8 decode FFN's f32 form (``apertis_ffn_decode_int8_f32``): the
    int8 layout's two launches and plan (:func:`ffn_decode_int8`'s shapes)
    with biases and output each f32 or bf16, as an int8 tree quantized from
    an f32 one serves it; the arithmetic of
    :func:`ffn_decode_int8_reference`. Plain version on CPU tensors."""
    if x_q.device.type == "cpu":
        return ffn_decode_int8_reference(x_q, x_s, w1_q, w1_s, b1, w2_q, w2_s, b2,
                                         hidden_act, out_dtype)
    s, d = x_q.shape
    inter = w1_q.shape[1]
    dev = x_q.device
    i8, f32 = (torch.int8,), (torch.float32,)
    _build.check_tensor(x_q, (s, d), i8, "x_q", dev)
    _build.check_tensor(x_s, (s, 1), f32, "x_s", dev)
    _build.check_tensor(w1_q, (d, inter), i8, "w1_q", dev)
    _build.check_tensor(w1_s, (1, inter), f32, "w1_s", dev)
    _build.check_tensor(b1, (inter,), _FLOAT, "b1", dev)
    _build.check_tensor(w2_q, (inter, d), i8, "w2_q", dev)
    _build.check_tensor(w2_s, (1, d), f32, "w2_s", dev)
    _build.check_tensor(b2, (d,), _FLOAT, "b2", dev)
    bn = pick_block_n(inter)
    if s == 0 or d == 0 or d % 16 or bn == 0:
        raise ValueError(f"ffn_decode_int8_f32: unsupported shape S={s} D={d} I={inter}")
    _build.check_aligned("ffn_decode_int8_f32", x_q, w1_q, w2_q)
    hq, hs, _ = _quant_scratch(x_q, inter, d)
    out = torch.empty((s, d), dtype=out_dtype, device=dev)
    err = _build.load_library().apertis_ffn_decode_int8_f32(
        x_q.data_ptr(), x_s.data_ptr(), w1_q.data_ptr(), w1_s.data_ptr(), b1.data_ptr(),
        w2_q.data_ptr(), w2_s.data_ptr(), b2.data_ptr(), out.data_ptr(), hq.data_ptr(),
        hs.data_ptr(), s, d, inter, bn, _ACT_CODES.get(hidden_act, 0),
        _build.float_code(b1, "b1"), _build.float_code(b2, "b2"),
        _build.float_code(out, "out_dtype"), *_plan_args(quant_plan(x_q, d, inter, 8)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn_decode_int8_f32")
    ffn_decode_int8_f32.launches += 1
    return out


ffn_decode.launches = 0
ffn_decode_int8.launches = 0
ffn_decode_int4.launches = 0
ffn_decode_f32.launches = 0
ffn_decode_int8_f32.launches = 0
