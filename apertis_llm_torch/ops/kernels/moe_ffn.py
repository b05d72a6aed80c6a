"""The all-expert MoE FFN kernels: decode, and prefill at small token counts.

``expert_ffn_fat`` launches the CUDA kernel in ``csrc/moe_ffn.cu`` for CUDA
tensors and runs :func:`expert_ffn_fat_reference`, its plain PyTorch
version, for CPU tensors. It replaces
``apertis_llm_tpu/ops/pallas/moe_ffn.py::expert_ffn_fat`` with the int8 fat
stack of ``models/moe_fuse.py``, unstacked: the caller passes one layer's
tensors. The kernel is the decode FFN's pair of Hopper int8 ``wgmma``
products (``csrc/quant_ffn.cuh`` on ``decode_gemm.cuh``): GEMM1 with the
per-(row, hidden tile) requantization (across a cluster, or, for tiles
wider than one, through an f32 hidden and a requantization pass), GEMM2
whose K split over a cluster adds the tiles' products, scaled by the
combine weight, in tile order; the weight of an expert that no row routes
to is not read. The plan is ``ops/kernels/decode_plan.py::fat_plan``.
:func:`expert_ffn_fat_int4` is the int4 layout (``int4=True``): the same
launches over the nibble-packed fat stack, unpacked into int8 fragments in
registers.

:func:`expert_ffn_dense` (``moe_mode="kernel"``, the JAX package's
``APERTIS_MOE_FUSED=kernel``) launches the per-expert kernel of
``csrc/moe_dense.cu`` over the per-expert stack of
``models/moe_fuse.py::fuse_moe_decode_params``, or runs
:func:`expert_ffn_dense_reference` for CPU tensors. It replaces
``apertis_llm_tpu/ops/pallas/moe_ffn.py::expert_ffn_dense``. The kernel is
the fat kernel's pair of products, one grid slice an expert: GEMM1's wide
form (the f32 hidden and each (row, expert) absmax over the whole of I) and
its requantization pass, then a GEMM2 whose K split over a cluster adds its
exact int32 parts in distributed shared memory before the one float
conversion. The plan is ``ops/kernels/decode_plan.py::dense_plan``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from apertis_llm_torch.models.quantize import unpack_int4
from apertis_llm_torch.ops.activations import get_activation
from apertis_llm_torch.ops.kernels import _build, decode_plan
from apertis_llm_torch.ops.kernels.flash_attention import RESOURCE_KEYS
from apertis_llm_torch.ops.quant import int_mm

_ACT_CODES = {"relu": 1, "silu": 2, "swish": 2}   # anything else: exact GELU
_BLOCK_N = 2816     # the TPU kernel's default tile width (moe_ffn.py:270)


def fat_block_n(inter: int) -> int:
    """The hidden tile width of the fat kernel for I = ``inter`` columns per
    expert, the TPU kernel's loop (moe_ffn.py:289-294) from its default
    width: halve until the tile divides I and is a multiple of 128, else 128
    when that divides I, else I. 2816 at the 1.5B MoE preset; 128 for
    I = 256, 384, 512, 1024; I for I = 192, 704 or 2790 (the odd-width
    model's, which is not a multiple of 16 either)."""
    bn = _BLOCK_N
    while inter % bn != 0 or bn % 128 != 0:
        bn //= 2
        if bn < 128:
            return 128 if inter % 128 == 0 else inter
    return bn


def expert_ffn_fat_reference(
    xq: torch.Tensor,       # (S, H) int8, centred and quantized rows
    xs: torch.Tensor,       # (S, 1) f32 row scales
    combine: torch.Tensor,  # (S, E) f32 routing-combine weights
    w1t_q: torch.Tensor,    # (H, E*I) int8
    w1t_s: torch.Tensor,    # (1, E*I) f32
    b1t: torch.Tensor,      # (E*I,) f32
    w2t_q: torch.Tensor,    # (E*I, H) int8
    w2t_s: torch.Tensor,    # (1, H) f32, one scale per output channel
    num_experts: int,
    hidden_act: str = "gelu",
) -> torch.Tensor:
    """The TPU kernel's arithmetic step by step, f32 (S, H) out:
    ``h = act(int32(xq @ W1t) * xs * w1t_s + b1t)``; per hidden tile t of
    :func:`fat_block_n` columns (expert e = t // tiles per expert)
    ``hs = max(absmax, 1e-8) * (1/127)``, ``hq = rint(h_t / hs)``,
    ``acc += int32(hq @ W2t[t]) * (hs * combine[:, e])`` in tile order;
    ``out = acc * w2t_s``."""
    ei = w1t_q.shape[1]
    bn = fat_block_n(ei // num_experts)
    per_expert = ei // num_experts // bn
    act = get_activation(hidden_act)
    h = act(int_mm(xq, w1t_q).float() * xs * w1t_s.reshape(1, -1) + b1t.float())
    acc = torch.zeros((xq.shape[0], w2t_q.shape[1]), dtype=torch.float32, device=xq.device)
    for t in range(ei // bn):
        ht = h[:, t * bn:(t + 1) * bn]
        hs = torch.clamp(ht.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        hq = torch.clamp(torch.round(ht / hs), -127, 127).to(torch.int8)
        col = combine[:, t // per_expert:t // per_expert + 1].float()
        acc = acc + int_mm(hq, w2t_q[t * bn:(t + 1) * bn]).float() * (hs * col)
    return acc * w2t_s.reshape(1, -1)


def expert_ffn_fat_int4_reference(
    xq: torch.Tensor,       # (S, H) int8
    xs: torch.Tensor,       # (S, 1) f32
    combine: torch.Tensor,  # (S, E) f32
    w1t_q4: torch.Tensor,   # (H/2, E*I) int8, two int4 values a byte
    w1t_sh: torch.Tensor,   # (H/128, E*I) int8 shifts
    w1t_s: torch.Tensor,    # (1, E*I) f32
    b1t: torch.Tensor,      # (E*I,) f32
    w2t_q4: torch.Tensor,   # (E*I/2, H)
    w2t_sh: torch.Tensor,   # (E*I/128, H)
    w2t_s: torch.Tensor,    # (1, H) f32
    num_experts: int,
    hidden_act: str = "gelu",
) -> torch.Tensor:
    """The int4 fat layout: the int8 layout's arithmetic over the unpacked
    weights (``models/quantize.py::unpack_int4``)."""
    return expert_ffn_fat_reference(xq, xs, combine, unpack_int4(w1t_q4, w1t_sh), w1t_s, b1t,
                                    unpack_int4(w2t_q4, w2t_sh), w2t_s, num_experts, hidden_act)


def dense_plan(xq: torch.Tensor, d: int, inter: int,
               num_experts: int) -> decode_plan.DensePlan:
    """The plan of the per-expert kernel for these rows on their card."""
    return decode_plan.dense_plan(xq.shape[0], d, inter, num_experts,
                                  _build.sm_count(xq.device.index or 0))


def fat_plan(xq: torch.Tensor, d: int, inter: int, num_experts: int,
             bits: int) -> decode_plan.FatPlan:
    """The plan of the int8 (bits 8) or int4 fat kernel for these rows on
    their card."""
    return decode_plan.fat_plan(xq.shape[0], d, inter, num_experts, fat_block_n(inter), bits,
                                _build.sm_count(xq.device.index or 0))


def _fat_launch(name: str, xq: torch.Tensor, inter: int, num_experts: int, bits: int,
                tensors: tuple, hidden_act: str) -> torch.Tensor:
    """Allocate the scratch of the fat kernel's plan and call its C entry
    point ``name`` with the input ``tensors`` (x_q, x_s, combine and the
    stack); f32 (S, H) out."""
    s, d = xq.shape
    dev = xq.device
    ei = inter * num_experts
    bn = fat_block_n(inter)
    plan = fat_plan(xq, d, inter, num_experts, bits)
    *offsets, size = decode_plan.ffn_scratch(s, ei, bn, plan.up.split == 0)
    scratch = torch.empty((size,), dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    hq, hs, hidden, absmax = (None if off < 0 else base + off for off in offsets)
    out = torch.empty((s, d), dtype=torch.float32, device=dev)
    err = getattr(_build.load_library(), name)(
        *(t.data_ptr() for t in tensors), out.data_ptr(), hq, hs, hidden, absmax, s, d, ei,
        num_experts, bn, _ACT_CODES.get(hidden_act, 0), plan.up.rows, plan.up.split,
        plan.down.split, plan.group, plan.up.stages, plan.down.stages,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    return out


def fat_resources(bits: int, kernel: str, plan: decode_plan.GemmPlan,
                  any_width: bool = False) -> Dict[str, int]:
    """What the card gives the int8 (``bits`` 8) or int4 fat kernel's
    ``kernel`` ("up", "down", or "quant", the wide form's requantization)
    at its plan: registers a thread, shared memory a block in bytes,
    resident blocks an SM, threads a block and spilled bytes a thread.
    ``any_width``: the int8 instances that widths whose rows are not whole
    16-byte units launch (``csrc/quant_ffn.cuh``'s ``kAny``)."""
    if any_width:
        code = {"up": 5, "down": 6, "quant": 7}[kernel]
    else:
        code = 4 if kernel == "quant" else {"up": 0, "down": 1}[kernel] + (2 if bits == 4 else 0)
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = _build.load_library().apertis_expert_ffn_fat_resources(
        code, plan.rows, 0 if kernel == "quant" else plan.smem, ctypes.addressof(out))
    _build.check(err, "fat_resources")
    return dict(zip(RESOURCE_KEYS, out))


def expert_ffn_fat(
    xq: torch.Tensor,
    xs: torch.Tensor,
    combine: torch.Tensor,
    w1t_q: torch.Tensor,
    w1t_s: torch.Tensor,
    b1t: torch.Tensor,
    w2t_q: torch.Tensor,
    w2t_s: torch.Tensor,
    num_experts: int,
    hidden_act: str = "gelu",
) -> torch.Tensor:
    """The fat MoE FFN: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes contiguous tensors of the dtypes above at any H and I
    (the TPU kernel's tile of the whole I where I is not a multiple of 128;
    an operand whose rows are not whole 16-byte units goes by the
    producer's own loads) and 16-byte aligned int8 operands, and returns
    f32 (S, H).
    """
    if xq.device.type == "cpu":
        return expert_ffn_fat_reference(xq, xs, combine, w1t_q, w1t_s, b1t, w2t_q, w2t_s,
                                        num_experts, hidden_act)
    s, d = xq.shape
    ei = w1t_q.shape[1]
    dev = xq.device
    i8, f32 = (torch.int8,), (torch.float32,)
    _build.check_tensor(xq, (s, d), i8, "xq", dev)
    _build.check_tensor(xs, (s, 1), f32, "xs", dev)
    _build.check_tensor(combine, (s, num_experts), f32, "combine", dev)
    _build.check_tensor(w1t_q, (d, ei), i8, "w1t_q", dev)
    _build.check_tensor(w1t_s, (1, ei), f32, "w1t_s", dev)
    _build.check_tensor(b1t, (ei,), f32, "b1t", dev)
    _build.check_tensor(w2t_q, (ei, d), i8, "w2t_q", dev)
    _build.check_tensor(w2t_s, (1, d), f32, "w2t_s", dev)
    inter = ei // max(num_experts, 1)
    if s == 0 or d == 0 or num_experts <= 0 or ei % num_experts or inter == 0:
        raise ValueError(f"expert_ffn_fat: unsupported shape S={s} H={d} E*I={ei} "
                         f"E={num_experts}")
    _build.check_aligned("expert_ffn_fat", xq, w1t_q, w2t_q)
    out = _fat_launch("apertis_expert_ffn_fat", xq, inter, num_experts, 8,
                      (xq, xs, combine, w1t_q, w1t_s, b1t, w2t_q, w2t_s), hidden_act)
    expert_ffn_fat.launches += 1
    return out


def expert_ffn_fat_int4(
    xq: torch.Tensor,
    xs: torch.Tensor,
    combine: torch.Tensor,
    w1t_q4: torch.Tensor,
    w1t_sh: torch.Tensor,
    w1t_s: torch.Tensor,
    b1t: torch.Tensor,
    w2t_q4: torch.Tensor,
    w2t_sh: torch.Tensor,
    w2t_s: torch.Tensor,
    num_experts: int,
    hidden_act: str = "gelu",
) -> torch.Tensor:
    """The int4 fat MoE FFN: kernel on CUDA tensors, plain version on CPU
    ones. As :func:`expert_ffn_fat`, with the packs and shifts of
    ``models/moe_fuse.py``'s int4 stack; H and the hidden tile width
    multiples of 128 (``moe_ffn.py:295-296``)."""
    if xq.device.type == "cpu":
        return expert_ffn_fat_int4_reference(xq, xs, combine, w1t_q4, w1t_sh, w1t_s, b1t,
                                             w2t_q4, w2t_sh, w2t_s, num_experts, hidden_act)
    s, d = xq.shape
    ei = w1t_q4.shape[1]
    dev = xq.device
    inter = ei // max(num_experts, 1)
    bn = fat_block_n(inter) if num_experts > 0 and ei % num_experts == 0 else 0
    if s == 0 or d % 128 or bn == 0 or bn % 128:
        raise ValueError(f"expert_ffn_fat_int4: unsupported shape S={s} H={d} E*I={ei} "
                         f"E={num_experts}")
    i8, f32 = (torch.int8,), (torch.float32,)
    _build.check_tensor(xq, (s, d), i8, "xq", dev)
    _build.check_tensor(xs, (s, 1), f32, "xs", dev)
    _build.check_tensor(combine, (s, num_experts), f32, "combine", dev)
    _build.check_tensor(w1t_q4, (d // 2, ei), i8, "w1t_q4", dev)
    _build.check_tensor(w1t_sh, (d // 128, ei), i8, "w1t_sh", dev)
    _build.check_tensor(w1t_s, (1, ei), f32, "w1t_s", dev)
    _build.check_tensor(b1t, (ei,), f32, "b1t", dev)
    _build.check_tensor(w2t_q4, (ei // 2, d), i8, "w2t_q4", dev)
    _build.check_tensor(w2t_sh, (ei // 128, d), i8, "w2t_sh", dev)
    _build.check_tensor(w2t_s, (1, d), f32, "w2t_s", dev)
    _build.check_aligned("expert_ffn_fat_int4", xq, w1t_q4, w1t_sh, w2t_q4, w2t_sh)
    out = _fat_launch("apertis_expert_ffn_fat_int4", xq, inter, num_experts, 4,
                      (xq, xs, combine, w1t_q4, w1t_sh, w1t_s, b1t, w2t_q4, w2t_sh, w2t_s),
                      hidden_act)
    expert_ffn_fat_int4.launches += 1
    return out


def expert_ffn_dense_reference(
    xq: torch.Tensor,       # (S, H) int8, centred and quantized rows
    xs: torch.Tensor,       # (S, 1) f32 row scales
    w1q: torch.Tensor,      # (E, H, I) int8, LayerNorm affine folded in
    w1s: torch.Tensor,      # (E, 1, I) f32
    b1: torch.Tensor,       # (E, I) f32
    w2q: torch.Tensor,      # (E, I, H) int8
    w2s: torch.Tensor,      # (E, 1, H) f32
    b2: torch.Tensor,       # (E, H) f32
    out_dtype: torch.dtype = torch.bfloat16,
    hidden_act: str = "gelu",
) -> torch.Tensor:
    """The TPU kernel's arithmetic (``moe_ffn.py::_kernel``), expert by
    expert, (E, S, H) in ``out_dtype``: ``h = act(int32(xq @ W1q[e]) * xs *
    w1s[e] + b1[e])``; per row over the whole of I ``hs = max(absmax, 1e-8) *
    (1/127)``, ``hq = rint(h / hs)``; ``y = int32(hq @ W2q[e]) * hs * w2s[e] +
    b2[e]``."""
    act = get_activation(hidden_act)
    outs = []
    for e in range(w1q.shape[0]):
        h = act(int_mm(xq, w1q[e]).float() * xs * w1s[e].reshape(1, -1)
                + b1[e].reshape(1, -1).float())
        hs = torch.clamp(h.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        hq = torch.clamp(torch.round(h / hs), -127, 127).to(torch.int8)
        y = (int_mm(hq, w2q[e]).float() * hs * w2s[e].reshape(1, -1)
             + b2[e].reshape(1, -1).float())
        outs.append(y.to(out_dtype))
    return torch.stack(outs)


def expert_ffn_dense(
    xq: torch.Tensor,
    xs: torch.Tensor,
    w1q: torch.Tensor,
    w1s: torch.Tensor,
    b1: torch.Tensor,
    w2q: torch.Tensor,
    w2s: torch.Tensor,
    b2: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
    hidden_act: str = "gelu",
) -> torch.Tensor:
    """Every expert's FFN over every row, (E, S, H): kernel on CUDA tensors,
    plain version on CPU ones. The kernel takes contiguous tensors of the
    dtypes above at any H and I, 16-byte aligned int8 operands and
    ``out_dtype`` bf16 or f32."""
    if xq.device.type == "cpu":
        return expert_ffn_dense_reference(xq, xs, w1q, w1s, b1, w2q, w2s, b2, out_dtype,
                                          hidden_act)
    s, d = xq.shape
    e, _, inter = w1q.shape
    dev = xq.device
    i8, f32 = (torch.int8,), (torch.float32,)
    _build.check_tensor(xq, (s, d), i8, "xq", dev)
    _build.check_tensor(xs, (s, 1), f32, "xs", dev)
    _build.check_tensor(w1q, (e, d, inter), i8, "w1q", dev)
    _build.check_tensor(w1s, (e, 1, inter), f32, "w1s", dev)
    _build.check_tensor(b1, (e, inter), f32, "b1", dev)
    _build.check_tensor(w2q, (e, inter, d), i8, "w2q", dev)
    _build.check_tensor(w2s, (e, 1, d), f32, "w2s", dev)
    _build.check_tensor(b2, (e, d), f32, "b2", dev)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"expert_ffn_dense: out_dtype {out_dtype} is not bf16 or f32")
    if s == 0 or e == 0 or d == 0 or inter == 0:
        raise ValueError(f"expert_ffn_dense: unsupported shape S={s} H={d} I={inter} E={e}")
    _build.check_aligned("expert_ffn_dense", xq, w1q, w2q)
    plan = dense_plan(xq, d, inter, e)
    # hq (S, E * Ip) int8, hs (S, E), hidden (S, E * I) and absmax (S, E) f32
    # in one buffer: the wide form's scratch with one tile an expert.
    *offsets, size = decode_plan.ffn_scratch(s, e * inter, inter, True)
    scratch = torch.empty((size,), dtype=torch.uint8, device=dev)
    hq, hs, hidden, absmax = (scratch.data_ptr() + off for off in offsets)
    out = torch.empty((e, s, d), dtype=out_dtype, device=dev)
    err = _build.load_library().apertis_expert_ffn_dense(
        xq.data_ptr(), xs.data_ptr(), w1q.data_ptr(), w1s.data_ptr(), b1.data_ptr(),
        w2q.data_ptr(), w2s.data_ptr(), b2.data_ptr(), out.data_ptr(), hq, hs, hidden, absmax,
        s, d, inter, e, _ACT_CODES.get(hidden_act, 0), int(out_dtype == torch.bfloat16),
        plan.up.rows, plan.down.split, plan.up.stages, plan.down.stages,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "expert_ffn_dense")
    expert_ffn_dense.launches += 1
    return out


expert_ffn_fat.launches = 0
expert_ffn_fat_int4.launches = 0
expert_ffn_dense.launches = 0
