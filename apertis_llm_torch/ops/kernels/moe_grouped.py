"""The grouped MoE FFN over expert-sorted rows: prefill at large token counts.

``expert_ffn_grouped`` launches the CUDA kernel in ``csrc/moe_grouped.cu``
(two launches: the int8 GEMM1 with its epilogue and per-row absmax, then the
int8 GEMM2 that requantizes the hidden as it reads it) for CUDA tensors and
runs :func:`expert_ffn_grouped_reference`, its plain PyTorch version, for CPU
tensors. It replaces ``apertis_llm_tpu/ops/pallas/moe_grouped.py::
expert_ffn_grouped`` with the int8 fat stack of ``models/moe_fuse.py``,
unstacked: the caller passes one layer's tensors. ``ops/moe.py::
grouped_dispatch`` builds its row layout.
"""

from __future__ import annotations

import torch

from apertis_llm_torch.ops.activations import get_activation
from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.quant import int_mm

TILE = 128                                        # rows of one expert tile
_ACT_CODES = {"relu": 1, "silu": 2, "swish": 2}   # anything else: exact GELU


def expert_ffn_grouped_reference(
    xq: torch.Tensor,       # (P, H) int8, expert-sorted, tile-padded rows
    xs: torch.Tensor,       # (P, 1) f32 row scales
    emap: torch.Tensor,     # (P / TILE,) int32 tile -> expert, -1: no expert
    w1t_q: torch.Tensor,    # (H, E*I) int8
    w1t_s: torch.Tensor,    # (1, E*I) f32
    b1t: torch.Tensor,      # (E*I,) f32
    w2t_q: torch.Tensor,    # (E*I, H) int8
    w2t_s: torch.Tensor,    # (1, H) f32
    num_experts: int,
    hidden_act: str = "gelu",
) -> torch.Tensor:
    """bf16 (P, H): per tile of expert e, over the expert's I columns,
    ``h = act(int32(xq @ W1t_e) * xs * w1t_s_e + b1t_e)``, one scale per row
    ``hs = max(absmax, 1e-8) * (1/127)``, ``out = bf16(int32(rint(h / hs) @
    W2t_e) * hs * w2t_s)``; the rows of tiles with ``emap == -1`` are 0."""
    p, d = xq.shape
    inter = w1t_q.shape[1] // num_experts
    act = get_activation(hidden_act)
    out = torch.zeros((p, d), dtype=torch.bfloat16, device=xq.device)
    for t, e in enumerate(emap.tolist()):
        if e < 0:
            continue
        rows, cols = slice(t * TILE, (t + 1) * TILE), slice(e * inter, (e + 1) * inter)
        h = act(int_mm(xq[rows], w1t_q[:, cols]).float() * xs[rows]
                * w1t_s[:, cols] + b1t[cols].float())
        hs = torch.clamp(h.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        hq = torch.clamp(torch.round(h / hs), -127, 127).to(torch.int8)
        y = int_mm(hq, w2t_q[cols]).float() * hs * w2t_s.reshape(1, -1)
        out[rows] = y.to(torch.bfloat16)
    return out


def expert_ffn_grouped(
    xq: torch.Tensor,
    xs: torch.Tensor,
    emap: torch.Tensor,
    w1t_q: torch.Tensor,
    w1t_s: torch.Tensor,
    b1t: torch.Tensor,
    w2t_q: torch.Tensor,
    w2t_s: torch.Tensor,
    num_experts: int,
    hidden_act: str = "gelu",
) -> torch.Tensor:
    """The grouped MoE FFN: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes contiguous tensors of the dtypes above, P a multiple of
    128, H and I multiples of 16 and 16-byte aligned operands, and returns
    bf16 (P, H).
    """
    if xq.device.type == "cpu":
        return expert_ffn_grouped_reference(xq, xs, emap, w1t_q, w1t_s, b1t, w2t_q, w2t_s,
                                            num_experts, hidden_act)
    p, d = xq.shape
    ei = w1t_q.shape[1]
    dev = xq.device
    i8, f32 = (torch.int8,), (torch.float32,)
    _build.check_tensor(xq, (p, d), i8, "xq", dev)
    _build.check_tensor(xs, (p, 1), f32, "xs", dev)
    _build.check_tensor(emap, (p // TILE,), (torch.int32,), "emap", dev)
    _build.check_tensor(w1t_q, (d, ei), i8, "w1t_q", dev)
    _build.check_tensor(w1t_s, (1, ei), f32, "w1t_s", dev)
    _build.check_tensor(b1t, (ei,), f32, "b1t", dev)
    _build.check_tensor(w2t_q, (ei, d), i8, "w2t_q", dev)
    _build.check_tensor(w2t_s, (1, d), f32, "w2t_s", dev)
    inter = ei // max(num_experts, 1)
    if (p == 0 or p % TILE or d % 16 or num_experts <= 0 or ei % num_experts
            or inter % 16):
        raise ValueError(f"expert_ffn_grouped: unsupported shape P={p} H={d} E*I={ei} "
                         f"E={num_experts}")
    _build.check_aligned("expert_ffn_grouped", xq, w1t_q, w2t_q)
    hidden = torch.empty((p, inter), dtype=torch.float32, device=dev)
    absmax = torch.empty((p, 1), dtype=torch.float32, device=dev)
    out = torch.empty((p, d), dtype=torch.bfloat16, device=dev)
    err = _build.load_library().apertis_expert_ffn_grouped(
        xq.data_ptr(), xs.data_ptr(), emap.data_ptr(), w1t_q.data_ptr(), w1t_s.data_ptr(),
        b1t.data_ptr(), w2t_q.data_ptr(), w2t_s.data_ptr(), out.data_ptr(), hidden.data_ptr(),
        absmax.data_ptr(), p, d, ei, num_experts, _ACT_CODES.get(hidden_act, 0),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "expert_ffn_grouped")
    expert_ffn_grouped.launches += 1
    return out


expert_ffn_grouped.launches = 0
