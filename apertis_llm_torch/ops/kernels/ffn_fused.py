"""The dense FFN at decode: ``act(x @ W1 + b1) @ W2 + b2``.

``ffn_decode`` launches the CUDA kernel in ``csrc/ffn_fused.cu`` (a fused
tensor-core pass that keeps each hidden slice in its block and adds the
slices of a group across a thread-block cluster, then a small reduce of the
group partials) for CUDA tensors and runs :func:`ffn_decode_reference`, its
plain PyTorch version, for CPU tensors. It replaces
``apertis_llm_tpu/ops/pallas/ffn_fused.py::ffn_decode_fused`` with the bf16
weight layout.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from apertis_llm_torch.ops.activations import get_activation
from apertis_llm_torch.ops.kernels import _build

_SLICE = 128       # I columns per block and output columns per chunk (csrc)
_CLUSTER = 8       # I slices per group, one thread-block cluster (csrc)
_TILE_ROWS = 64    # rows per block
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


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _chunks_per_part(rows: int, slices: int, chunks: int, device_index: int) -> int:
    """Split the output columns into as many parts as it takes for pass 1 to
    have about one block per SM; a deterministic function of the shape and
    the card."""
    row_tiles = -(-rows // _TILE_ROWS)
    parts = min(chunks, max(1, -(-_sm_count(device_index) // (slices * row_tiles))))
    return -(-chunks // parts)


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
    multiples of 16 and the weights 32-byte aligned, and returns bf16.
    """
    if x.device.type == "cpu":
        return ffn_decode_reference(x, w1, b1, w2, b2, hidden_act, out_dtype)
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
    if w1.data_ptr() % 32 or w2.data_ptr() % 32:
        raise ValueError("ffn_decode: weights must be 32-byte aligned")
    groups = -(-inter // (_SLICE * _CLUSTER))
    chunks = -(-d // _SLICE)
    cpp = _chunks_per_part(s, groups * _CLUSTER, chunks, dev.index)
    partial = torch.empty((groups, s, d), dtype=torch.float32, device=dev)
    out = torch.empty((s, d), dtype=torch.bfloat16, device=dev)
    err = _build.load_library().apertis_ffn_decode(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), partial.data_ptr(), s, d, inter, cpp,
        _ACT_CODES.get(hidden_act, 0), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn_decode")
    ffn_decode.launches += 1
    return out


ffn_decode.launches = 0
