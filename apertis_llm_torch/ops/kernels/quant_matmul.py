"""The int8-weight products of serving: the three kernels of ``csrc/quant_matmul.cu``.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (``*_reference``) for CPU tensors. The weight is the JAX
tree's row-major (K, N) int8 ``w_q``, read as it is, with f32 column scales
``w_s``; a bias is added in the output type after the kernel's one rounding.

  * :func:`quant_matmul_dyn_pre_q` (``quant_matmul_dyn``, #7): the w8a8
    product of rows quantized already, with its dequantizing epilogue
    ``acc * x_s * w_s``: every int8 linear under ``quant_matmul="dyn"`` and
    the int8 decode projections in every mode. :func:`quant_matmul_dyn` is
    its form that quantizes its input rows first (``ops/quant.py::
    quantize_rows``, plain torch);
  * :func:`quant_matmul` (#6, ``quant_matmul="pallas"``): the weight-only
    product ``x.dtype((x @ float(w_q)) * w_s)`` with f32 accumulation;
  * :func:`quant_matmul_dyn_fused` (#8, ``quant_matmul="fused"``): the w8a8
    product that quantizes x per row and 512-wide K block: one pass writes
    the padded int8 rows and the block scales (:func:`quantize_blocks`),
    then qm_kernel's block-scaled mode, or at a K split the decode FFN's
    tile-ordered GEMM2, on :func:`fused_plan`.

They replace ``apertis_llm_tpu/ops/pallas/quant_matmul.py``'s
``quant_matmul_dyn``, ``quant_matmul`` and ``quant_matmul_dyn_fused``.

#7 and #6's bf16 form are one Hopper kernel (TMA, ``wgmma``); the host
chooses its tile plan from the shape (:func:`tile_plan`: the rows of a
tile, a K split over a cluster at decode rows, and which operands TMA can
load) and passes it to the C entry point; :func:`quant_matmul_resources`
reads what the card gives each plan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from apertis_llm_torch.ops.kernels import _build, decode_plan
from apertis_llm_torch.ops.kernels.flash_attention import RESOURCE_KEYS
from apertis_llm_torch.ops.quant import int_mm, linear_pre_q_reference, quantize_rows

_OUT_DTYPES = (torch.bfloat16, torch.float32)
# quant_matmul_dyn_fused's K block: x is quantized per row over columns
# [512 j, 512 j + 512) (quant_matmul.py BLOCK_K; one block when K <= 512).
QUANT_BLOCK_K = 512

# The tile plan of #7 and #6's bf16 form (csrc/quant_matmul.cu, qm_kernel):
# a tile is TILE_COLS output columns (two warpgroups of 64 weight columns)
# by one of ROW_TILES activation rows, the wgmma's N; K runs in chunks of
# 128 bytes of an x row (128 int8 or 64 bf16 values).
TILE_COLS = 128
ROW_TILES = (16, 64, 128, 256)
CHUNK_BYTES = 128
# K is split over a thread-block cluster of at most this many blocks: a GPC
# of the H100 (16 or 18 SMs) holds four clusters of four one-SM blocks, so
# 32 such clusters run at once; only at 16 or 64 rows, where the blocks'
# partial accumulators fit beside the ring in shared memory; and only while
# each block keeps SPLIT_CHUNKS K chunks or more: on the H100
# (``chip_smoke.py --qmm``) a split of the MHA QKV's 19 chunks in two was
# slower than none (0.0128 against 0.0101 ms), one of w2's 76 in four
# faster (0.0128 against 0.0234).
MAX_SPLIT = 4
SPLIT_ROWS = 64
SPLIT_CHUNKS = 16


class TilePlan(NamedTuple):
    """How qm_kernel runs one product: ``rows`` activation rows a tile,
    K split over ``split`` blocks of a cluster, and whether x and the
    weight are loaded by TMA (else the producer's own zero-filling loads)."""
    rows: int
    split: int
    tma_x: bool
    tma_w: bool


def tile_plan(m: int, n: int, k: int, x_bytes: int, sms: int, x_aligned: bool = True,
              w_aligned: bool = True) -> TilePlan:
    """The tile plan for an (M, K) x (K, N) product whose x elements are
    ``x_bytes`` wide (1: #7's int8, 2: #6's bf16) on a card of ``sms`` SMs.

    ``rows`` is the smallest row tile that holds M, 256 above. Where M fits
    a 64-row tile and the tiles fill at most half the SMs (the decode
    shapes: a weight streamed by too few blocks), K is split over
    ``min(MAX_SPLIT, sms // tiles, chunks // SPLIT_CHUNKS)`` blocks, at
    least one. TMA needs row strides that are multiples of 16 bytes and
    16-byte aligned bases: x's row is K values, the weight's N bytes."""
    rows = next((r for r in ROW_TILES if m <= r), ROW_TILES[-1])
    tiles = -(-m // rows) * -(-n // TILE_COLS)
    chunks = -(-k * x_bytes // CHUNK_BYTES)
    split = 1
    if rows <= SPLIT_ROWS and 2 * tiles <= sms:
        split = max(1, min(MAX_SPLIT, sms // tiles, chunks // SPLIT_CHUNKS))
    return TilePlan(rows, split, x_aligned and (k * x_bytes) % 16 == 0,
                    w_aligned and n % 16 == 0)


# #8's plan: row tiles whose int32 and f32 accumulators (two sets of BR / 2
# registers a consumer thread) fit beside the fragments; a split only on
# whole 512-wide blocks, and only where TMA loads the weight.
FUSED_ROW_TILES = (16, 64, 128)
QUANT_BLOCK_CHUNKS = QUANT_BLOCK_K // CHUNK_BYTES


class FusedPlan(NamedTuple):
    """How #8 runs its product: ``rows`` activation rows a tile; K split
    over ``split`` blocks of a cluster on whole 512-wide blocks (the decode
    FFN's GEMM2, ``group`` consecutive blocks a rank in each round of its
    exchange, ``stages`` ring stages), or qm_kernel's block-scaled mode at
    split 1 (group 1, stages 0: its own ring); whether TMA loads the
    weight."""
    rows: int
    split: int
    group: int
    stages: int
    tma_w: bool


def fused_plan(m: int, n: int, k: int, sms: int, w_aligned: bool = True) -> FusedPlan:
    """#8's plan for an (M, K) x (K, N) product on a card of ``sms`` SMs:
    the smallest row tile of FUSED_ROW_TILES that holds M, 128 above; a K
    split where :func:`tile_plan` would split #7 (at most 64 rows, the
    column tiles on at most half the SMs, SPLIT_CHUNKS chunks a block), on
    at most as many blocks as K has 512-wide blocks, and only where the
    weight loads by TMA (N a multiple of 16); then GEMM2's largest group
    whose exchange slots leave decode_plan.MIN_STAGES stages."""
    rows = next((r for r in FUSED_ROW_TILES if m <= r), FUSED_ROW_TILES[-1])
    tiles = -(-m // rows) * -(-n // TILE_COLS)
    chunks = -(-k // CHUNK_BYTES)
    blocks = -(-k // QUANT_BLOCK_K)
    tma_w = w_aligned and n % 16 == 0
    split = 1
    if rows <= SPLIT_ROWS and 2 * tiles <= sms and tma_w:
        split = max(1, min(MAX_SPLIT, sms // tiles, chunks // SPLIT_CHUNKS, blocks))
    if split == 1:
        return FusedPlan(rows, 1, 1, 0, tma_w)
    stage = rows * 128 + decode_plan.W8_BYTES

    def smem(group, stages):
        return decode_plan.smem_bytes(rows, stages, stage, 1,
                                      decode_plan.down_extra(rows, split, group, 0))
    group = max([1] + [g for g in range(1, min(decode_plan.MAX_GROUP, -(-blocks // split)) + 1)
                       if smem(g, decode_plan.MIN_STAGES) <= decode_plan.SMEM_LIMIT])
    per_block = -(-blocks // (split * group)) * group * QUANT_BLOCK_CHUNKS
    stages = decode_plan._stages(rows, stage, 1, decode_plan.down_extra(rows, split, group, 0),
                                 per_block)
    return FusedPlan(rows, split, group, stages, tma_w)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_args(x: torch.Tensor, w_q: torch.Tensor, m: int, n: int, k: int) -> tuple:
    """The tile plan of a launch on the card, as the C entry points take it."""
    plan = tile_plan(m, n, k, x.element_size(), _sm_count(x.device.index or 0),
                     x.data_ptr() % 16 == 0, w_q.data_ptr() % 16 == 0)
    return plan.rows, plan.split, int(plan.tma_x), int(plan.tma_w)


def quant_matmul_resources(w8a8: bool, rows: int, split: int = 1) -> Dict[str, int]:
    """What the card gives #7's (``w8a8``) or #6's bf16 kernel at a tile of
    ``rows`` activation rows and a K split over ``split`` blocks: registers
    a thread, shared memory a block in bytes, resident blocks an SM, threads
    a block and spilled bytes a thread."""
    if rows not in ROW_TILES or not 1 <= split <= MAX_SPLIT or (split > 1 and rows > SPLIT_ROWS):
        raise ValueError(f"quant_matmul_resources: no kernel at rows={rows} split={split}")
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = _build.load_library().apertis_quant_matmul_resources(
        int(w8a8), rows, split, ctypes.addressof(out))
    _build.check(err, "quant_matmul_resources")
    return dict(zip(RESOURCE_KEYS, out))


# The plain version: ``int32(x_q @ w_q) * x_s * w_s`` in f32, cast to
# ``out_dtype``, then ``+ b``.
quant_matmul_dyn_pre_q_reference = linear_pre_q_reference


def quant_matmul_dyn_pre_q(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                           w_s: torch.Tensor, b: Optional[torch.Tensor],
                           out_dtype: torch.dtype) -> torch.Tensor:
    """The w8a8 product of rows quantized already: kernel on CUDA tensors,
    plain version on CPU ones.

    The kernel takes contiguous int8 ``x_q`` (..., K) with f32 ``x_s``
    (..., 1), a contiguous int8 ``w_q`` (K, N) with f32 ``w_s`` (1, N) or
    (N,), ``b`` None or (N,) of ``out_dtype``, and ``out_dtype`` bf16 or f32;
    any M, N and K."""
    if x_q.device.type == "cpu":
        return quant_matmul_dyn_pre_q_reference(x_q, x_s, w_q, w_s, b, out_dtype)
    lead = x_q.shape[:-1]
    k = x_q.shape[-1]
    n = w_q.shape[-1]
    m = x_q.numel() // max(k, 1)
    dev = x_q.device
    x2, s2 = x_q.reshape(m, k), x_s.reshape(m, 1)
    _build.check_tensor(x2, (m, k), (torch.int8,), "x_q", dev)
    _build.check_tensor(s2, (m, 1), (torch.float32,), "x_s", dev)
    _build.check_tensor(w_q, (k, n), (torch.int8,), "w_q", dev)
    _build.check_tensor(w_s.reshape(1, n), (1, n), (torch.float32,), "w_s", dev)
    if b is not None:
        _build.check_tensor(b, (n,), (out_dtype,), "b", dev)
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"quant_matmul_dyn: out_dtype {out_dtype} not in {_OUT_DTYPES}")
    if k == 0 or n == 0:
        raise ValueError(f"quant_matmul_dyn: unsupported shape M={m} K={k} N={n}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out.reshape(*lead, n)
    err = _build.load_library().apertis_quant_matmul_dyn(
        x2.data_ptr(), s2.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), m, n, k,
        int(out_dtype == torch.bfloat16), *_plan_args(x2, w_q, m, n, k),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "quant_matmul_dyn")
    quant_matmul_dyn_pre_q.launches += 1
    return out.reshape(*lead, n)


def quant_matmul_dyn(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic w8a8 linear (``quant_matmul_dyn`` then ``+ b``): the rows of
    ``x`` quantized per row at run time, the result in ``x.dtype``."""
    x_q, x_s = quantize_rows(x)
    return quant_matmul_dyn_pre_q(x_q, x_s, w_q, w_s, b, x.dtype)


def quant_matmul_reference(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """#6's arithmetic (``quant_matmul.py::_kernel``): ``x @ float(w_q)`` in
    f32 (the products of bf16 or f32 x with int8 levels, f32 sums), times
    ``w_s`` in f32, one rounding to x's dtype, then ``+ b``."""
    lead = x.shape[:-1]
    acc = x.reshape(-1, x.shape[-1]).float() @ w_q.float()
    y = (acc * w_s.reshape(1, -1).float()).to(x.dtype).reshape(*lead, w_q.shape[-1])
    return y + b if b is not None else y


def quantize_blocks(x: torch.Tensor):
    """#8's quantization pass, plain: the (M, K) rows of x as int8 levels
    ``clip(rint(x / s_j))`` of row stride Kp = K rounded up to a multiple of
    128, zeros past K, and the (M, ceil(K / 512)) f32 scales ``s_j =
    max(absmax, 1e-8) * (1/127)`` of each row's 512-wide blocks."""
    m, k = x.reshape(-1, x.shape[-1]).shape
    xf = x.reshape(m, k).float()
    kp = -(-k // CHUNK_BYTES) * CHUNK_BYTES
    x_q = torch.zeros((m, kp), dtype=torch.int8, device=x.device)
    scales = []
    for j0 in range(0, k, QUANT_BLOCK_K):
        xb = xf[:, j0:j0 + QUANT_BLOCK_K]
        s = torch.clamp(xb.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        x_q[:, j0:j0 + xb.shape[1]] = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
        scales.append(s)
    return x_q, torch.cat(scales, dim=1)


def quant_matmul_dyn_fused_reference(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """#8's arithmetic (``quant_matmul.py::_dyn_fused_kernel``), block by
    block: for each 512-wide K block j, ``s_j = max(absmax, 1e-8) * (1/127)``
    per row (a multiply, where ``quantize_rows`` divides by 127), ``q =
    clip(rint(x / s_j))`` (a true division), ``acc += float(q @ w_q[j]) *
    s_j``; then ``x.dtype(acc * w_s)`` and ``+ b``."""
    lead, k, n = x.shape[:-1], x.shape[-1], w_q.shape[-1]
    xf = x.reshape(-1, k).float()
    acc = torch.zeros((xf.shape[0], n), dtype=torch.float32, device=x.device)
    for j0 in range(0, k, QUANT_BLOCK_K):
        xb = xf[:, j0:j0 + QUANT_BLOCK_K]
        s = torch.clamp(xb.abs().amax(dim=1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
        acc = acc + int_mm(q, w_q[j0:j0 + QUANT_BLOCK_K]).float() * s
    y = (acc * w_s.reshape(1, -1).float()).to(x.dtype).reshape(*lead, n)
    return y + b if b is not None else y


def _launch_float_x(wrapper, entry: str, x: torch.Tensor, w_q: torch.Tensor,
                    w_s: torch.Tensor, b: Optional[torch.Tensor], plan_args) -> torch.Tensor:
    """Check the operands of a kernel that reads bf16 or f32 x, launch
    ``entry`` (none for an x without rows) with what ``plan_args(x2, m, n,
    k)`` gives (scratch tensors passed before M, N, K; plan integers after
    x's type), count the launch on ``wrapper`` and return the (..., N)
    result in x's dtype."""
    lead, k, n = x.shape[:-1], x.shape[-1], w_q.shape[-1]
    m = x.numel() // max(k, 1)
    dev = x.device
    if x.dtype not in _OUT_DTYPES:
        raise ValueError(f"{entry}: x dtype {x.dtype} not in {_OUT_DTYPES}")
    x2 = x.reshape(m, k)
    _build.check_tensor(x2, (m, k), _OUT_DTYPES, "x", dev)
    _build.check_tensor(w_q, (k, n), (torch.int8,), "w_q", dev)
    _build.check_tensor(w_s.reshape(1, n), (1, n), (torch.float32,), "w_s", dev)
    if b is not None:
        _build.check_tensor(b, (n,), (x.dtype,), "b", dev)
    if k == 0 or n == 0:
        raise ValueError(f"{entry}: unsupported shape M={m} K={k} N={n}")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m > 0:
        scratch, plan = plan_args(x2, m, n, k)
        err = getattr(_build.load_library(), entry)(
            x2.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), *(t.data_ptr() for t in scratch), m, n, k,
            int(x.dtype == torch.bfloat16), *plan, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, entry)
        wrapper.launches += 1
    return out.reshape(*lead, n)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weight-only product (#6): kernel on CUDA tensors, plain version on
    CPU ones. The kernel takes contiguous bf16 or f32 ``x`` (..., K), a
    contiguous int8 ``w_q`` (K, N), f32 ``w_s`` (1, N) or (N,) and ``b``
    None or (N,) of x's dtype; any M, N and K."""
    if x.device.type == "cpu":
        return quant_matmul_reference(x, w_q, w_s, b)
    return _launch_float_x(quant_matmul, "apertis_quant_matmul", x, w_q, w_s, b,
                           lambda x2, m, n, k: ((), _plan_args(x2, w_q, m, n, k)))


def quant_matmul_dyn_fused(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The w8a8 product with x quantized per row and 512-wide K block
    (#8): kernel on CUDA tensors, plain version on CPU ones. Takes what
    :func:`quant_matmul` takes."""
    if x.device.type == "cpu":
        return quant_matmul_dyn_fused_reference(x, w_q, w_s, b)
    return _launch_float_x(quant_matmul_dyn_fused, "apertis_quant_matmul_dyn_fused", x, w_q,
                           w_s, b, lambda x2, m, n, k: _fused_args(x2, w_q, m, k))


def _fused_args(x2: torch.Tensor, w_q: torch.Tensor, m: int, k: int) -> tuple:
    """#8's scratch (the quantization pass's padded int8 rows and block
    scales) and its plan, as the C entry point takes them."""
    fp = fused_plan_on(x2, w_q)
    x_q = torch.empty((m, -(-k // CHUNK_BYTES) * CHUNK_BYTES), dtype=torch.int8, device=x2.device)
    x_s = torch.empty((m, -(-k // QUANT_BLOCK_K)), dtype=torch.float32, device=x2.device)
    return (x_q, x_s), (fp.rows, fp.split, fp.group, fp.stages, int(fp.tma_w))


def fused_plan_on(x: torch.Tensor, w_q: torch.Tensor) -> FusedPlan:
    """#8's plan for the (..., K) rows x and the weight w_q on x's card."""
    k, n = w_q.shape
    return fused_plan(x.numel() // max(k, 1), n, k, _sm_count(x.device.index or 0),
                      w_q.data_ptr() % 16 == 0)


def quant_matmul_fused_resources(plan: FusedPlan) -> Dict[str, Dict[str, int]]:
    """What the card gives #8's launches at ``plan``: the quantization pass
    and the product (qm_kernel's block-scaled mode, or GEMM2 at a split),
    each registers a thread, shared memory a block, resident blocks an SM,
    threads a block and spilled bytes a thread."""
    result = {}
    smem = 0
    if plan.split > 1:
        stage = plan.rows * 128 + decode_plan.W8_BYTES
        smem = decode_plan.smem_bytes(plan.rows, plan.stages, stage, 1,
                                      decode_plan.down_extra(plan.rows, plan.split, plan.group, 0))
    for name, kernel in (("quantize", 0), ("product", 2 if plan.split > 1 else 1)):
        out = (ctypes.c_int * len(RESOURCE_KEYS))()
        err = _build.load_library().apertis_quant_matmul_fused_resources(
            kernel, plan.rows, smem, ctypes.addressof(out))
        _build.check(err, "quant_matmul_fused_resources")
        result[name] = dict(zip(RESOURCE_KEYS, out))
    return result


quant_matmul_dyn_pre_q.launches = 0
quant_matmul.launches = 0
quant_matmul_dyn_fused.launches = 0
