"""Decode attention of one query per row over one layer of the flat KV cache.

``mha_decode_ctx`` (bf16 cache) and ``mha_decode_ctx_int8`` (int8 cache with
per-(head, slot) scales) launch the CUDA kernel in ``csrc/mha_step.cu`` for
CUDA tensors and run :func:`mha_decode_ctx_reference`, their plain PyTorch
version, for CPU tensors. They replace ``apertis_llm_tpu/ops/pallas/
mha_step.py::mha_decode_ctx``.

The cache is JAX's flat layout: slot ``l`` of row ``b`` holds the head-flat
(H * Dh) projection row, so a slot's heads are contiguous. The attention
runs over the stale-slot-masked cache plus an explicit self-term for the
fresh token's K/V, which the caller writes to its slot afterwards. An f32
``q`` takes the f32 forms (:func:`mha_decode_ctx_f32`,
:func:`mha_decode_ctx_int8_f32`): the same kernel instantiated on f32.
:func:`quantize_heads` is that write's int8 quantization (plain torch, as the
JAX package leaves it to XLA).

The kernel splits each (row, head)'s slots over a cluster of blocks where
B * H blocks leave the card's SMs idle, and each block's over its four
warps; :func:`mha_plan` is that choice, the warps' rings and the launch's
shared memory, in plain Python so that the CPU tests can pin it, and
:func:`mha_splits` and :func:`mha_parts` the slots each block and warp take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.kernels.decode_plan import SMEM_LIMIT
from apertis_llm_torch.ops.kernels.flash_attention import RESOURCE_KEYS

NEG = -1e30        # additive bias of a masked slot (mha_step.py:51)
# Every multiple of 32 up to 256: lanes of a warp each hold Dh / 32 values
# (csrc). The model serves other head widths through the plain version.
_HEAD_DIMS = (32, 64, 96, 128, 160, 192, 224, 256)


# The launch (csrc/mha_step.cu): blocks of MHA_THREADS threads, each warp
# streaming its contiguous quarter of the block's slots in tiles of about
# MHA_TILE_BYTES of K (twice that in f32; as many of V) through a ring of its
# own, as many stages as the longest warp's tiles, at most MHA_STAGES, and
# within a shared-memory budget a block: MHA_FULL_SMEM where the rows fill
# the card without a split (room for eight blocks an SM), otherwise MHA_SMEM
# or the share of an SM's MHA_SM_SMEM that keeps the grid in one wave;
# a (row, head) splits over up to MHA_MAX_SPLIT blocks (one cluster; above 8
# the non-portable size), each taking at least MHA_SPLIT_SLOTS slots (a float
# cache at up to a third of the SMs' (row, head) pairs MHA_SHORT_SPLIT_SLOTS),
# until B * H * split reaches MHA_BLOCKS_PER_SM blocks an SM.
MHA_THREADS = 128
MHA_WARPS = MHA_THREADS // 32
MHA_STAGES = 8
MHA_TILE_BYTES = 1024
MHA_FULL_SMEM = 28 * 1024
MHA_SMEM = 96 * 1024
MHA_SM_SMEM = 228 * 1024      # shared memory an SM (each block reserves 1 KB of it)
MHA_MAX_SPLIT = 16
MHA_SPLIT_SLOTS = 64
MHA_SHORT_SPLIT_SLOTS = 22
MHA_BLOCKS_PER_SM = 2
_ELEMENT_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}


class MhaPlan(NamedTuple):
    """One launch: ``split`` blocks (a cluster) a (row, head), ``tile``
    slots a warp's ring stage, ``stages`` stages, ``smem`` bytes of dynamic
    shared memory a block and ``grid`` blocks."""
    split: int
    tile: int
    stages: int
    smem: int
    grid: int


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def mha_tile(head_dim: int, cache_bytes: int) -> int:
    """Slots a warp's stage (``csrc/mha_step.cu::Geo::kTile``): the largest
    power of two whose K heads fit in MHA_TILE_BYTES (twice that for an f32
    cache), or one score pass if that is more (32 over the lanes a slot: its
    16-byte chunks' largest power-of-two factor, at most 32)."""
    row = head_dim * cache_bytes
    chunks = row // 16
    slots_pass = 32 // min(32, chunks & -chunks)
    tile = 1
    while 2 * tile <= MHA_TILE_BYTES * (2 if cache_bytes == 4 else 1) // row:
        tile *= 2
    return max(tile, slots_pass)


def mha_stages(length: int, split: int, tile: int, most: int = MHA_STAGES) -> int:
    """A warp's ring stages: the longest warp's tiles (a warp takes a
    quarter of its block's slots), from 1 to ``most``."""
    slots = -(-(-(-length // split)) // MHA_WARPS)
    return max(1, min(most, -(-slots // tile)))


def mha_smem(head_dim: int, cache_bytes: int, quant: bool, split: int, stages: int) -> int:
    """Dynamic shared memory a block (``Geo::smem``): rank 0's slots for
    each of the cluster's warps' max, sum and context, then each warp's
    region: the scores of the slots its ring holds, the scaled q (and its
    int8 levels) and its ring (each stage a tile of K and V heads, the
    tile's bias and, int8, its scales). It grows with L only up to
    MHA_STAGES stages."""
    tile = mha_tile(head_dim, cache_bytes)
    stage = 2 * tile * head_dim * cache_bytes + (3 if quant else 1) * _round16(tile * 4)
    warp = (_round16(stages * tile * 4) + head_dim * 4 + (head_dim if quant else 0)
            + stages * stage)
    return _round16(split * MHA_WARPS * (2 + head_dim) * 4) + MHA_WARPS * warp


def mha_splits(length: int, split: int) -> List[Tuple[int, int]]:
    """The slots [start, end) of each of a (row, head)'s ``split`` blocks,
    in rank order: block r takes [r * L // split, (r + 1) * L // split)."""
    return [(r * length // split, (r + 1) * length // split) for r in range(split)]


def mha_parts(length: int, split: int) -> List[Tuple[int, int]]:
    """The slots [start, end) of each warp of each block, in the order the
    combine adds them (rank, then warp): warp w of a block of n slots from
    s takes [s + w * n // 4, s + (w + 1) * n // 4), possibly none."""
    return [(s + w * (e - s) // MHA_WARPS, s + (w + 1) * (e - s) // MHA_WARPS)
            for s, e in mha_splits(length, split) for w in range(MHA_WARPS)]


@functools.lru_cache(maxsize=None)
def mha_plan(batch: int, heads: int, length: int, head_dim: int, cache_dtype,
             row_dtype, sms: int = 132, split: Optional[int] = None) -> MhaPlan:
    """The launch of #9 for B rows, H heads of ``head_dim`` and L slots of a
    ``cache_dtype`` cache (bf16, f32, int8) under ``row_dtype`` rows (bf16,
    f32) on a card of ``sms`` SMs: one block a (row, head) where B * H
    blocks reach MHA_BLOCKS_PER_SM an SM or L holds fewer than 2 *
    MHA_SPLIT_SLOTS slots; else as many blocks a (row, head) as bring B * H
    * split to MHA_BLOCKS_PER_SM * ``sms``, at most MHA_MAX_SPLIT and each
    with at least MHA_SPLIT_SLOTS slots, or MHA_SHORT_SPLIT_SLOTS for a
    float cache at up to ``sms`` / 3 pairs (on the H100, ``chip_smoke.py
    --mha-times``' sweep over splits: four blocks take a float cache of 88
    slots at batch 1 faster than one, an int8 cache's or 152 pairs' not),
    or ``split`` where given; each warp's ring as
    many stages as its tiles, within the budget (at least two where a warp
    streams more tiles than its ring holds)."""
    cache, rows = _dtype_name(cache_dtype), _dtype_name(row_dtype)
    if cache not in _ELEMENT_BYTES or rows not in ("bfloat16", "float32"):
        raise ValueError(f"mha_plan: no kernel for a {cache} cache under {rows} rows")
    if cache != "int8" and cache != rows:
        raise ValueError(f"mha_plan: a {cache} cache under {rows} rows")
    pairs = batch * heads
    target = MHA_BLOCKS_PER_SM * sms
    if split is None:
        least = (MHA_SHORT_SPLIT_SLOTS if cache != "int8" and 3 * pairs <= sms
                 else MHA_SPLIT_SLOTS)
        split = 1
        if pairs < target:
            split = max(1, min(MHA_MAX_SPLIT, -(-target // pairs), length // least))
    cache_bytes = _ELEMENT_BYTES[cache]
    tile = mha_tile(head_dim, cache_bytes)
    per_sm = -(-pairs * split // sms)
    budget = (MHA_FULL_SMEM if pairs >= target
              else min(MHA_SMEM, MHA_SM_SMEM // per_sm - 1024))
    most = 2
    while (most < MHA_STAGES and mha_smem(head_dim, cache_bytes, cache == "int8", split,
                                          most + 1) <= budget):
        most += 1
    stages = mha_stages(length, split, tile, most)
    return MhaPlan(split, tile, stages,
                   mha_smem(head_dim, cache_bytes, cache == "int8", split, stages),
                   pairs * split)


def mha_resources(form: int, head_dim: int, split: int = 1,
                  stages: int = MHA_STAGES) -> Dict[str, int]:
    """What the card gives the kernel's instance ``form`` (0: bf16 cache; 1:
    int8 cache; 2: f32; 3: f32 over an int8 cache) at ``head_dim``,
    ``split`` and ``stages``: registers a thread, shared memory a block in
    bytes, resident blocks an SM, threads a block and spilled bytes a
    thread."""
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = _build.load_library().apertis_mha_decode_ctx_resources(
        form, head_dim, split, stages, ctypes.addressof(out))
    _build.check(err, "mha_resources")
    return dict(zip(RESOURCE_KEYS, out))


def kernel_takes(head_dim: int) -> bool:
    """Whether the kernel serves heads of ``head_dim``: a multiple of 32 up
    to 256."""
    return head_dim in _HEAD_DIMS


def quantize_heads(t: torch.Tensor, head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per head segment of the trailing axis (D = H * Dh):
    ``(q int8, same shape; scale f32, shape[:-1] + (H,))`` with ``scale =
    max(absmax, 1e-8) * (1/127)`` and ``q = clip(round(t / scale), +-127)``
    (``mha_step.py::quantize_heads``); ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    lead = t.shape[:-1]
    heads = t.shape[-1] // head_dim
    tf = t.float().reshape(*lead, heads, head_dim)
    scale = torch.clamp(tf.abs().amax(dim=-1), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(t.shape), scale


def mha_decode_ctx_reference(
    q: torch.Tensor,          # (B, D) head-flat, post-RoPE, not yet scaled
    k: torch.Tensor,          # (B, L, D) cache of one layer (float, or int8 with scales)
    v: torch.Tensor,          # (B, L, D)
    k_new: torch.Tensor,      # (B, D) the fresh token's key (self-term)
    v_new: torch.Tensor,      # (B, D)
    bias: torch.Tensor,       # (B, L) additive f32: 0 valid, NEG masked
    head_dim: int,
    k_scale: Optional[torch.Tensor] = None,   # (B, H, L) f32 per-(head, slot) scales
    v_scale: Optional[torch.Tensor] = None,   # (B, H, L) f32
) -> torch.Tensor:
    """The TPU kernel's arithmetic (mha_step.py:54-127, 146-215), per row and
    head: ``q`` scaled by ``head_dim ** -0.5`` in f32 and cast back to its
    dtype; the self-term score ``sum q * k_new`` in f32; cached scores
    ``sum q * k`` in f32, or with an int8 cache ``f32(int32 sum q_i * k) *
    (ks * qs)`` where ``q_i``, ``qs`` quantize q per head; ``+ bias``; a
    softmax whose denominator includes the self-term; an int8 cache's V
    scales folded into the probabilities; ``ctx = sum p * v + p_self *
    v_new`` in f32, times ``1 / denom``, cast to q's dtype. Returns (B, D)."""
    b, d = q.shape
    l = k.shape[1]
    heads = d // head_dim
    qs = (q.float() * head_dim ** -0.5).to(q.dtype)
    qh = qs.float().reshape(b, heads, head_dim)
    s_self = (qh * k_new.float().reshape(b, heads, head_dim)).sum(dim=-1)   # (B, H)
    kh = k.reshape(b, l, heads, head_dim).float()
    if k_scale is None:
        q_c = qs.to(k.dtype).float().reshape(b, heads, head_dim)
        s = torch.einsum("bhd,blhd->bhl", q_c, kh)
    else:
        qscale = torch.clamp(qh.abs().amax(dim=-1), min=1e-8) * (1.0 / 127.0)    # (B, H)
        q_i = torch.clamp(torch.round(qh / qscale[..., None]), -127, 127)
        # int8 x int8 sums of at most 256 terms stay below 2^24: exact in f32.
        s = torch.einsum("bhd,blhd->bhl", q_i, kh) * (k_scale * qscale[..., None])
    s = s + bias[:, None, :].float()
    m = torch.maximum(s.amax(dim=-1), s_self)                               # (B, H)
    p = torch.exp(s - m[..., None])
    p_self = torch.exp(s_self - m)
    denom = p.sum(dim=-1) + p_self
    if v_scale is not None:
        p = p * v_scale
    ctx = torch.einsum("bhl,blhd->bhd", p, v.reshape(b, l, heads, head_dim).float())
    ctx = ctx + p_self[..., None] * v_new.float().reshape(b, heads, head_dim)
    return (ctx * (1.0 / denom)[..., None]).reshape(b, d).to(q.dtype)


def _launch(q, k, v, k_new, v_new, bias, head_dim, k_scale, v_scale, name, f32=False,
            split=None):
    """Check the operands and launch the kernel of ``name``'s form on the
    plan (or on ``split`` blocks a (row, head), with the stages the plan
    would give them, for a check of each split the plan may choose)."""
    b, d = q.shape
    l = k.shape[1]
    dev = q.device
    if head_dim not in _HEAD_DIMS or d % head_dim:
        raise ValueError(f"{name}: head_dim {head_dim} not in {_HEAD_DIMS} or D={d} "
                         "not a multiple of it")
    if b == 0 or l == 0:
        raise ValueError(f"{name}: empty shape B={b} L={l}")
    heads = d // head_dim
    f32s = (torch.float32,)
    rows = f32s if f32 else (torch.bfloat16,)
    cache_dtype = (torch.int8,) if k_scale is not None else rows
    for t, shape, dtypes, label in ((q, (b, d), rows, "q"), (k, (b, l, d), cache_dtype, "k"),
                                    (v, (b, l, d), cache_dtype, "v"),
                                    (k_new, (b, d), rows, "k_new"),
                                    (v_new, (b, d), rows, "v_new"), (bias, (b, l), f32s, "bias")):
        _build.check_tensor(t, shape, dtypes, label, dev)
    if k_scale is not None:
        _build.check_tensor(k_scale, (b, heads, l), f32s, "k_scale", dev)
        _build.check_tensor(v_scale, (b, heads, l), f32s, "v_scale", dev)
    _build.check_aligned(name, k, v)
    plan = mha_plan(b, heads, l, head_dim, k.dtype, q.dtype, _build.sm_count(dev.index), split)
    out = torch.empty((b, d), dtype=rows[0], device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            bias.data_ptr())
    if f32:
        scales = (None, None) if k_scale is None else (k_scale.data_ptr(), v_scale.data_ptr())
        err = lib.apertis_mha_decode_ctx_f32(*ptrs, *scales, out.data_ptr(), b, l, heads,
                                             head_dim, plan.split, plan.stages, stream)
    elif k_scale is None:
        err = lib.apertis_mha_decode_ctx(*ptrs, out.data_ptr(), b, l, heads, head_dim,
                                         plan.split, plan.stages, stream)
    else:
        err = lib.apertis_mha_decode_ctx_int8(*ptrs, k_scale.data_ptr(), v_scale.data_ptr(),
                                              out.data_ptr(), b, l, heads, head_dim, plan.split,
                                              plan.stages, stream)
    _build.check(err, name)
    return out


def mha_decode_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, bias: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Decode attention over a float cache: kernel on CUDA tensors, plain
    version on CPU ones. The kernel takes contiguous bf16 ``q``, ``k_new``,
    ``v_new`` (B, D) and cache ``k``, ``v`` (B, L, D), f32 ``bias`` (B, L),
    and ``head_dim`` a multiple of 32 up to 256; it returns bf16 (B, D). An
    f32 ``q`` goes to the f32 form :func:`mha_decode_ctx_f32`."""
    if q.device.type == "cpu":
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, head_dim)
    if q.dtype == torch.float32:
        return mha_decode_ctx_f32(q, k, v, k_new, v_new, bias, head_dim)
    out = _launch(q, k, v, k_new, v_new, bias, head_dim, None, None, "mha_decode_ctx")
    mha_decode_ctx.launches += 1
    return out


def mha_decode_ctx_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor, bias: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor,
                        head_dim: int) -> torch.Tensor:
    """Decode attention over an int8 cache with f32 per-(head, slot) scales
    ``k_scale``, ``v_scale`` (B, H, L): kernel on CUDA tensors, plain version
    on CPU ones. Otherwise as :func:`mha_decode_ctx`."""
    if q.device.type == "cpu":
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, head_dim,
                                        k_scale, v_scale)
    if q.dtype == torch.float32:
        return mha_decode_ctx_int8_f32(q, k, v, k_new, v_new, bias, k_scale, v_scale, head_dim)
    out = _launch(q, k, v, k_new, v_new, bias, head_dim, k_scale, v_scale,
                  "mha_decode_ctx_int8")
    mha_decode_ctx_int8.launches += 1
    return out


def mha_decode_ctx_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, bias: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The f32 form over an f32 cache (``csrc/mha_step.cu``,
    ``apertis_mha_decode_ctx_f32``): f32 ``q``, ``k_new``, ``v_new`` and
    cache, f32 output; otherwise as :func:`mha_decode_ctx`. Plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, head_dim)
    out = _launch(q, k, v, k_new, v_new, bias, head_dim, None, None, "mha_decode_ctx_f32",
                  f32=True)
    mha_decode_ctx_f32.launches += 1
    return out


def mha_decode_ctx_int8_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor, bias: torch.Tensor,
                            k_scale: torch.Tensor, v_scale: torch.Tensor,
                            head_dim: int) -> torch.Tensor:
    """The f32 form over an int8 cache with its f32 scales: f32 ``q``,
    ``k_new``, ``v_new`` and output; otherwise as :func:`mha_decode_ctx_int8`.
    Plain version on CPU tensors."""
    if q.device.type == "cpu":
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, head_dim,
                                        k_scale, v_scale)
    out = _launch(q, k, v, k_new, v_new, bias, head_dim, k_scale, v_scale,
                  "mha_decode_ctx_int8_f32", f32=True)
    mha_decode_ctx_int8_f32.launches += 1
    return out


mha_decode_ctx.launches = 0
mha_decode_ctx_int8.launches = 0
mha_decode_ctx_f32.launches = 0
mha_decode_ctx_int8_f32.launches = 0
