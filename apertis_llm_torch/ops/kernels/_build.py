"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The kernels are plain CUDA C++ with a C interface (``csrc/*.cu``). At first
use each source is compiled for ``sm_90a`` by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library under
``apertis_llm_torch/_build/``, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once.
The library is loaded with ``ctypes``: every pointer and the stream are
``c_void_p`` and every entry point returns ``cudaGetLastError()``.

Only sources in this package are compiled; nothing is fetched.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT / "_build"
SOURCES = ("ssm_scan.cu", "ssm_step.cu", "ffn_fused.cu", "ln_quant.cu", "moe_ffn.cu",
           "moe_grouped.cu", "mha_step.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "flash_attention_f32.cu", "quant_matmul.cu", "moe_dense.cu", "scan_carry.cu")
HEADERS = ("common.cuh", "hopper.cuh", "decode_gemm.cuh", "quant_ffn.cuh", "chunk_scan.cuh",
           "simt.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# No fast math: rintf, division and sqrtf round as IEEE-754 says, which the
# int8 quantizations rely on.
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # delta, a_cont, b_term, c_mod, mask, y, h_last, h_all, scratch, B, L, H,
    # N, chunk, bc_bf16, y_bf16, stream
    "apertis_selective_scan_fwd": [_P] * 9 + [_I] * 7 + [_P],
    # delta, a_cont, c_mod, mask, h_all, gy, g_last, d_delta, da, db, dc,
    # scratch, B, L, H, N, chunk, bc_bf16, gy_bf16, stream
    "apertis_selective_scan_bwd": [_P] * 12 + [_I] * 7 + [_P],
    "apertis_selective_scan_bwd_smem": [_P] * 12 + [_I] * 7 + [_P],
    # a, b, h_init, h, h_last, states, scratch, B*H, L, N, chunk, b_bf16,
    # stream
    "apertis_scan_carry_fwd": [_P] * 7 + [_I] * 5 + [_P],
    # a, g, h, h_init, g_last, da, db, dh_init, scratch, B*H, L, N, chunk,
    # stream
    "apertis_scan_carry_bwd": [_P] * 9 + [_I] * 4 + [_P],
    # 21 inputs, 6 outputs, scratch, B, D, C, K, R, H, N, E, rms, eps,
    # row_tile, splits (3 ints), stages (3 ints), stream
    "apertis_ssm_decode_step": [_P] * 28 + [_I] * 9 + [_F, _I, _P, _P, _P],
    # 25 inputs, 6 outputs, scratch, B, D, C, K, R, H, N, E, rms, eps,
    # row_tile, splits (3 ints), stages (3 ints), stream
    "apertis_ssm_decode_step_int8": [_P] * 32 + [_I] * 9 + [_F, _I, _P, _P, _P],
    # the f32 form: 25 inputs, 6 outputs, scratch, B, D, C, K, R, H, N, E,
    # rms, eps, quant, then the dtype codes of h, the conv cache, the small
    # weights and the projections, stream
    "apertis_ssm_decode_step_f32": [_P] * 32 + [_I] * 9 + [_F] + [_I] * 5 + [_P],
    # B, D, C, R: the bytes of the f32 form's scratch
    "apertis_ssm_step_f32_scratch": [_I] * 4,
    # B, D, C, R, int8: the bytes of a step's scratch
    "apertis_ssm_step_scratch": [_I] * 5,
    # kernel (0 in, 1 mix, 2 out int8; 3, 4, 5 bf16), row_tile, smem, out (5 ints)
    "apertis_ssm_step_resources": [_I, _I, _I, _P],
    # x, w1, b1, w2, b2, out, hidden, S, D, I, act, row_tile, split_up,
    # split_down, stages_up, stages_down, stream
    "apertis_ffn_decode": [_P] * 7 + [_I] * 9 + [_P],
    # x, w1, b1, w2, b2, out, hidden, S, D, I, act, then the dtype codes of
    # x, w1, b1, w2, b2 and out, stream
    "apertis_ffn_decode_f32": [_P] * 7 + [_I] * 10 + [_P],
    # x_q, x_s, w1_q, w1_s, b1, w2_q, w2_s, b2, out, h, hq, hs, S, D, I, bn,
    # act, the dtype codes of b1, b2 and out, stream
    "apertis_ffn_decode_int8_f32": [_P] * 12 + [_I] * 8 + [_P],
    # x_q, x_s, w1_q, w1_s, b1, w2_q, w2_s, b2, out, hq, hs, S, D, I, bn, act,
    # row_tile, split, stages_up, stages_down, stream
    "apertis_ffn_decode_int8": [_P] * 11 + [_I] * 9 + [_P],
    # x_q, x_s, w1_q4, w1_sh, w1_s, b1, w2_q4, w2_sh, w2_s, b2, out, hq, hs,
    # S, D, I, bn, act, row_tile, split, stages_up, stages_down, stream
    "apertis_ffn_decode_int4": [_P] * 13 + [_I] * 9 + [_P],
    # kernel (0 up int8, 1 down int8, 2 up int4, 3 down int4, 4 up bf16,
    # 5 down bf16), row_tile, smem, out (5 ints)
    "apertis_ffn_quant_resources": [_I, _I, _I, _P],
    # x, w, b, q, scale, rows, H, the plan (vec, threads a row, vectors a
    # thread), rms, eps, stream
    "apertis_ln_quantize": [_P] * 5 + [_I] * 6 + [_F, _P],
    # vec, threads a row, vectors a thread, out (5 ints)
    "apertis_ln_quantize_resources": [_I, _I, _I, _P],
    # x, w, b, q, scale, rows, H, the weights' dtype code, rms, eps, stream
    "apertis_ln_quantize_f32": [_P] * 5 + [_I] * 4 + [_F, _P],
    # x_q, x_s, comb, w1t_q, w1t_s, b1t, w2t_q, w2t_s, out, hq, hs, hidden,
    # absmax, S, H, E*I, E, bn, act, row_tile, up_cluster, split, group,
    # stages_up, stages_down, stream
    "apertis_expert_ffn_fat": [_P] * 13 + [_I] * 12 + [_P],
    # x_q, x_s, comb, w1t_q4, w1t_sh, w1t_s, b1t, w2t_q4, w2t_sh, w2t_s, out,
    # hq, hs, hidden, absmax, S, H, E*I, E, bn, act, the plan (6 ints), stream
    "apertis_expert_ffn_fat_int4": [_P] * 15 + [_I] * 12 + [_P],
    # kernel (0 up int8, 1 down int8, 2 up int4, 3 down int4, 4 the wide
    # form's requantization), row_tile, smem, out (5 ints)
    "apertis_expert_ffn_fat_resources": [_I, _I, _I, _P],
    # x_q, x_s, emap, w1t_q, w1t_s, b1t, w2t_q, w2t_s, out, hq, hs, hidden,
    # absmax, P, H, E*I, E, act, row_tile, split, stages_up, stages_down,
    # stream
    "apertis_expert_ffn_grouped": [_P] * 13 + [_I] * 9 + [_P],
    # q, k, v, k_new, v_new, bias, out, B, L, H, head_dim, stream
    "apertis_mha_decode_ctx": [_P] * 7 + [_I] * 4 + [_P],
    # q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, head_dim, stream
    "apertis_mha_decode_ctx_int8": [_P] * 9 + [_I] * 4 + [_P],
    # q, k, v, k_new, v_new, bias, ks, vs (NULL for an f32 cache), out, B, L,
    # H, head_dim, stream
    "apertis_mha_decode_ctx_f32": [_P] * 9 + [_I] * 4 + [_P],
    # q, k, v, out, lse, B*H, L, head_dim, causal, stream
    "apertis_flash_attention_fwd": [_P] * 5 + [_I] * 4 + [_P],
    # q, k, v, dout, lse, delta, dq, B*H, L, head_dim, causal, stream
    "apertis_flash_attention_dq": [_P] * 7 + [_I] * 4 + [_P],
    # q, k, v, dout, lse, delta, dk, dv, B*H, L, head_dim, causal, stream
    "apertis_flash_attention_dkv": [_P] * 8 + [_I] * 4 + [_P],
    "apertis_flash_attention_fwd_f32": [_P] * 5 + [_I] * 4 + [_P],
    "apertis_flash_attention_dq_f32": [_P] * 7 + [_I] * 4 + [_P],
    "apertis_flash_attention_dkv_f32": [_P] * 8 + [_I] * 4 + [_P],
    # kernel (0 forward, 1 dQ, 2 dK/dV), head_dim, out (5 ints)
    "apertis_flash_attention_resources": [_I, _I, _P],
    # x_q, x_s, w_q, w_s, bias (or NULL), out, M, N, K, out_bf16, then the
    # tile plan (rows, split, tma_x, tma_w), stream
    "apertis_quant_matmul_dyn": [_P] * 6 + [_I] * 8 + [_P],
    # x, w_q, w_s, bias (or NULL), out, M, N, K, x_bf16, the tile plan, stream
    "apertis_quant_matmul": [_P] * 5 + [_I] * 8 + [_P],
    # w8a8, rows, split, out (5 ints)
    "apertis_quant_matmul_resources": [_I, _I, _I, _P],
    # x, w_q, w_s, bias (or NULL), out, x_q and x_s scratch, M, N, K, x_bf16,
    # then the plan (rows, split, group, stages, tma_w), stream
    "apertis_quant_matmul_dyn_fused": [_P] * 7 + [_I] * 9 + [_P],
    # kernel (0 quantization pass, 1 block-scaled qm_kernel, 2 split), rows,
    # smem, out (5 ints)
    "apertis_quant_matmul_fused_resources": [_I, _I, _I, _P],
    # xq, xs, w1q, w1s, b1, w2q, w2s, b2, out, hq, hs, hidden, absmax, S, H,
    # I, E, act, out_bf16, row_tile, split, stages_up, stages_down, stream
    "apertis_expert_ffn_dense": [_P] * 13 + [_I] * 10 + [_P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use on a "
        "machine with the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libapertis_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has not been built yet; return
    the library's path. The compilers' output (with ``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept beside it as ``.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, src + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp = os.path.join(work, "lib.so")
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        path.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, path)   # atomic: a concurrent build never sees a partial file
    return path


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SMs of CUDA device ``device_index``, which the launch plans are
    sized by."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_aligned(name: str, *tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary, for kernels
    that load 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


FLOAT_DTYPES = ("float32", "bfloat16")


def float_code(t, name: str) -> int:
    """The dtype code of a float operand of the f32 forms (``csrc/simt.cuh``):
    1 for bf16, 0 for f32; any other dtype raises."""
    if str(t.dtype).split(".")[-1] not in FLOAT_DTYPES:
        raise ValueError(f"{name}: dtype {t.dtype} is not f32 or bf16")
    return int(str(t.dtype) == "torch.bfloat16")


def check_tensor(t, shape, dtypes, name: str, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` of this
    shape and one of these dtypes: what every kernel wrapper checks before a
    launch."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
