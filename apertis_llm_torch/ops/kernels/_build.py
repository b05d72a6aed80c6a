"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The kernels are plain CUDA C++ with a C interface (``csrc/*.cu``). At first
use they are compiled in one ``nvcc`` call for ``sm_90a`` into a shared
library under ``apertis_llm_torch/_build/``, named by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads at once.
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
SOURCES = ("ssm_scan.cu", "ssm_step.cu", "ffn_fused.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # delta, a_cont, b_term, c_mod, mask, y, h_last, B, L, H, N, bc_bf16,
    # y_bf16, stream
    "apertis_selective_scan_fwd": [_P] * 7 + [_I] * 6 + [_P],
    # 17 inputs, 4 outputs, 4 scratch, B, D, C, K, R, H, N, rms, eps, stream
    "apertis_ssm_decode_step": [_P] * 25 + [_I] * 8 + [_F, _P],
    # x, w1, b1, w2, b2, out, partial, S, D, I, chunks_per_part, act, stream
    "apertis_ffn_decode": [_P] * 7 + [_I] * 5 + [_P],
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
    the library's path. The compiler's output (with ``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept beside it as ``.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    path.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, path)   # atomic: concurrent builders never see a partial file
    return path


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


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
