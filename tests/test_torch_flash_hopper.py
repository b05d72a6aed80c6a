"""Host-side logic of the Hopper flash kernels, bf16 and f32 (CPU).

The kernels themselves (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/flash_attention_f32.cu``,
``csrc/hopper.cuh``) build and run only on the card, where
``chip_smoke.py`` holds them against their plain versions. Here: the head
widths the wrappers take, the resources query's argument checks and its
kernel codes, and the build's hash over the new header.
"""

import ctypes
import re
import shutil

import pytest

from apertis_llm_torch.ops.kernels import _build
from apertis_llm_torch.ops.kernels.flash_attention import (
    BF16_KERNELS, F32_KERNELS, RESOURCE_KEYS, flash_attention_resources, supported_head_dim)


def test_supported_head_dims_are_multiples_of_8_up_to_256():
    """The bf16 wrappers take every Dh % 8 == 0 up to 256 (whole 16-byte
    rows for the TMA tensor maps) and refuse the rest."""
    taken = [dh for dh in range(-8, 300) if supported_head_dim(dh)]
    assert taken == list(range(8, 257, 8))


@pytest.mark.parametrize("kernel,head_dim", [("backward", 64), ("forward", 60),
                                             ("dq", 264), ("dkv", 0), ("f32", 64),
                                             ("forward_f32", 60), ("dq_f32", 264),
                                             ("dkv_f32", 0)])
def test_resources_refuse_bad_arguments_before_any_build(monkeypatch, kernel, head_dim):
    """An unknown kernel name or an unsupported head width raises
    ValueError without loading (or compiling) the library."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "load_library", no_library)
    with pytest.raises(ValueError):
        flash_attention_resources(kernel, head_dim)


def test_resources_codes_match_the_entry_point(monkeypatch):
    """``flash_attention_resources`` passes kernel code 0, 1, 2 for the bf16
    forward, dQ and dK/dV and 3, 4, 5 for the f32 ones, as
    ``apertis_flash_attention_resources`` reads them (the f32 codes through
    ``flash_f32_resources(code - 3)``: 0 forward, 1 dQ, else dK/dV), and
    returns the five ints it writes under RESOURCE_KEYS."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    body = src[src.index('extern "C" int apertis_flash_attention_resources'):]
    body = body[:body.index("\n}\n")]
    cases = dict(re.findall(r"case (\d):\s*\n(.*?)(?=case \d|default)", body, re.S))
    assert "flash_fwd_resources" in cases["0"]
    assert "flash_dq_kernel" in cases["1"] and "flash_dkv" not in cases["1"]
    assert "flash_dkv_kernel" in cases["2"]
    assert cases["3"].strip() == "" and cases["4"].strip() == ""   # fall through to case 5
    assert "flash_f32_resources(kernel - 3, dh, out)" in cases["5"]
    f32 = (_build.CSRC / "flash_attention_f32.cu").read_text()
    f32 = f32[f32.index("int resources_f32(int kernel, int* out)"):]
    f32 = f32[:f32.index("\n}\n")]
    f32_cases = dict(re.findall(r"(case \d|default):\s*\n(.*?)(?=case \d|default|\Z)", f32, re.S))
    assert "flash_fwd_f32_kernel" in f32_cases["case 0"]
    assert "flash_dq_f32_kernel" in f32_cases["case 1"]
    assert "flash_dkv_f32_kernel" in f32_cases["default"]
    assert _build.SIGNATURES["apertis_flash_attention_resources"] == [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    calls = []

    class Lib:
        @staticmethod
        def apertis_flash_attention_resources(code, head_dim, address):
            calls.append((code, head_dim))
            out = (ctypes.c_int * len(RESOURCE_KEYS)).from_address(address)
            for i in range(len(RESOURCE_KEYS)):
                out[i] = 10 * code + i
            return 0

    monkeypatch.setattr(_build, "load_library", lambda: Lib)
    for code, kernel in enumerate(BF16_KERNELS + F32_KERNELS):
        res = flash_attention_resources(kernel, 72)
        assert res == {key: 10 * code + i for i, key in enumerate(RESOURCE_KEYS)}
    assert calls == [(code, 72) for code in range(6)]


def test_library_hash_covers_the_hopper_header(monkeypatch, tmp_path):
    """The built library is keyed by ``hopper.cuh`` too: an edit of the
    header alone names a new library, so a stale build is never loaded."""
    assert "hopper.cuh" in _build.HEADERS
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before
