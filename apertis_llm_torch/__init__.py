"""Apertis in PyTorch and CUDA: the port of ``apertis_llm_tpu`` to one NVIDIA
H100.

The package imports torch and never JAX or ``apertis_llm_tpu``. Its layout
mirrors the JAX package's: ``config``, ``models/`` (``apertis``, ``params``,
``convert``, ``factory``), ``ops/`` (norms, activations, ssm, sampling) with
the hand-written kernels under ``ops/kernels/`` and their CUDA sources under
``csrc/``, and ``inference/engine.py``.
"""

from apertis_llm_torch.config import ApertisConfig

__all__ = ["ApertisConfig"]
