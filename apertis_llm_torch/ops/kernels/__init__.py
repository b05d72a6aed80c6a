"""Hand-written CUDA kernels (csrc/*.cu), each with its plain PyTorch version.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; it counts its launches in ``<wrapper>.launches``.
"""
