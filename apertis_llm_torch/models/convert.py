"""Load a parameter tree named like the JAX package's into the PyTorch model.

The JAX tree (``apertis_llm_tpu/models/params.py``) stacks every per-layer
tensor along a leading layer axis; the model holds one module per layer. So
``layers/attn/in_proj_x/w[i]`` becomes ``layers.{i}.attn.in_proj_x.w``, and
every other leaf keeps its path with dots. Leaves may be numpy arrays (for
example a JAX tree passed through ``np.asarray``) or torch tensors (the tree
``models/params.py::init_params`` builds). This is how the tests make both
packages compute with one set of weights.

A tree from ``quantize_params`` (either package's) builds the int8 model:
``{w_q, w_s}`` leaves become :class:`QuantLinear` parameters of the same
names, taken as they are, and an ``lm_head`` from ``quantize_tied_head``
becomes the model's int8 head. A MoE tree, float or int8, fills the MoE
FFN's parameters by the same names (``layers.{i}.ffn.experts.w1_q``, the
router, and ``w_noise``, which eval does not read); the fat stack the
kernels read is derived from them, not loaded. An MHA tree, float or int8,
fills ``layers.{i}.attn.{q,k,v,o}`` (with their biases ``b`` where the tree
has them, that is when attention dropout is 0); the fused QKV projection and
the RoPE tables are derived, not loaded.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.apertis import ApertisForCausalLM
from apertis_llm_torch.models.params import quantized_layout


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def from_jax_params(tree: Dict[str, Any], config: ApertisConfig, device="cuda",
                    dtype: torch.dtype = torch.float32) -> ApertisForCausalLM:
    """Build the model on ``device`` (the card unless the caller names
    another) in ``dtype`` and copy every leaf of ``tree`` into it, unstacking
    the leading layer axis; int8 weights and their f32 scales keep their
    dtypes. Raises if the tree and the model do not have the same names and
    shapes, and ``NotImplementedError`` for a tree whose projections are part
    int8 and part float."""
    model = ApertisForCausalLM(config, device=device, dtype=dtype,
                               quantized=quantized_layout(tree),
                               int8_head="lm_head" in tree)
    targets = dict(model.named_parameters())
    seen = set()
    for path, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            src = leaf
        else:
            arr = np.asarray(leaf)
            if arr.dtype.name == "bfloat16":     # numpy has no native bf16
                arr = arr.astype(np.float32)
            src = torch.from_numpy(arr)
        if path.startswith("layers."):
            rest = path[len("layers."):]
            if src.shape[0] != config.num_hidden_layers:
                raise ValueError(f"{path}: leading axis {src.shape[0]} is not "
                                 f"num_hidden_layers={config.num_hidden_layers}")
            items = [(f"layers.{i}.{rest}", src[i]) for i in range(src.shape[0])]
        else:
            items = [(path, src)]
        for name, value in items:
            if name not in targets:
                raise KeyError(f"parameter {name!r} has no place in the model")
            if tuple(value.shape) != tuple(targets[name].shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                                 f"{tuple(targets[name].shape)}")
            with torch.no_grad():
                targets[name].copy_(value)
            seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"parameters missing from the tree: {missing}")
    return model
