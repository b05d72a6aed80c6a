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
the RoPE tables are derived, not loaded. A multimodal tree's ``vision``
subtree stacks its layers over ``vision_layers``: ``vision/layers/ln1/w[i]``
becomes ``vision.layers.{i}.ln1.w``; its linears and ``vision_proj`` are
int8 or float together (``params.py::vision_quantized_layout``), whatever
the decoder's layout.

The export half (``apertis_llm_tpu/models/convert.py:295-411``):
:func:`params_tree` turns the model back into the stacked tree,
:func:`to_torch_state_dict` maps a float tree onto the reference model's
``state_dict`` names and layouts, and :func:`save_torch_checkpoint` writes it
as ``pytorch_model.bin`` with ``config.json``, which the JAX package's
``load_pretrained`` and the reference load. Loading a base model for
fine-tuning (``load_pretrained``) is not ported yet (ROADMAP.md, module 6).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.apertis import ApertisForCausalLM
from apertis_llm_torch.models.params import quantized_layout, vision_quantized_layout

# The stacked subtrees: their leaves carry a leading axis of per-layer
# tensors, of this config field's length.
_STACKED = (("layers.", "num_hidden_layers"), ("vision.layers.", "vision_layers"))


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
    the leading layer axes (``layers``, and a ViT's ``vision.layers``); int8
    weights and their f32 scales keep their dtypes. Raises if the tree and
    the model do not have the same names and shapes, and
    ``NotImplementedError`` for a tree whose projections, or whose ViT
    linears, are part int8 and part float."""
    model = ApertisForCausalLM(config, device=device, dtype=dtype,
                               quantized=quantized_layout(tree),
                               int8_head="lm_head" in tree,
                               vision_quantized=vision_quantized_layout(tree))
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
        items = [(path, src)]
        for prefix, field in _STACKED:
            if path.startswith(prefix):
                n = getattr(config, field)
                if src.shape[0] != n:
                    raise ValueError(f"{path}: leading axis {src.shape[0]} is not "
                                     f"{field}={n}")
                rest = path[len(prefix):]
                items = [(f"{prefix}{i}.{rest}", src[i]) for i in range(n)]
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


def params_tree(model: ApertisForCausalLM) -> Dict[str, Any]:
    """The model's parameters as the JAX package's nested tree, per-layer
    tensors stacked on a leading layer axis: the inverse of
    :func:`from_jax_params`. Leaves are detached copies on the model's
    device in their own dtypes."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[Tuple[str, str], Dict[int, torch.Tensor]] = {}

    def put(path, value):
        node = tree
        *keys, leaf = path.split(".")
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = value

    for name, p in model.named_parameters():
        for prefix, _ in _STACKED:
            if name.startswith(prefix):
                idx, rest = name[len(prefix):].split(".", 1)
                per_layer.setdefault((prefix, rest), {})[int(idx)] = p.detach()
                break
        else:
            put(name, p.detach().clone())
    for (prefix, rest), leaves in per_layer.items():
        put(prefix + rest, torch.stack([leaves[i] for i in sorted(leaves)]))
    return tree


def to_torch_state_dict(params: Dict[str, Any], config: ApertisConfig) -> Dict[str, torch.Tensor]:
    """The reference model's ``state_dict`` (f32 CPU tensors) of a float
    tree, as ``apertis_llm_tpu/models/convert.py::to_torch_state_dict``
    writes it: linear weights transposed to (out, in), the conv taps as (C,
    1, K), the tied head as ``lm_head.weight``, and a ViT's tree under
    ``model.multimodal_encoder`` and ``model.vision_projection``."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, val, transpose=False):
        if isinstance(val, torch.Tensor):
            t = val.detach().float().cpu()
        else:
            t = torch.from_numpy(np.asarray(val, dtype=np.float32))
        sd[key] = t.T.contiguous() if transpose else t.contiguous()

    def put_norm(prefix, p):
        if "scale" in p:
            put(f"{prefix}.scale", p["scale"])
        else:
            put(f"{prefix}.weight", p["w"])
            put(f"{prefix}.bias", p["b"])

    def put_linear(prefix, p):
        put(f"{prefix}.weight", p["w"], transpose=True)
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    put("model.token_embeddings.weight", params["embed"]["tok"])
    for i in range(config.num_hidden_layers):
        lp = layer(params["layers"], i)
        a, f = lp["attn"], lp["ffn"]
        pre = f"model.layers.{i}.attention"
        put_norm(f"{pre}.pre_norm", a["pre_norm"])
        if config.attention_type == "selective_ssm":
            impl = f"{pre}.attention_mechanism_impl"
            put_linear(f"{impl}.in_proj_x", a["in_proj_x"])
            put_linear(f"{impl}.in_proj_z", a["in_proj_z"])
            put(f"{impl}.conv1d.weight", a["conv"]["w"][:, None, :])
            put(f"{impl}.conv1d.bias", a["conv"]["b"])
            put_linear(f"{impl}.x_param_proj", a["x_param_proj"])
            put_linear(f"{impl}.dt_proj_head", a["dt_proj"])
            put(f"{impl}.A_log", a["A_log"])
            put(f"{impl}.D", a["D"])
            put_linear(f"{impl}.out_proj", a["out_proj"])
        else:
            put_linear(f"{pre}.q_proj", a["q"])
            put_linear(f"{pre}.k_proj", a["k"])
            put_linear(f"{pre}.v_proj", a["v"])
            put_linear(f"{pre}.out_proj", a["o"])
        pre = f"model.layers.{i}.feed_forward"
        put_norm(f"{pre}.pre_norm", f["pre_norm"])
        if "experts" in f:
            put(f"{pre}.ffn.router_norm.weight", f["router_ln"]["w"])
            put(f"{pre}.ffn.router_norm.bias", f["router_ln"]["b"])
            put_linear(f"{pre}.ffn.router", f["router"])
            if "w_noise" in f:
                put(f"{pre}.ffn.w_noise", f["w_noise"])
            ex = f["experts"]
            for j in range(config.num_experts):
                put(f"{pre}.ffn.experts.{j}.0.weight", ex["ln_w"][j])
                put(f"{pre}.ffn.experts.{j}.0.bias", ex["ln_b"][j])
                put(f"{pre}.ffn.experts.{j}.1.weight", ex["w1"][j], transpose=True)
                put(f"{pre}.ffn.experts.{j}.1.bias", ex["b1"][j])
                put(f"{pre}.ffn.experts.{j}.4.weight", ex["w2"][j], transpose=True)
                put(f"{pre}.ffn.experts.{j}.4.bias", ex["b2"][j])
        else:
            put_linear(f"{pre}.ffn.0", f["w1"])
            put_linear(f"{pre}.ffn.3", f["w2"])
    put_norm("model.final_post_norm", params["final_norm"])
    put("lm_head.weight", params["embed"]["tok"])    # tied
    if "vision" in params:
        # The ViT (convert.py:371-397): the patch embedding as the
        # reference's Conv2d weight (dv, 3, P, P), the layers as
        # TransformerEncoderLayer's names.
        v = params["vision"]
        pre, dv, p = "model.multimodal_encoder", config.vision_embed_dim, config.vision_patch_size
        pw = v["patch_embed"]["w"]
        pw = pw if isinstance(pw, torch.Tensor) else torch.from_numpy(np.asarray(pw))
        put(f"{pre}.patch_embed.weight", pw.T.reshape(dv, 3, p, p))
        put(f"{pre}.patch_embed.bias", v["patch_embed"]["b"])
        put(f"{pre}.cls_token", v["cls_token"])
        put(f"{pre}.vision_pos_embed", v["pos_embed"])
        for i in range(config.vision_layers):
            vl = layer(v["layers"], i)
            lp = f"{pre}.vision_layers.{i}"
            put(f"{lp}.norm1.weight", vl["ln1"]["w"])
            put(f"{lp}.norm1.bias", vl["ln1"]["b"])
            put(f"{lp}.self_attn.in_proj_weight", vl["in_proj_w"], transpose=True)
            put(f"{lp}.self_attn.in_proj_bias", vl["in_proj_b"])
            put_linear(f"{lp}.self_attn.out_proj", vl["attn_out"])
            put(f"{lp}.norm2.weight", vl["ln2"]["w"])
            put(f"{lp}.norm2.bias", vl["ln2"]["b"])
            put_linear(f"{lp}.linear1", vl["linear1"])
            put_linear(f"{lp}.linear2", vl["linear2"])
        put(f"{pre}.vision_ln.weight", v["final_ln"]["w"])
        put(f"{pre}.vision_ln.bias", v["final_ln"]["b"])
        if "vision_proj" in params:
            put_linear("model.vision_projection", params["vision_proj"])
    return sd


def save_torch_checkpoint(params: Dict[str, Any], config: ApertisConfig, save_directory,
                          filename: str = "pytorch_model.bin") -> None:
    """Write a reference-compatible checkpoint (weights + config.json)."""
    save_directory = Path(save_directory)
    save_directory.mkdir(parents=True, exist_ok=True)
    torch.save(to_torch_state_dict(params, config), save_directory / filename)
    config.save_pretrained(save_directory)
