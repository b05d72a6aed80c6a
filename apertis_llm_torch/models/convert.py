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

The import half (``apertis_llm_tpu/models/convert.py:29-288``) reads a
reference-format checkpoint, one written by the reference, by the JAX
package's ``save_torch_checkpoint`` or by this module's:
:func:`load_torch_state_dict` loads the file's tensors,
:func:`from_torch_state_dict` maps the reference's names and layouts back
onto the stacked tree (the ViT's included), :func:`infer_config_from_state_dict`
reads a configuration off the weights' shapes where no ``config.json`` lies
beside them, and :func:`load_pretrained` builds the model from a directory
or a bare weights file, on the card unless the caller names another device.

The export half (``apertis_llm_tpu/models/convert.py:295-411``):
:func:`params_tree` turns the model back into the stacked tree,
:func:`to_torch_state_dict` maps a float tree onto the reference model's
``state_dict`` names and layouts, and :func:`save_torch_checkpoint` writes it
as ``pytorch_model.bin`` with ``config.json``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.apertis import ApertisForCausalLM
from apertis_llm_torch.models.params import (
    check_supported, quantized_layout, vision_quantized_layout)

logger = logging.getLogger(__name__)

# The stacked subtrees: their leaves carry a leading axis of per-layer
# tensors, of this config field's length.
STACKED = (("layers.", "num_hidden_layers"), ("vision.layers.", "vision_layers"))


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
                               int8_head="w_q" in tree.get("lm_head", {}),
                               vision_quantized=vision_quantized_layout(tree))
    copy_tree(model, tree, {prefix: (field, getattr(config, field))
                            for prefix, field in STACKED})
    return model


@torch.no_grad()
def copy_tree(module: torch.nn.Module, tree: Dict[str, Any],
              stacked: Dict[str, Tuple[str, int]]) -> None:
    """Copy every leaf of ``tree`` (numpy arrays or tensors) into the
    parameter of ``module`` with its dotted path, unstacking the leading
    axis of the leaves under each prefix of ``stacked`` (prefix -> (field
    name, length)). Raises unless the names and shapes match one for one."""
    targets = dict(module.named_parameters())
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
        for prefix, (field, n) in stacked.items():
            if path.startswith(prefix):
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
            targets[name].copy_(value)
            seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"parameters missing from the tree: {missing}")


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """The tensors of a torch checkpoint file, on the CPU in their own
    dtypes (a ``{"state_dict": ...}`` wrapper is unwrapped)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.detach() for k, v in state.items()}


def _norm_params(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    if f"{prefix}.scale" in sd:       # RMSNorm
        return {"scale": sd[f"{prefix}.scale"]}
    return {"w": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}


def _linear_params(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """A torch linear (out, in) as the tree's ``{w (in, out), b}``."""
    p = {"w": sd[f"{prefix}.weight"].T.contiguous()}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _stack(trees):
    """Per-layer trees stacked leaf by leaf on a new leading axis."""
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in first.items()}


def _attn_layer(sd, i: int, config: ApertisConfig) -> Dict[str, Any]:
    pre = f"model.layers.{i}.attention"
    p: Dict[str, Any] = {"pre_norm": _norm_params(sd, f"{pre}.pre_norm")}
    if config.attention_type == "selective_ssm":
        impl = f"{pre}.attention_mechanism_impl"
        p["in_proj_x"] = _linear_params(sd, f"{impl}.in_proj_x")
        p["in_proj_z"] = _linear_params(sd, f"{impl}.in_proj_z")
        p["conv"] = {"w": sd[f"{impl}.conv1d.weight"][:, 0, :],      # (C, 1, K) -> (C, K)
                     "b": sd[f"{impl}.conv1d.bias"]}
        p["x_param_proj"] = _linear_params(sd, f"{impl}.x_param_proj")
        p["dt_proj"] = _linear_params(sd, f"{impl}.dt_proj_head")
        p["A_log"] = sd[f"{impl}.A_log"]
        p["D"] = sd[f"{impl}.D"]
        p["out_proj"] = _linear_params(sd, f"{impl}.out_proj")
    else:
        for name, key in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            p[name] = _linear_params(sd, f"{pre}.{key}")
    return p


def _ffn_layer(sd, i: int, config: ApertisConfig) -> Dict[str, Any]:
    pre = f"model.layers.{i}.feed_forward"
    p: Dict[str, Any] = {"pre_norm": _norm_params(sd, f"{pre}.pre_norm")}
    if config.use_swiglu:
        for name in ("w_gate", "w_up", "w_down"):
            p[name] = _linear_params(sd, f"{pre}.ffn.{name}")
    elif config.use_expert_system and config.num_experts > 0:
        p["router_ln"] = {"w": sd[f"{pre}.ffn.router_norm.weight"],
                          "b": sd[f"{pre}.ffn.router_norm.bias"]}
        p["router"] = _linear_params(sd, f"{pre}.ffn.router")
        if f"{pre}.ffn.w_noise" in sd:
            p["w_noise"] = sd[f"{pre}.ffn.w_noise"]
        # Expert Sequential indices: 0 LayerNorm, 1 Linear(H->I), 4 Linear(I->H).
        ex = [f"{pre}.ffn.experts.{j}" for j in range(config.num_experts)]
        p["experts"] = {
            "ln_w": torch.stack([sd[f"{e}.0.weight"] for e in ex]),
            "ln_b": torch.stack([sd[f"{e}.0.bias"] for e in ex]),
            "w1": torch.stack([sd[f"{e}.1.weight"].T for e in ex]),
            "b1": torch.stack([sd[f"{e}.1.bias"] for e in ex]),
            "w2": torch.stack([sd[f"{e}.4.weight"].T for e in ex]),
            "b2": torch.stack([sd[f"{e}.4.bias"] for e in ex]),
        }
    else:
        # Dense FFN Sequential indices: 0 Linear(H->I), 3 Linear(I->H).
        p["w1"] = _linear_params(sd, f"{pre}.ffn.0")
        p["w2"] = _linear_params(sd, f"{pre}.ffn.3")
    return p


def _vision(sd, config: ApertisConfig) -> Dict[str, Any]:
    """The ViT's tree (convert.py:117-147): the reference's Conv2d patch
    embedding (dv, 3, P, P) as the (3 P P, dv) linear, the layers stacked."""
    pre = "model.multimodal_encoder"
    layers = []
    for i in range(config.vision_layers):
        lp = f"{pre}.vision_layers.{i}"
        layers.append({
            "ln1": {"w": sd[f"{lp}.norm1.weight"], "b": sd[f"{lp}.norm1.bias"]},
            "in_proj_w": sd[f"{lp}.self_attn.in_proj_weight"].T.contiguous(),
            "in_proj_b": sd[f"{lp}.self_attn.in_proj_bias"],
            "attn_out": _linear_params(sd, f"{lp}.self_attn.out_proj"),
            "ln2": {"w": sd[f"{lp}.norm2.weight"], "b": sd[f"{lp}.norm2.bias"]},
            "linear1": _linear_params(sd, f"{lp}.linear1"),
            "linear2": _linear_params(sd, f"{lp}.linear2"),
        })
    pw = sd[f"{pre}.patch_embed.weight"]
    return {
        "patch_embed": {"w": pw.reshape(pw.shape[0], -1).T.contiguous(),
                        "b": sd[f"{pre}.patch_embed.bias"]},
        "cls_token": sd[f"{pre}.cls_token"],
        "pos_embed": sd[f"{pre}.vision_pos_embed"],
        "layers": _stack(layers),
        "final_ln": {"w": sd[f"{pre}.vision_ln.weight"], "b": sd[f"{pre}.vision_ln.bias"]},
    }


def from_torch_state_dict(sd: Mapping[str, torch.Tensor],
                          config: ApertisConfig) -> Dict[str, Any]:
    """A reference ``state_dict`` as the stacked tree :func:`from_jax_params`
    takes (``convert.py::from_torch_state_dict``), for the variants the port
    serves (:func:`check_supported` raises for the others): linear weights
    transposed to (in, out), per-layer tensors stacked, the experts' stacked
    on their own axis, SwiGLU's three linears, the absolute position table
    and the untied ``lm_head`` where the config asks for them and the file
    holds them, and the ViT's tree and ``vision_proj`` where the config is
    multimodal and the file holds them."""
    check_supported(config)
    params: Dict[str, Any] = {"embed": {"tok": sd["model.token_embeddings.weight"]}}
    if (config.position_embedding_type == "absolute"
            and "model.abs_pos_embeddings.weight" in sd):
        params["abs_pos"] = {"emb": sd["model.abs_pos_embeddings.weight"]}
    if config.multimodal and "model.multimodal_encoder.patch_embed.weight" in sd:
        params["vision"] = _vision(sd, config)
        if "model.vision_projection.weight" in sd:
            params["vision_proj"] = _linear_params(sd, "model.vision_projection")
    params["layers"] = _stack([{"attn": _attn_layer(sd, i, config),
                                "ffn": _ffn_layer(sd, i, config)}
                               for i in range(config.num_hidden_layers)])
    params["final_norm"] = _norm_params(sd, "model.final_post_norm")
    if not config.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = _linear_params(sd, "lm_head")
    return params


def infer_config_from_state_dict(sd: Mapping[str, torch.Tensor]) -> ApertisConfig:
    """A configuration read off a bare ``state_dict``'s shapes (no
    ``config.json``), by the JAX package's rules (convert.py:150-263, after
    the reference's interface.py:280-341): vocabulary and width from the
    embedding, the layer count, the mixer (SSM heads, state, dt rank and
    conv taps from its tensors; MHA heads of 64), RMSNorm, SwiGLU, the
    experts, the true FFN width and the ViT's width, patch, depth and image
    size; and, where the MHA projections have biases, attention dropout 0,
    which the reference's biases imply (JAX keeps its default there, and its
    linears read the biases from the tree). Beyond JAX's rules, which leave
    these to a ``config.json``, because the port's modules follow the config
    where JAX's code follows the tree: absolute positions and their count
    from ``model.abs_pos_embeddings.weight``, an untied head where
    ``lm_head.weight`` is not the embedding table, and a SwiGLU FFN's width
    (an ``intermediate_size`` whose ``swiglu_ffn_dim`` is ``w_gate``'s,
    JAX's ``hidden * 4`` where that one fits). Every other field keeps its
    default."""
    def shape(key):
        return tuple(sd[key].shape) if key in sd else None

    vocab_size, hidden_size = 32000, 768
    if (s := shape("model.token_embeddings.weight")) is not None:
        vocab_size, hidden_size = int(s[0]), int(s[1])
    elif (s := shape("lm_head.weight")) is not None:
        vocab_size, hidden_size = int(s[0]), int(s[1])

    def indices(marker):
        """The distinct integers that follow ``marker`` in the keys."""
        found = set()
        for k in sd:
            if marker in k:
                head = k.split(marker, 1)[1].split(".")[0]
                if head.isdigit():
                    found.add(int(head))
        return found

    num_layers = len(indices("model.layers.")) or 12

    num_heads = hidden_size // 64 if hidden_size % 64 == 0 else 12
    if hidden_size % num_heads != 0:
        for i in range(num_heads, 0, -1):
            if hidden_size % i == 0:
                num_heads = i
                break

    cfg: Dict[str, Any] = dict(
        vocab_size=vocab_size, hidden_size=hidden_size, num_hidden_layers=num_layers,
        num_attention_heads=num_heads,
        use_rmsnorm="model.final_post_norm.scale" in sd,
        use_swiglu=any(".ffn.w_gate." in k for k in sd),
        multimodal=any("multimodal_encoder" in k or "vision_projection" in k for k in sd))

    if "model.layers.0.attention.q_proj.bias" in sd:
        # The reference gives q/k/v/o biases only at attention dropout 0
        # (``qkv_bias``); the port's modules follow the config, where JAX's
        # linears follow the tree, so the config must say so.
        cfg["attention_probs_dropout_prob"] = 0.0
    if any(".attention_mechanism_impl." in k for k in sd):
        cfg["attention_type"] = "selective_ssm"
        impl = "model.layers.0.attention.attention_mechanism_impl"
        if (a_log := shape(f"{impl}.A_log")) is not None:
            cfg["num_attention_heads"], cfg["ssm_d_state"] = int(a_log[0]), int(a_log[1])
        if (dt := shape(f"{impl}.dt_proj_head.weight")) is not None:
            cfg["ssm_dt_rank"] = int(dt[1])
        if (conv := shape(f"{impl}.conv1d.weight")) is not None:
            cfg["ssm_conv_kernel"] = int(conv[2])

    inter = None
    for key in ("model.layers.0.feed_forward.ffn.0.weight",
                "model.layers.0.feed_forward.ffn.experts.0.1.weight"):
        if (s := shape(key)) is not None:
            inter = int(s[0])
            break
    cfg["intermediate_size"] = inter if inter is not None else hidden_size * 4
    if cfg["use_swiglu"] and (s := shape("model.layers.0.feed_forward.ffn.w_gate.weight")):
        width = int(s[0])
        if ApertisConfig(hidden_size=hidden_size, num_attention_heads=1,
                         intermediate_size=cfg["intermediate_size"]).swiglu_ffn_dim != width:
            # swiglu_ffn_dim rounds 2/3 of the width up to a multiple of 256.
            cfg["intermediate_size"] = width * 3 // 2
    if (pos := shape("model.abs_pos_embeddings.weight")) is not None:
        cfg["position_embedding_type"] = "absolute"
        cfg["max_position_embeddings"] = int(pos[0])
    if "lm_head.weight" in sd and "model.token_embeddings.weight" in sd and not torch.equal(
            sd["lm_head.weight"], sd["model.token_embeddings.weight"]):
        cfg["tie_word_embeddings"] = False

    if any(".ffn.experts." in k for k in sd):
        cfg["use_expert_system"] = True
        cfg["num_experts"] = len(indices(".ffn.experts.")) or 8
        cfg["use_noisy_top_k_routing"] = any(".ffn.w_noise" in k for k in sd)

    if (vis := shape("model.multimodal_encoder.patch_embed.weight")) is not None:
        cfg["vision_embed_dim"], cfg["vision_patch_size"] = int(vis[0]), int(vis[2])
        cfg["vision_layers"] = len(indices(".vision_layers.")) or 12
        if (pos := shape("model.multimodal_encoder.vision_pos_embed")) is not None:
            patches = int(pos[1]) - 1
            cfg["image_size"] = int(round(patches ** 0.5)) * cfg["vision_patch_size"]

    logger.info("Inferred config from state_dict: %s", cfg)
    return ApertisConfig.from_dict(cfg)


def load_pretrained(model_dir, device="cuda",
                    dtype: torch.dtype = torch.float32) -> ApertisForCausalLM:
    """The model of a reference-format checkpoint (``convert.py::
    load_pretrained``): a directory with ``config.json`` and
    ``pytorch_model.bin`` or ``model.pt``, or a bare weights file, whose
    configuration is then read off its shapes (:func:`infer_config_from_
    state_dict`) unless a ``config.json`` lies beside it. Built in
    ``dtype`` on ``device``, the card unless the caller names another; its
    configuration is ``model.config``."""
    model_dir = Path(model_dir)
    if model_dir.is_file():
        ckpt, config_dir = model_dir, model_dir.parent
    else:
        config_dir = model_dir
        for name in ("pytorch_model.bin", "model.pt"):
            if (model_dir / name).exists():
                ckpt = model_dir / name
                break
        else:
            raise FileNotFoundError(f"No pytorch_model.bin/model.pt under {model_dir}")
    sd = load_torch_state_dict(ckpt)
    if (config_dir / "config.json").exists():
        config = ApertisConfig.from_pretrained(config_dir)
    else:
        config = infer_config_from_state_dict(sd)
    return from_jax_params(from_torch_state_dict(sd, config), config, device=device,
                           dtype=dtype)


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
        for prefix, _ in STACKED:
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
    1, K), the absolute position table as ``model.abs_pos_embeddings``, the
    head (the tree's ``lm_head``, else the tied table) as ``lm_head.weight``,
    and a ViT's tree under ``model.multimodal_encoder`` and
    ``model.vision_projection``."""
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
    if "abs_pos" in params:
        put("model.abs_pos_embeddings.weight", params["abs_pos"]["emb"])
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
        if "w_gate" in f:
            for name in ("w_gate", "w_up", "w_down"):
                put_linear(f"{pre}.ffn.{name}", f[name])
        elif "experts" in f:
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
    if "lm_head" in params:
        put_linear("lm_head", params["lm_head"])
    else:
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
