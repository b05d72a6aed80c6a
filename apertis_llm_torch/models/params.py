"""Parameter initialisation, as a tree of tensors named like the JAX package's.

``init_params`` builds the same nested dict of names and shapes as
``apertis_llm_tpu/models/params.py::init_params`` for the selective-SSM or
the MHA mixer, a dense, SwiGLU or MoE FFN, the absolute position table
``abs_pos`` and the untied ``lm_head`` where the config asks for them and,
for a multimodal model, the ViT's ``vision`` tree and ``vision_proj``
(``:129-211``): per-layer tensors
stacked along a leading ``num_hidden_layers`` axis, linear weights in the
(in, out) layout, and the same distributions
(reference: src/model/core.py:1045-1062, 314-318): normal(0,
initializer_range) for linears and embeddings, zero biases, unit norm
scales, dt bias ~ U(log 1e-3, log 1e-2), A_log ~ U(log 0.5, log 0.99), D = 1,
conv taps ~ U(+-1/sqrt(K)), unit expert and router LayerNorms, zero
``w_noise``; the ViT's patch embedding, CLS token and position embeddings
normal(0, 0.02), its packed ``in_proj_w`` xavier-uniform, its other linears
normal(0, 0.02), every bias zero and every LayerNorm unit (per-layer ViT
tensors stacked along a leading ``vision_layers`` axis). The numbers differ
from JAX's, which draws from
its own generator. ``models/convert.py::from_jax_params`` turns the tree into
the model's modules.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.ops.quant import QUANT_MATMUL_MODES
from apertis_llm_torch.parallel.mesh import normalize_shape

Params = Dict[str, Any]


# The mixer projections that are either all int8 or all float, with the FFN
# pair, in a tree the port serves: the SSM mixer's four, or MHA's q/k/v/o.
_SSM_PROJECTIONS = ("in_proj_x", "in_proj_z", "x_param_proj", "out_proj")
_MHA_PROJECTIONS = ("q", "k", "v", "o")
_SWIGLU_LINEARS = ("w_gate", "w_up", "w_down")


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the card unless the caller names
    another. With no CUDA device it raises instead of building on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' to build "
                           "on the CPU, where the kernels' plain versions run")
    return dev


def quantized_layout(params: Params) -> bool:
    """True when the four mixer projections and the FFN's linears of
    ``params["layers"]`` are int8, False when they are all float. The mixer
    projections are the SSM mixer's ``in_proj_x``, ``in_proj_z``,
    ``x_param_proj`` and ``out_proj``, or MHA's ``q``, ``k``, ``v`` and ``o``
    (a tree with ``attn.q`` is an MHA tree). The FFN's are ``ffn.w1`` /
    ``ffn.w2`` (``{w_q, w_s}`` or ``{w}``) in a dense tree, ``ffn.w_gate`` /
    ``w_up`` / ``w_down`` in a SwiGLU tree and ``ffn.experts.w1`` / ``w2``
    (``w1_q, w1_s`` or ``w1``) in a MoE tree. A mixed tree raises
    ``NotImplementedError``: the JAX package serves one quietly through its
    unfused path, which the port does not have."""
    layers = params.get("layers", {})
    attn = layers.get("attn", {})
    kinds = {}
    for name in _MHA_PROJECTIONS if "q" in attn else _SSM_PROJECTIONS:
        leaf = attn.get(name, {})
        kinds[f"attn.{name}"] = "int8" if "w_q" in leaf else "float" if "w" in leaf else None
    ffn = layers.get("ffn", {})
    experts = ffn.get("experts")
    for name in _SWIGLU_LINEARS if "w_gate" in ffn else ("w1", "w2"):
        if experts is not None:
            kinds[f"ffn.experts.{name}"] = ("int8" if name + "_q" in experts else
                                            "float" if name in experts else None)
        else:
            leaf = ffn.get(name, {})
            kinds[f"ffn.{name}"] = "int8" if "w_q" in leaf else "float" if "w" in leaf else None
    if len(set(kinds.values())) != 1 or None in kinds.values():
        raise NotImplementedError(
            "the port serves trees whose projections are all int8 or all float; "
            f"got {kinds} (quantize with a min_size that takes all six)")
    return "int8" in kinds.values()


def vision_quantized_layout(params: Params) -> bool:
    """True when the ViT's linears (``vision.patch_embed``, each layer's
    ``in_proj``, ``attn_out``, ``linear1``, ``linear2``) and ``vision_proj``
    are int8, False when they are all float or the tree has no ViT: the
    ``vision`` subtree's counterpart of :func:`quantized_layout`. A mixed
    subtree raises ``NotImplementedError``."""
    vision = params.get("vision")
    if vision is None:
        return False
    layers = vision.get("layers", {})
    leaves = {"vision.patch_embed": vision.get("patch_embed", {}),
              "vision.layers.in_proj": {k[len("in_proj_"):]: v for k, v in layers.items()
                                        if k.startswith("in_proj_w")},
              **{f"vision.layers.{name}": layers.get(name, {})
                 for name in ("attn_out", "linear1", "linear2")}}
    if "vision_proj" in params:
        leaves["vision_proj"] = params["vision_proj"]
    kinds = {name: "int8" if "w_q" in leaf else "float" if "w" in leaf else None
             for name, leaf in leaves.items()}
    if len(set(kinds.values())) != 1 or None in kinds.values():
        raise NotImplementedError(
            "the port serves ViT trees whose linears are all int8 or all float; got "
            f"{kinds} (quantize with a min_size that takes all of them)")
    return "int8" in kinds.values()


def is_moe(config: ApertisConfig) -> bool:
    """A MoE FFN: the expert system with experts, and no SwiGLU, which takes
    precedence in the JAX package (``apertis.py::_ffn``, ``params.py::
    init_ffn_params``)."""
    return bool(config.use_expert_system and config.num_experts > 0
                and not config.use_swiglu)


def is_mha(config: ApertisConfig) -> bool:
    return config.attention_type == "standard_mha"


def check_supported(config: ApertisConfig, quantized: bool = False) -> None:
    """Raise unless ``config`` is a variant ported so far: the decoder in
    bf16/f32 or with int8 projections, whose mixer is the selective SSM
    (its hidden and mixer widths multiples of 4) or standard MHA (at any
    head width: the decode-attention kernel takes multiples of 32 up to
    256, plain torch the others, as the JAX package serves them through
    XLA), with a dense, SwiGLU or top-k MoE FFN (any k, its hidden and
    intermediate widths multiples of 16), rotary or absolute positions, a
    tied or an untied LM head, and either mixer also with the ViT image
    prefix (``multimodal``). Int8 weights are served at any width the JAX
    package serves: where the fused decode FFN's width test fails, the FFN
    runs unfused (``models/apertis.py``)."""
    missing = []
    if config.attention_type not in ("selective_ssm", "standard_mha"):
        missing.append(f"attention_type={config.attention_type!r}")
    if config.multimodal and (config.image_size % config.vision_patch_size
                              or config.vision_embed_dim % config.vision_heads):
        missing.append(f"a ViT with image_size={config.image_size}, patch "
                       f"{config.vision_patch_size}, width {config.vision_embed_dim} and "
                       f"{config.vision_heads} heads (whole patches and heads)")
    if config.attention_type == "selective_ssm" and (
            config.hidden_size % 4 or config.ssm_d_inner % 4):
        # The decode step (ops/kernels/ssm_step.py) reads D and C in units of
        # four (ROADMAP.md queue 2, item B1).
        missing.append(f"the selective SSM with hidden_size={config.hidden_size} or "
                       f"mixer width {config.ssm_d_inner} (heads x ssm_d_state) not a "
                       "multiple of 4 (ROADMAP.md queue 2, item B1)")
    if is_moe(config):
        # The MoE kernels read int8 rows and weights in 16-byte units; their
        # fat stack is int8 in both layouts (ROADMAP.md queue 2, item B2).
        if config.hidden_size % 16 or config.intermediate_size % 16:
            missing.append("MoE with hidden or intermediate size not a multiple of 16 "
                           "(ROADMAP.md queue 2, item B2)")
    if missing:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(missing) + " (see ROADMAP.md)")


def check_quant_bits(quant_bits: int) -> None:
    """Raise unless the engine can serve ``quant_bits``: 8 (the tree as it
    is) or 4 (w4a8, the JAX engine's ``APERTIS_QUANT_BITS=4``: int4 decode
    copies beside the tree where the JAX engine attaches them, a dense int8
    FFN's pack and a MoE model's fat stacks where H and I are multiples of
    128, from int8 or float experts; elsewhere nothing changes)."""
    if quant_bits not in (4, 8):
        raise ValueError(f"quant_bits must be 4 or 8, got {quant_bits}")


MOE_MODES = ("fatk", "fat", "kernel", "0")


def check_serving_modes(quant_matmul: str, moe_mode: str) -> None:
    """Raise ``ValueError`` unless ``quant_matmul`` is one of the JAX
    package's ``APERTIS_QUANT_MATMUL`` values (``auto``, ``dyn``,
    ``weightonly``, ``pallas``, ``fused``) and ``moe_mode`` one of its
    ``APERTIS_MOE_FUSED`` values (``fatk``; ``fat``, the fat stack's
    products in plain torch; ``kernel``, its ``kernel``/``1``; ``0``, no
    stack)."""
    if quant_matmul not in QUANT_MATMUL_MODES:
        raise ValueError(f"quant_matmul must be one of {QUANT_MATMUL_MODES}, got {quant_matmul!r}")
    if moe_mode not in MOE_MODES:
        raise ValueError(f"moe_mode must be one of {MOE_MODES}, got {moe_mode!r}")


def check_trainable(config: ApertisConfig, quantized: bool = False, device="cuda",
                    mesh_shape=None) -> None:
    """Raise ``NotImplementedError`` (naming ROADMAP.md) unless the port can
    train ``config`` as asked: a variant :func:`check_supported` takes (the
    selective-SSM model at any ``ssm_d_state`` up to 1024 or the MHA model,
    with any FFN, positions and head; bf16 or f32 compute), with a float
    tree, on a mesh
    ``mesh_shape`` over (data, model, expert, seq) (None: one rank) that the
    port runs: one rank, or ``(data, 1, 1, seq)`` for the dense SSM model and
    ``(data, 1, 1, 1)`` for the MHA model; a multimodal model on one rank.
    Not ported yet (module 7): int8 trees, a ``model`` or ``expert`` axis
    (tensor and expert parallelism), MHA under ``seq`` (ring attention
    passes K/V with send/recv, which gloo does not run on CUDA tensors), a
    MoE model on any mesh (JAX computes ``moe_dispatch``'s capacity over
    the global token count) and a multimodal model on any mesh
    (``training/step.py::shard_batch`` carries no images)."""
    check_supported(config, quantized)
    missing = []
    if quantized:
        missing.append("training an int8 tree")
    if torch.device(device).type == "cuda" and not is_mha(config) and config.ssm_d_state > 1024:
        missing.append(f"the scan's backward on the card with ssm_d_state={config.ssm_d_state}")
    data, model, expert, seq = normalize_shape(mesh_shape)
    if model > 1:
        missing.append(f"tensor parallelism (a model axis of {model})")
    if expert > 1:
        missing.append(f"expert parallelism (an expert axis of {expert})")
    if is_mha(config) and seq > 1:
        missing.append(f"MHA under sequence parallelism (ring attention, a seq axis of {seq})")
    if is_moe(config) and data * model * expert * seq > 1:
        missing.append("a MoE model on a mesh of more than one rank")
    if config.multimodal and data * model * expert * seq > 1:
        missing.append("multimodal training on a mesh of more than one rank (module 7: "
                       "shard_batch carries no images)")
    if missing:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(missing) + " (see ROADMAP.md)")


class _Init:
    """Draws every tensor from one generator on one device in one dtype."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, torch.device(device), dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.device,
                           dtype=self.dtype) * std

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.g, device=self.device, dtype=self.dtype)
        return u * (hi - lo) + lo

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def linear(self, lead, fan_in: int, fan_out: int, std: float, bias: bool) -> Params:
        p = {"w": self.normal((*lead, fan_in, fan_out), std)}
        if bias:
            p["b"] = self.full((*lead, fan_out), 0.0)
        return p

    def norm(self, lead, dim: int, rms: bool) -> Params:
        if rms:
            return {"scale": self.full((*lead, dim), 1.0)}
        return {"w": self.full((*lead, dim), 1.0), "b": self.full((*lead, dim), 0.0)}


def init_params(config: ApertisConfig, generator: torch.Generator,
                device="cuda", dtype: torch.dtype = torch.float32) -> Params:
    """Initialise the model variant this package serves (see
    :func:`check_supported`); other variants raise ``NotImplementedError``.
    The tree is built on the card unless ``device`` names another."""
    check_supported(config)
    init = _Init(generator, resolve_device(device), dtype)
    nl = (config.num_hidden_layers,)
    h, std = config.hidden_size, config.initializer_range
    c, heads, n = config.ssm_d_inner, config.num_attention_heads, config.ssm_d_state
    r, k = config.ssm_dt_rank, config.ssm_conv_kernel
    rms = config.use_rmsnorm

    embed = init.normal((config.vocab_size, h), std)
    embed[config.pad_token_id] = 0.0
    params: Params = {"embed": {"tok": embed}}
    if config.position_embedding_type == "absolute":
        params["abs_pos"] = {"emb": init.normal((config.max_position_embeddings, h), std)}

    attn = {"pre_norm": init.norm(nl, h, rms)}
    if is_mha(config):
        # q/k/v/o carry biases only when attention dropout is 0 (qkv_bias).
        for name in _MHA_PROJECTIONS:
            attn[name] = init.linear(nl, h, h, std, bias=config.qkv_bias)
    else:
        conv_bound = 1.0 / math.sqrt(k)
        attn.update({
            "in_proj_x": init.linear(nl, h, c, std, bias=False),
            "in_proj_z": init.linear(nl, h, c, std, bias=False),
            "conv": {"w": init.uniform((*nl, c, k), -conv_bound, conv_bound),
                     "b": init.uniform((*nl, c), -conv_bound, conv_bound)},
            "x_param_proj": init.linear(nl, c, r + 2 * heads * n, std, bias=False),
            "dt_proj": {"w": init.normal((*nl, r, heads), std),
                        "b": init.uniform((*nl, heads), math.log(1e-3), math.log(1e-2))},
            "A_log": init.uniform((*nl, heads, n), math.log(0.5), math.log(0.99)),
            "D": init.full((*nl, c), 1.0),
            "out_proj": init.linear(nl, c, h, std, bias=False),
        })
    inter = config.intermediate_size
    ffn = {"pre_norm": init.norm(nl, h, rms)}
    if config.use_swiglu:
        f = config.swiglu_ffn_dim
        ffn["w_gate"] = init.linear(nl, h, f, std, bias=False)
        ffn["w_up"] = init.linear(nl, h, f, std, bias=False)
        ffn["w_down"] = init.linear(nl, f, h, std, bias=False)
    elif is_moe(config):
        e = config.num_experts
        ffn["router_ln"] = init.norm(nl, h, rms=False)
        ffn["router"] = init.linear(nl, h, e, std, bias=True)
        if config.use_noisy_top_k_routing:
            ffn["w_noise"] = init.full((*nl, e), 0.0)
        ffn["experts"] = {
            "ln_w": init.full((*nl, e, h), 1.0),
            "ln_b": init.full((*nl, e, h), 0.0),
            "w1": init.normal((*nl, e, h, inter), std),
            "b1": init.full((*nl, e, inter), 0.0),
            "w2": init.normal((*nl, e, inter, h), std),
            "b2": init.full((*nl, e, h), 0.0),
        }
    else:
        ffn["w1"] = init.linear(nl, h, inter, std, bias=True)
        ffn["w2"] = init.linear(nl, inter, h, std, bias=True)
    params["layers"] = {"attn": attn, "ffn": ffn}
    params["final_norm"] = init.norm((), h, rms)
    if not config.tie_word_embeddings:
        params["lm_head"] = init.linear((), h, config.vocab_size, std, bias=False)
    if config.multimodal:
        params["vision"] = _init_vision(init, config)
        if config.vision_embed_dim != h:
            params["vision_proj"] = init.linear((), config.vision_embed_dim, h, std, bias=True)
    return params


def _init_vision(init: _Init, config: ApertisConfig) -> Params:
    """The ViT's tree (``params.py::init_vision_params``): the patch
    embedding in (c, dy, dx) order, CLS, position embeddings, the
    ``vision_layers`` pre-norm layers stacked (packed q/k/v ``in_proj``,
    ``attn_out``, the 4x FFN) and the final LayerNorm."""
    dv, p = config.vision_embed_dim, config.vision_patch_size
    patches = (config.image_size // p) ** 2
    nl = (config.vision_layers,)
    bound = math.sqrt(6.0 / (dv + 3 * dv))       # xavier_uniform of (3 dv, dv)
    return {
        "patch_embed": init.linear((), 3 * p * p, dv, 0.02, bias=True),
        "cls_token": init.normal((1, 1, dv), 0.02),
        "pos_embed": init.normal((1, patches + 1, dv), 0.02),
        "layers": {
            "ln1": init.norm(nl, dv, rms=False),
            "in_proj_w": init.uniform((*nl, dv, 3 * dv), -bound, bound),
            "in_proj_b": init.full((*nl, 3 * dv), 0.0),
            "attn_out": init.linear(nl, dv, dv, 0.02, bias=True),
            "ln2": init.norm(nl, dv, rms=False),
            "linear1": init.linear(nl, dv, 4 * dv, 0.02, bias=True),
            "linear2": init.linear(nl, 4 * dv, dv, 0.02, bias=True),
        },
        "final_ln": init.norm((), dv, rms=False),
    }


def count_params(params: Params) -> int:
    total = 0
    for v in params.values():
        total += count_params(v) if isinstance(v, dict) else v.numel()
    return total
