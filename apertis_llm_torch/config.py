"""Apertis model configuration.

A copy of ``apertis_llm_tpu.config.ApertisConfig``: the same fields, the same
derived-field rules and the same ``to_dict``/``from_dict`` schema, so a
configuration written by either package loads in the other. It is copied rather than
imported because importing anything from ``apertis_llm_tpu`` imports JAX.

Derived-field semantics (reference: src/model/core.py):
  * ``attention_type == "selective_linear"`` is an alias for ``selective_ssm``.
  * For ``selective_ssm``, ``ssm_d_inner`` is always
    ``num_attention_heads * ssm_d_state``.
  * ``ssm_dt_rank == "auto"`` resolves to ``ceil(hidden_size / 16)``.
  * When ``use_expert_system`` is false, the MoE knobs are zeroed.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Union

logger = logging.getLogger(__name__)


@dataclass
class ApertisConfig:
    """Hyperparameters for the Apertis decoder-only LM (text + optional vision)."""

    vocab_size: int = 32000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    unk_token_id: int = 3
    position_embedding_type: str = "rotary"
    use_cache: bool = True
    classifier_dropout: Optional[float] = None
    model_type: str = "apertis"
    tie_word_embeddings: bool = True
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    attention_type: str = "standard_mha"
    ssm_d_inner: Optional[int] = None
    ssm_d_state: int = 16
    ssm_dt_rank: Union[int, str] = "auto"
    ssm_conv_kernel: int = 4
    use_flash_attention: bool = False
    use_expert_system: bool = False
    num_experts: int = 8
    experts_per_token: int = 2
    multimodal: bool = False
    image_size: int = 224
    vision_embed_dim: int = 768
    vision_patch_size: int = 16
    vision_layers: int = 12
    vision_heads: int = 12
    output_attentions: bool = False
    output_hidden_states: bool = False
    # MoE knobs
    load_balancing_loss_coef: float = 0.01
    expert_capacity_factor: float = 1.25
    noisy_routing_alpha: float = 0.1
    expert_dropout_prob: float = 0.1
    router_z_loss_coef: float = 0.001
    expert_output_gating: bool = False
    use_noisy_top_k_routing: bool = True
    use_expert_capacity_limit: bool = True
    use_expert_dropout: bool = True
    use_router_z_loss: bool = True
    use_load_balancing_loss: bool = True
    # Architectural flags
    use_rmsnorm: bool = False
    use_swiglu: bool = False
    # Extensions absent from the reference (defaults keep parity); kept so
    # that configs round-trip between the two packages unchanged.
    dtype: str = "float32"  # compute dtype for activations on device
    param_dtype: str = "float32"  # storage dtype for parameters
    decode_max_length: int = 2048  # static decode cache length
    mesh_axes: Dict[str, int] = field(default_factory=dict)  # sharding hints
    remat: bool = False  # rematerialise layer activations in the train step
    ep_capacity_factor: float = 2.0
    moe_dense_threshold_tokens: int = 256

    def __post_init__(self) -> None:
        if self.attention_type == "selective_linear":
            self.attention_type = "selective_ssm"

        if self.attention_type == "selective_ssm":
            derived = self.num_attention_heads * self.ssm_d_state
            if self.ssm_d_inner is not None and self.ssm_d_inner != derived:
                logger.warning(
                    "selective_ssm derives ssm_d_inner = heads * d_state = %d; "
                    "ignoring provided value %s", derived, self.ssm_d_inner)
            self.ssm_d_inner = derived
        elif self.ssm_d_inner is None:
            self.ssm_d_inner = 2 * self.hidden_size

        if self.ssm_dt_rank == "auto":
            self.ssm_dt_rank = math.ceil(self.hidden_size / 16)
        else:
            self.ssm_dt_rank = int(self.ssm_dt_rank)

        if not self.use_expert_system:
            self.num_experts = 0
            self.experts_per_token = 0
        elif self.num_experts > 0:
            self.experts_per_token = min(self.num_experts, self.experts_per_token)
        else:
            self.experts_per_token = 0

        if self.hidden_size % max(self.num_attention_heads, 1) != 0:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be divisible by "
                f"num_attention_heads ({self.num_attention_heads})")

    # -- derived helpers -------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_image_tokens(self) -> int:
        """Number of vision prefix tokens (patches + CLS)."""
        return (self.image_size // self.vision_patch_size) ** 2 + 1

    @property
    def qkv_bias(self) -> bool:
        # Reference quirk: q/k/v/out projections carry biases only when the
        # attention-dropout probability is exactly zero.
        return self.attention_probs_dropout_prob == 0.0

    @property
    def swiglu_ffn_dim(self) -> int:
        # SwiGLU hidden dim = round_up(intermediate * 2/3, 256), min 256.
        dim = int(self.intermediate_size * 2 / 3)
        dim = ((dim + 255) // 256) * 256
        return dim if dim > 0 else 256

    # -- (de)serialisation ------------------------------------------------
    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "ApertisConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in config_dict.items() if k in names}
        unknown = sorted(set(config_dict) - names)
        if unknown:
            logger.warning("Ignoring unknown config keys: %s", unknown)
        return cls(**known)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save_pretrained(self, save_directory: Union[str, os.PathLike]) -> None:
        os.makedirs(save_directory, exist_ok=True)
        with open(Path(save_directory) / "config.json", "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2)

    def replace(self, **changes: Any) -> "ApertisConfig":
        d = self.to_dict()
        d.update(changes)
        return ApertisConfig.from_dict(d)
