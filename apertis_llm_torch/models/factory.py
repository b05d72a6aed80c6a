"""Model sizing: parameter-count parsing, the dimension search and the
config builder.

A copy of ``apertis_llm_tpu.models.factory``'s ``calculate_model_dimensions``,
``estimate_model_parameters`` and ``build_model_config`` and the helpers they
call (reference: src/model/core.py:1709-2104): given the same target
parameter count both packages select the same (hidden, layers, heads,
intermediate) and resolve the same config.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Union

from apertis_llm_torch.config import ApertisConfig

logger = logging.getLogger(__name__)


def parse_param_count(param_str: Union[str, int]) -> int:
    """Parse "125M" / "1.5B" / "900K" / int into a raw parameter count."""
    if isinstance(param_str, int):
        return param_str
    s = str(param_str).strip().upper()
    if not s:
        raise ValueError("Parameter string cannot be empty.")
    multiplier = 1
    if s.endswith("K"):
        multiplier, s = 1_000, s[:-1]
    elif s.endswith("M"):
        multiplier, s = 1_000_000, s[:-1]
    elif s.endswith("B"):
        multiplier, s = 1_000_000_000, s[:-1]
    try:
        val = float(s)
    except ValueError as e:
        raise ValueError(f"Invalid numeric value in parameter string: '{param_str}'") from e
    return int(val * multiplier)


def _params_for_dims(
    vocab_size: int,
    hidden_size: int,
    num_layers: int,
    intermediate_size: int,
    tie_word_embeddings: bool = True,
    use_expert_system: bool = False,
    num_experts: int = 0,
) -> int:
    """Closed-form parameter estimate used by the dimension search."""
    params = vocab_size * hidden_size
    if not tie_word_embeddings:
        params += vocab_size * hidden_size
    params += num_layers * (4 * hidden_size * hidden_size)
    if use_expert_system and num_experts > 0:
        params += num_layers * num_experts * (2 * hidden_size * intermediate_size)
        params += num_layers * (hidden_size * num_experts)
    else:
        params += num_layers * (2 * hidden_size * intermediate_size)
    params += (2 * num_layers + 1) * (2 * hidden_size)
    return params


def calculate_model_dimensions(
    target_params_str: Union[str, int],
    vocab_size: int,
    use_expert_system: bool = False,
    num_experts_target: int = 8,
    min_hidden_size: int = 256,
    max_hidden_size: int = 8192,
    min_layers: int = 2,
    max_layers: int = 128,
    head_dim_preference: int = 64,
    intermediate_multiple_of: int = 256,
    intermediate_ratio: float = 4.0,
    tie_word_embeddings: bool = True,
) -> Dict[str, Any]:
    """Search (layers x hidden) for the config closest to the target parameter
    count, with the reference's search order, stepping and tie-breaking."""
    target_params = parse_param_count(target_params_str)
    if not (10_000_000 <= target_params <= 70_000_000_000):
        logger.warning(
            "Target parameters %s (%d) outside typical 10M-70B range.",
            target_params_str, target_params)

    best: Optional[Dict[str, Any]] = None
    min_diff = float("inf")

    for layers in range(min_layers, max_layers + 1, 2):
        current_h = min_hidden_size
        while current_h <= max_hidden_size:
            h = current_h
            if h % head_dim_preference != 0:
                h = ((h // head_dim_preference) + 1) * head_dim_preference
            if h == 0:
                h = head_dim_preference
            if h > max_hidden_size:
                break
            heads = max(1, h // head_dim_preference)
            if h % heads != 0:
                h = heads * head_dim_preference
            inter = int(h * intermediate_ratio)
            inter = ((inter + intermediate_multiple_of - 1) // intermediate_multiple_of) * intermediate_multiple_of
            if inter == 0:
                inter = intermediate_multiple_of

            params = _params_for_dims(
                vocab_size, h, layers, inter, tie_word_embeddings,
                use_expert_system, num_experts_target if use_expert_system else 0)
            diff = abs(params - target_params)
            if diff < min_diff:
                min_diff = diff
                best = {
                    "hidden_size": h,
                    "num_hidden_layers": layers,
                    "num_attention_heads": heads,
                    "intermediate_size": inter,
                    "calculated_params": params,
                    "target_params": target_params,
                    "param_diff": diff,
                }
            if params > target_params and diff > min_diff:
                break
            current_h += max(head_dim_preference, h // 16)

    if best is None:
        h = min_hidden_size
        heads = max(1, h // head_dim_preference)
        inter = int(h * intermediate_ratio)
        inter = ((inter + intermediate_multiple_of - 1) // intermediate_multiple_of) * intermediate_multiple_of
        params = _params_for_dims(
            vocab_size, h, min_layers, inter, tie_word_embeddings,
            use_expert_system, num_experts_target if use_expert_system else 0)
        best = {
            "hidden_size": h,
            "num_hidden_layers": min_layers,
            "num_attention_heads": heads,
            "intermediate_size": inter,
            "calculated_params": params,
            "target_params": target_params,
            "param_diff": abs(params - target_params),
            "fallback": True,
        }
    logger.info(
        "Dimensions for ~%.2fM params: H=%d L=%d A=%d I=%d (got %.2fM)",
        best["target_params"] / 1e6, best["hidden_size"], best["num_hidden_layers"],
        best["num_attention_heads"], best["intermediate_size"],
        best["calculated_params"] / 1e6)
    return best


def estimate_model_parameters(config: ApertisConfig) -> int:
    """Estimate total parameters for an assembled config
    (reference: core.py:1895-1965)."""
    params = config.vocab_size * config.hidden_size
    if not config.tie_word_embeddings:
        params += config.vocab_size * config.hidden_size
    attn = 4 * config.hidden_size * config.hidden_size
    if config.use_expert_system and config.num_experts > 0:
        ffn = config.num_experts * (2 * config.hidden_size * config.intermediate_size)
        ffn += config.hidden_size * config.num_experts
    else:
        ffn = 2 * config.hidden_size * config.intermediate_size
    params += config.num_hidden_layers * (attn + ffn)
    params += (2 * config.num_hidden_layers + 1) * (2 * config.hidden_size)
    if config.position_embedding_type == "absolute":
        params += config.max_position_embeddings * config.hidden_size
    if config.multimodal and config.vision_embed_dim != config.hidden_size:
        params += config.vision_embed_dim * config.hidden_size
    return params


def build_model_config(
    target_param_count: Union[str, int] = "125M",
    vocab_size_override: Optional[int] = None,
    multimodal: bool = False,
    use_flash_attention: bool = False,
    use_expert_system: bool = False,
    num_experts_target_override: Optional[int] = None,
    experts_per_token_target_override: Optional[int] = None,
    attention_type_override: Optional[str] = None,
    ssm_d_inner: Optional[int] = None,
    ssm_d_state: int = 16,
    ssm_dt_rank: Union[int, str] = "auto",
    ssm_conv_kernel: int = 4,
    config_overrides: Optional[Dict[str, Any]] = None,
) -> ApertisConfig:
    """Resolve a full ApertisConfig from a target parameter count.

    Mirrors the live ``create_apertis_model`` resolution order
    (reference: core.py:1969-2104): calculated dims -> explicit kwargs ->
    config_overrides -> head-divisibility repair.
    """
    temp = ApertisConfig.from_dict(config_overrides or {})
    vocab_for_calc = vocab_size_override if vocab_size_override is not None else temp.vocab_size

    dims = calculate_model_dimensions(
        target_params_str=target_param_count,
        vocab_size=vocab_for_calc,
        use_expert_system=use_expert_system,
        num_experts_target=(num_experts_target_override
                            if num_experts_target_override is not None else 8),
    )

    cfg: Dict[str, Any] = {
        "hidden_size": dims["hidden_size"],
        "num_hidden_layers": dims["num_hidden_layers"],
        "num_attention_heads": dims["num_attention_heads"],
        "intermediate_size": dims["intermediate_size"],
    }
    if vocab_size_override is not None:
        cfg["vocab_size"] = vocab_size_override
    else:
        cfg["vocab_size"] = vocab_for_calc
    cfg["attention_type"] = attention_type_override or "standard_mha"
    cfg.update({
        "multimodal": multimodal,
        "use_flash_attention": use_flash_attention,
        "use_expert_system": use_expert_system,
        "ssm_d_inner": ssm_d_inner,
        "ssm_d_state": ssm_d_state,
        "ssm_dt_rank": ssm_dt_rank,
        "ssm_conv_kernel": ssm_conv_kernel,
    })
    if use_expert_system:
        if num_experts_target_override is not None:
            cfg["num_experts"] = num_experts_target_override
        if experts_per_token_target_override is not None:
            cfg["experts_per_token"] = experts_per_token_target_override
    if config_overrides:
        cfg.update(config_overrides)

    # Head-divisibility repair (reference: core.py:2064-2088).
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if h % heads != 0:
        preferred_head_dim = h // heads if heads > 0 else 64
        if preferred_head_dim == 0:
            preferred_head_dim = 64
        if h % preferred_head_dim == 0 and h // preferred_head_dim > 0:
            cfg["num_attention_heads"] = h // preferred_head_dim
        else:
            for i in range(min(heads, h), 0, -1):
                if h % i == 0:
                    cfg["num_attention_heads"] = i
                    break
            else:
                cfg["num_attention_heads"] = 1
        logger.info("Adjusted num_attention_heads to %d", cfg["num_attention_heads"])

    config = ApertisConfig.from_dict(cfg)
    logger.info(
        "Config: H=%d L=%d A=%d I=%d V=%d (~%.2fM params, target %s)",
        config.hidden_size, config.num_hidden_layers, config.num_attention_heads,
        config.intermediate_size, config.vocab_size,
        estimate_model_parameters(config) / 1e6, target_param_count)
    return config
