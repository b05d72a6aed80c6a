"""Model sizing: parameter-count parsing and the dimension search.

A copy of ``apertis_llm_tpu.models.factory.calculate_model_dimensions`` and
the helpers it calls (reference: src/model/core.py:1709-1893): given the same
target parameter count both packages select the same (hidden, layers, heads,
intermediate).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Union

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
