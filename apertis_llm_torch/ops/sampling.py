"""Batched token sampling (the ``apertis_llm_tpu/ops/sampling.py`` semantics).

  * The repetition penalty divides a logit once per occurrence of its token
    in the history (a token seen c times is divided by penalty**c); the
    ``history_mask`` selects which history slots count.
  * top-k keeps every logit >= the k-th value (ties included).
  * top-p sorts descending and keeps the smallest prefix whose cumulative
    probability exceeds p, shifted so the first token past it survives.
  * Sampling draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def apply_repetition_penalty(
    logits: torch.Tensor,      # (B, V) float32
    token_ids: torch.Tensor,   # (B, L) history ids (padded)
    valid_mask: torch.Tensor,  # (B, L) 1 for slots that count
    penalty: float,
) -> torch.Tensor:
    vocab = logits.shape[-1]
    ids = token_ids.long().clamp(0, vocab - 1)
    counts = torch.zeros_like(logits).scatter_add_(1, ids, valid_mask.to(logits.dtype))
    return logits / torch.pow(torch.tensor(penalty, dtype=logits.dtype,
                                           device=logits.device), counts)


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    exceeded = cum_probs > top_p
    # Shift right so the first token crossing the threshold is kept.
    exceeded = torch.cat([torch.zeros_like(exceeded[..., :1]), exceeded[..., :-1]], dim=-1)
    cutoff = torch.where(exceeded, torch.full_like(sorted_logits, float("inf")),
                         sorted_logits).min(dim=-1, keepdim=True).values
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)


def sample_token(
    logits: torch.Tensor,        # (B, V)
    *,
    generator: Optional[torch.Generator] = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
    token_history: Optional[torch.Tensor] = None,
    history_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full sampling pipeline; returns next token ids (B,) as int64."""
    logits = logits.float()
    if repetition_penalty != 1.0 and token_history is not None:
        if history_mask is None:
            history_mask = torch.ones(token_history.shape, dtype=torch.float32,
                                      device=logits.device)
        logits = apply_repetition_penalty(logits, token_history, history_mask,
                                          repetition_penalty)
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    temp = max(temperature, 1e-6)
    if temp != 1.0:
        logits = logits / temp
    if top_k > 0:
        logits = apply_top_k(logits, top_k)
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
