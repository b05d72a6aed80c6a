"""Autoregressive generation engine for the PyTorch model.

The counterpart of ``apertis_llm_tpu/inference/engine.py::InferenceEngine``
with the same ``generate`` contract (engine.py:490-582):

  * prompts are right-padded to the smallest of ``PROMPT_BUCKETS`` that fits;
  * prefill runs the padded prompts and samples the first token from each
    row's last real position (``_prefill_state``);
  * a Python loop then calls ``decode_step`` once per token (``_decode_loop``)
    until ``max_new_tokens``, or until every row has emitted an EOS id and
    ``min_new_tokens`` is reached; finished rows emit ``pad_token_id``;
  * the repetition penalty counts the real prompt tokens and the generated
    ones;
  * the result is the prompt columns as given, then the generated columns.

Each loop step reads one flag back to the host (whether any row is still
running). Capturing the step in a CUDA graph is later work.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.apertis import ApertisForCausalLM
from apertis_llm_torch.ops import sampling as sampling_ops


class GenerationParams(NamedTuple):
    max_new_tokens: int = 20
    min_new_tokens: int = 0
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_ids: Tuple[int, ...] = ()
    pad_token_id: int = 0


def _round_up_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; past the table, the next multiple of half the
    largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    step = max(buckets[-1] // 2, 1)
    return ((n + step - 1) // step) * step


class InferenceEngine:
    """Batched generation for one (config, model) pair."""

    PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

    def __init__(self, config: ApertisConfig, model: ApertisForCausalLM):
        self.config = config
        self.model = model

    @torch.inference_mode()
    def generate(
        self,
        input_ids: np.ndarray,                   # (B, L) int
        attention_mask: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
        **gen_kwargs,
    ) -> np.ndarray:
        """Batch generation; returns (B, L + n_generated) ids."""
        eos = gen_kwargs.pop("eos_token_id", None)
        if eos is None:
            eos = self.config.eos_token_id
        if not isinstance(eos, (tuple, list)):
            eos = (eos,) if eos is not None else ()
        pad = gen_kwargs.pop("pad_token_id", None)
        if pad is None:
            pad = self.config.pad_token_id if self.config.pad_token_id is not None else 0
        gen = GenerationParams(
            eos_token_ids=tuple(int(e) for e in eos if e is not None),
            pad_token_id=int(pad), **gen_kwargs)

        input_ids = np.asarray(input_ids)
        b, l = input_ids.shape
        if attention_mask is None:
            attention_mask = np.ones((b, l), np.int32)
        bucket = _round_up_bucket(l, self.PROMPT_BUCKETS)
        padc = ((0, 0), (0, bucket - l))
        device = self.model.device
        ids = torch.as_tensor(np.pad(input_ids, padc, constant_values=gen.pad_token_id),
                              dtype=torch.int64, device=device)
        mask = torch.as_tensor(np.pad(attention_mask, padc), dtype=torch.int32,
                               device=device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.seed()

        tokens, n_generated = self._generate(ids, mask, gen, generator)
        new = tokens[:, bucket:bucket + n_generated].cpu().numpy()
        return np.concatenate([input_ids, new.astype(input_ids.dtype)], axis=1)

    def _generate(self, ids: torch.Tensor, mask: torch.Tensor,
                  gen: GenerationParams, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, int]:
        b, lp = ids.shape
        device = ids.device
        buf_len = lp + max(gen.max_new_tokens, 1)
        lens = mask.sum(dim=1)
        positions = torch.arange(buf_len, device=device)[None, :]

        def sample(logits: torch.Tensor, tokens: torch.Tensor, filled: int) -> torch.Tensor:
            # History = real prompt tokens + the generated region so far.
            hist = ((positions < lens[:, None])
                    | ((positions >= lp) & (positions < filled))).float()
            return sampling_ops.sample_token(
                logits, generator=generator, do_sample=gen.do_sample,
                temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
                repetition_penalty=gen.repetition_penalty, token_history=tokens,
                history_mask=hist)

        def finish_update(unfinished: torch.Tensor, nxt: torch.Tensor):
            nxt = nxt * unfinished + gen.pad_token_id * (1 - unfinished)
            for e in gen.eos_token_ids:
                unfinished = torch.where((nxt == e) & (unfinished == 1),
                                         torch.zeros_like(unfinished), unfinished)
            return nxt, unfinished

        # Prefill + first token (engine.py::_prefill_state).
        cache = self.model.init_cache(b)
        pre = self.model.prefill(cache, ids, mask,
                                 logit_positions=torch.clamp(lens - 1, min=0))
        tokens = torch.cat([ids, torch.full((b, buf_len - lp), gen.pad_token_id,
                                            dtype=ids.dtype, device=device)], dim=1)
        unfinished = torch.ones((b,), dtype=torch.int64, device=device)
        nxt, unfinished = finish_update(unfinished, sample(pre.logits[:, 0, :], tokens, lp))
        tokens[:, lp] = nxt
        filled, step = lp + 1, 1
        if gen.max_new_tokens <= 1:
            return tokens, gen.max_new_tokens

        # Decode loop (engine.py::_decode_loop).
        while step < gen.max_new_tokens and (step < gen.min_new_tokens
                                             or bool(unfinished.any())):
            logits, cache = self.model.decode_step(cache, tokens[:, filled - 1])
            nxt, unfinished = finish_update(unfinished, sample(logits, tokens, filled))
            tokens[:, filled] = nxt
            filled += 1
            step += 1
        return tokens, step
