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

For an int8 model the engine attaches the int8 copy of the tied LM head
(``ApertisForCausalLM.quantize_tied_head``), as the JAX engine attaches
``quantize_tied_head`` to a quantized tree (engine.py:365-375). For a MoE
model, int8 or bf16, it builds every layer's int8 fat stack at construction
(``ApertisForCausalLM.attach_moe_fat``), as the JAX engine attaches its fat
stacks (engine.py:347-364): the model reads a serving stack only once one is
attached, and computes the MoE FFN in the tree's dtype before; for an int8
MHA model, the fused QKV projection (``ApertisForCausalLM.attach_qkv``,
engine.py:387-394).

``quant_bits=4`` serves w4a8, the JAX engine's ``APERTIS_QUANT_BITS=4``
(engine.py:347-386): prefill keeps the tree, a dense int8 FFN decodes
through its attached int4 pack (``ApertisForCausalLM.attach_int4_ffn``; a
float FFN attaches none) and a MoE model's fat stacks, from int8 or float
experts, are built int4 where H and I are multiples of 128 (int8 elsewhere,
as in JAX).

``quant_matmul`` and ``moe_mode`` choose the arithmetic that the JAX package
picks by environment variable, ``APERTIS_QUANT_MATMUL`` and
``APERTIS_MOE_FUSED`` (``ApertisForCausalLM.set_modes``), by default the JAX
package's ``auto`` and ``fatk``. ``quant_matmul`` (``auto``, ``dyn``,
``weightonly``, ``pallas``, ``fused``) decides how every int8 linear of the
full-sequence paths, the unfused decode FFNs and the int8 head compute
(``auto``: ``ops/quant.py::resolve_mode``, ``fuses_pre_norm``); the int8
decode projections stay w8a8. ``moe_mode="fat"`` attaches the fat stack as
``fatk`` does and computes its two products in plain torch at small token
counts (``ops/moe.py::moe_dense_fat``). ``moe_mode="kernel"`` attaches the
per-expert stack (``ApertisForCausalLM.attach_moe_fused``) instead of the
fat stack and serves the MoE FFN through the per-expert kernel;
``quant_bits=4`` then
changes nothing for it, as in JAX. ``moe_mode="0"`` attaches no stack: the
MoE FFN runs ``moe_dense`` and ``moe_ragged`` (int8 experts under ``dyn``
through their int8 branches), and the decode step without its epilogue.

An MHA model keeps the JAX engine's bookkeeping (engine.py:162-262): a flat
K/V cache of ``num_img + bucket + max_new_tokens`` slots (``num_img`` the
image prefix's tokens, 0 without images), int8 by default for an int8 model
(``kv_int8``); an attention mask over the slots, 1 over the prefix, the
prompt's mask, then growing, for each generated token, by the row's
unfinished flag at the time the token was generated (an EOS stays visible,
the pads after it do not); the token of decode step ``s`` sits at slot
``num_img + bucket + s - 1`` and at logical position ``num_img + len + s -
1``, which differ for right-padded rows. Generation that would pass
``max_position_embeddings``, the prefix counted, raises (engine.py:104-116).

A multimodal model takes ``pixel_values`` (engine.py:490-545): (B, 3, S, S)
pixels, or raw (B, H, W, 3) uint8 or float images, which the model
preprocesses. The image prefix of ``config.num_image_tokens`` positions
runs before the prompt; the bucket grows so that prefix and bucket together
are a multiple of 8 (engine.py:517-525), as in the JAX engine, so both
engines run the same shapes; the first token comes from each row's last
real text position; decoding reads the SSM state, or the MHA cache with
the prefix in its first slots.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.apertis import ApertisForCausalLM
from apertis_llm_torch.models.params import check_quant_bits, is_mha
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


def _check_position_limit(config: ApertisConfig, max_needed: int) -> None:
    """An MHA-rotary or an absolute-position model indexes a table by
    position; past ``max_position_embeddings`` the reference crashes, so
    raise (engine.py:104-116; a rotary selective SSM has no positional
    table)."""
    limited = (config.position_embedding_type == "absolute"
               or (config.position_embedding_type == "rotary" and is_mha(config)))
    if limited and max_needed > config.max_position_embeddings:
        raise ValueError(
            f"prompt + max_new_tokens needs positions up to {max_needed} but "
            f"max_position_embeddings={config.max_position_embeddings}; use a "
            "selective_ssm model for long context or raise the limit")


class InferenceEngine:
    """Batched generation for one (config, model) pair. ``kv_int8`` chooses
    an MHA model's KV cache: int8 with per-(head, slot) scales, or the
    model's dtype; by default int8 for an int8 model and the model's dtype
    for a float one. ``quant_bits`` is 8, or 4 for w4a8 serving.
    ``quant_matmul`` and ``moe_mode`` are the modes of
    ``ApertisForCausalLM.set_modes``, set on the model at construction and
    again at each ``generate``; an unknown value raises ``ValueError``."""

    PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

    def __init__(self, config: ApertisConfig, model: ApertisForCausalLM,
                 kv_int8: Optional[bool] = None, quant_bits: int = 8,
                 quant_matmul: str = "auto", moe_mode: str = "fatk"):
        check_quant_bits(quant_bits)
        self.config = config
        self.model = model
        self.quant_matmul, self.moe_mode = quant_matmul, moe_mode
        self.kv_int8 = model.quantized if kv_int8 is None else bool(kv_int8)
        model.set_modes(quant_matmul, moe_mode)
        if model.quantized and model.lm_head is None:
            model.quantize_tied_head()
        if moe_mode in ("fatk", "fat"):
            model.attach_moe_fat(bits=quant_bits)
        elif moe_mode == "kernel":
            model.attach_moe_fused()
        if quant_bits == 4:
            model.attach_int4_ffn()
        model.attach_qkv()

    @torch.inference_mode()
    def generate(
        self,
        input_ids: np.ndarray,                   # (B, L) int
        attention_mask: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
        *,
        pixel_values: Optional[np.ndarray] = None,
        **gen_kwargs,
    ) -> np.ndarray:
        """Batch generation; returns (B, L + n_generated) ids. A multimodal
        model puts the images of ``pixel_values`` (one a row) before the
        prompts."""
        self.model.set_modes(self.quant_matmul, self.moe_mode)
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
        num_img = (self.config.num_image_tokens
                   if self.config.multimodal and pixel_values is not None else 0)
        bucket += (-(num_img + bucket)) % 8
        _check_position_limit(self.config, num_img + bucket + gen.max_new_tokens)
        padc = ((0, 0), (0, bucket - l))
        device = self.model.device
        if num_img:
            pixel_values = torch.as_tensor(np.asarray(pixel_values), device=device)
        ids = torch.as_tensor(np.pad(input_ids, padc, constant_values=gen.pad_token_id),
                              dtype=torch.int64, device=device)
        mask = torch.as_tensor(np.pad(attention_mask, padc), dtype=torch.int32,
                               device=device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.seed()

        tokens, n_generated = self._generate(ids, mask, gen, generator,
                                             pixel_values if num_img else None)
        new = tokens[:, bucket:bucket + n_generated].cpu().numpy()
        return np.concatenate([input_ids, new.astype(input_ids.dtype)], axis=1)

    def _generate(self, ids: torch.Tensor, mask: torch.Tensor,
                  gen: GenerationParams, generator: torch.Generator,
                  pixel_values: Optional[torch.Tensor] = None
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

        # Prefill + first token (engine.py::_prefill_state). An MHA cache
        # holds the image prefix, the prompt and the generated tokens.
        mha = is_mha(self.config)
        num_img = self.config.num_image_tokens if pixel_values is not None else 0
        if mha:
            cache = self.model.init_cache(b, max_length=num_img + buf_len,
                                          kv_int8=self.kv_int8)
        else:
            cache = self.model.init_cache(b)
        pre = self.model.prefill(cache, ids, mask, logit_positions=torch.clamp(lens - 1, min=0),
                                 pixel_values=pixel_values)
        tokens = torch.cat([ids, torch.full((b, buf_len - lp), gen.pad_token_id,
                                            dtype=ids.dtype, device=device)], dim=1)
        unfinished = torch.ones((b,), dtype=torch.int64, device=device)
        if mha:
            # Slot validity: the prefix, the prompt's mask, then each
            # generated token's unfinished flag at the time it was generated.
            kv_mask = torch.zeros((b, num_img + buf_len), dtype=torch.int32, device=device)
            kv_mask[:, :num_img] = 1
            kv_mask[:, num_img:num_img + lp] = mask
            kv_mask[:, num_img + lp] = unfinished
        nxt, unfinished = finish_update(unfinished, sample(pre.logits[:, 0, :], tokens, lp))
        tokens[:, lp] = nxt
        filled, step = lp + 1, 1
        if gen.max_new_tokens <= 1:
            return tokens, gen.max_new_tokens

        # Decode loop (engine.py::_decode_loop).
        while step < gen.max_new_tokens and (step < gen.min_new_tokens
                                             or bool(unfinished.any())):
            cur = tokens[:, filled - 1]
            if mha:
                t = num_img + lp + step - 1
                logits, cache = self.model.decode_step(cache, cur, t=t, attn_mask_row=kv_mask,
                                                       positions=num_img + lens + step - 1)
                kv_mask[:, t + 1] = unfinished
            elif self.model.abs_pos is not None:
                logits, cache = self.model.decode_step(cache, cur,
                                                       positions=num_img + lens + step - 1)
            else:
                logits, cache = self.model.decode_step(cache, cur)
            nxt, unfinished = finish_update(unfinished, sample(logits, tokens, filled))
            tokens[:, filled] = nxt
            filled += 1
            step += 1
        return tokens, step
