"""Log-likelihood evaluation over JSONL datasets
(``apertis_llm_tpu/evaluation/harness.py``).

Two tasks:
  * perplexity — JSONL ``{"text": ...}``; exp of the mean next-token NLL
    over all (non-pad) tokens, rows longer than the window scored by a
    sliding window;
  * multiple_choice — JSONL ``{"question": ..., "choices": [...],
    "answer": <index>}`` (MMLU-style); each choice is scored by the summed
    log-probability of its tokens conditioned on the question, the argmax
    is the prediction.

Each padded batch runs the model's masked ``forward`` and ``token_nll`` on
its device: on the card the full-sequence kernels (the selective scan #1,
and for an int8 tree the fused norm + quantize #5 and the int8 products
#6 / #7 as ``quant_matmul="auto"`` picks them). Prompts bucket to the JAX
harness's lengths, so both score the same shapes. The harness scores the
tree it is given (``ApertisInterface.params``), not the engine's model with
its serving attachments, as the JAX harness scores its tree.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.apertis import ApertisForCausalLM, token_nll
from apertis_llm_torch.models.convert import from_jax_params

logger = logging.getLogger(__name__)

_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _scorer(params, config: ApertisConfig) -> ApertisForCausalLM:
    """The model that scores: ``params`` itself when it is a model, else
    the model of the tree, built on its leaves' device."""
    if isinstance(params, ApertisForCausalLM):
        return params
    leaf = params["embed"]["tok"]
    return from_jax_params(params, config, device=leaf.device)


@torch.inference_mode()
def _token_nll(model: ApertisForCausalLM, ids: np.ndarray, mask: np.ndarray):
    """Per-position NLL of (B, L) ids under their mask: (B, L-1) nll and
    valid, as numpy (harness.py::_token_nll_fn)."""
    dev = model.device
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    mask_t = torch.as_tensor(mask, dtype=torch.int32, device=dev)
    logits = model(ids_t, attention_mask=mask_t)
    nll, _ = token_nll(logits[:, :-1], ids_t[:, 1:])
    return nll.cpu().numpy(), mask[:, 1:].astype(np.float32)


def _pad_batch(rows: List[List[int]], pad_id: int):
    lmax = _bucket(max(len(r) for r in rows))
    ids = np.full((len(rows), lmax), pad_id, np.int32)
    mask = np.zeros((len(rows), lmax), np.int32)
    for i, r in enumerate(rows):
        r = r[:lmax]
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


def compute_perplexity(
    params,
    config: ApertisConfig,
    token_rows: Iterable[Sequence[int]],
    batch_size: int = 8,
    window: int = _BUCKETS[-1],
    overlap: int = 256,
) -> Dict[str, float]:
    """Perplexity over pre-tokenised rows, scored by ``params`` (a tree or
    a model).

    Rows longer than ``window`` are scored with a sliding window: each
    subsequent window re-reads ``overlap`` tokens of context but only the
    tokens after the overlap contribute to the NLL, so every token of a
    long document is scored exactly once.

    ``window`` must be <= the largest bucket (2048) and ``overlap`` must
    satisfy 0 <= overlap < window."""
    if window > _BUCKETS[-1]:
        raise ValueError(
            f"window={window} exceeds the largest compiled bucket "
            f"{_BUCKETS[-1]}; rows are scored in <= {_BUCKETS[-1]}-token "
            "windows, so a larger window would silently truncate")
    if not 0 <= overlap < window:
        raise ValueError(f"overlap must satisfy 0 <= overlap < window "
                         f"(got overlap={overlap}, window={window})")
    model = _scorer(params, config)
    total_nll, total_tokens = 0.0, 0
    batch: List[List[int]] = []
    score_from: List[int] = []

    def flush(batch, score_from):
        nonlocal total_nll, total_tokens
        if not batch:
            return
        while len(batch) < batch_size:
            # Filler rows square up the batch shape; an out-of-range
            # score-from offset keeps them out of the NLL entirely.
            batch.append(batch[-1][:2])
            score_from.append(1 << 30)
        ids, mask = _pad_batch(batch, config.pad_token_id)
        nll, valid = _token_nll(model, ids, mask)
        # Position p of `nll` scores token p+1; honour each row's
        # score-from offset so overlap context isn't double-counted.
        pos = np.arange(ids.shape[1] - 1)[None, :] + 1
        scoring = (pos >= np.asarray(score_from)[:, None]).astype(np.float32)
        v = valid * scoring
        total_nll += float(np.sum(nll * v))
        total_tokens += int(np.sum(v))

    def push(row, start):
        nonlocal batch, score_from
        batch.append(row)
        score_from.append(start)
        if len(batch) == batch_size:
            flush(batch, score_from)
            batch, score_from = [], []

    for row in token_rows:
        row = list(row)
        if len(row) < 2:
            continue
        if len(row) <= window:
            push(row, 0)
        else:
            stride = window - overlap
            push(row[:window], 0)
            for s in range(stride, len(row) - overlap, stride):
                push(row[s:s + window], overlap)
    flush(batch, score_from)
    if total_tokens == 0:
        return {"perplexity": float("nan"), "tokens": 0}
    mean_nll = total_nll / total_tokens
    return {"perplexity": float(np.exp(mean_nll)),
            "nll_per_token": mean_nll, "tokens": total_tokens}


def evaluate_multiple_choice(
    params,
    config: ApertisConfig,
    items: List[Dict[str, Any]],
    encode: Callable[[str], List[int]],
    batch_size: int = 8,
    prompt_template: str = "Question: {question}\nAnswer:",
) -> Dict[str, float]:
    """Accuracy by choice log-likelihood (length-normalised and raw),
    scored by ``params`` (a tree or a model)."""
    model = _scorer(params, config)
    correct = correct_norm = total = 0

    for item in items:
        question = prompt_template.format(question=item["question"])
        q_ids = encode(question)
        rows, q_lens = [], []
        for choice in item["choices"]:
            c_ids = encode(" " + str(choice))
            rows.append(q_ids + c_ids)
            q_lens.append(len(q_ids))
        ids, mask = _pad_batch(rows, config.pad_token_id)
        nll, valid = _token_nll(model, ids, mask)
        nll = nll * valid
        scores, scores_norm = [], []
        for i, qlen in enumerate(q_lens):
            # NLL positions qlen-1 .. len(row)-2 predict the choice tokens.
            span = nll[i, qlen - 1: len(rows[i]) - 1]
            scores.append(-span.sum())
            scores_norm.append(-span.mean() if span.size else -np.inf)
        answer = int(item["answer"])
        correct += int(np.argmax(scores) == answer)
        correct_norm += int(np.argmax(scores_norm) == answer)
        total += 1

    return {"accuracy": correct / max(total, 1),
            "accuracy_norm": correct_norm / max(total, 1),
            "items": total}


def run_eval(
    model_path: str,
    data_path: str,
    task: str = "perplexity",
    tokenizer_path: Optional[str] = None,
    batch_size: int = 8,
    max_items: Optional[int] = None,
    prompt_template: str = "Question: {question}\nAnswer:",
    window: int = _BUCKETS[-1],
    overlap: int = 256,
    quantize: Optional[str] = None,
    mesh_shape: Optional[List[int]] = None,
    device: Optional[str] = None,
) -> Dict[str, float]:
    """Load a checkpoint on ``device`` (the card unless named) and evaluate
    it on a JSONL dataset; ``quantize="int8"`` scores the int8 tree.
    ``mesh_shape`` raises ``NotImplementedError`` (ROADMAP.md queue 1,
    item 5.6)."""
    from apertis_llm_torch.inference.interface import ApertisInterface

    iface = ApertisInterface(model_path=model_path, vocab_file=tokenizer_path,
                             quantize=quantize, mesh_shape=mesh_shape, device=device)
    params, config = iface.params, iface.config

    items = []
    with open(data_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                items.append(json.loads(line))
            except json.JSONDecodeError:
                continue
            if max_items and len(items) >= max_items:
                break

    if task == "perplexity":
        rows = [iface.tokenize(it.get("text", "")) for it in items]
        result = compute_perplexity(params, config, rows, batch_size,
                                    window=window, overlap=overlap)
    elif task == "multiple_choice":
        result = evaluate_multiple_choice(
            params, config, items, iface.tokenize, batch_size,
            prompt_template=prompt_template)
    else:
        raise ValueError(f"Unknown eval task: {task}")
    logger.info("Eval %s on %s: %s", task, data_path, result)
    return result
