"""Manual vocabulary handling: the ``vocab.json`` reading that the datasets
and the training pipeline use.

A copy of that part of ``apertis_llm_tpu/utils/vocab.py`` (which imports no
JAX, but its package does; reference: interface.py:343-360,
pipeline.py:33-73). The whitespace ``ManualTokenizer`` and the HF tokenizer
discovery serve the inference surfaces and come with them (ROADMAP.md,
module 6).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict

logger = logging.getLogger(__name__)

FALLBACK_SPECIALS = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3}


def load_vocabulary(vocab_file: str | os.PathLike) -> Dict[str, int]:
    """Load {token: id} from vocab.json, accepting either a direct mapping or
    ``{"tokens": [...]}`` list form (reference: interface.py:343-360)."""
    with open(vocab_file, "r", encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        if "tokens" in data and isinstance(data["tokens"], list):
            return {tok: idx for idx, tok in enumerate(data["tokens"])}
        return {k: int(v) for k, v in data.items()}
    raise ValueError(f"Unsupported vocabulary format in {vocab_file}: {type(data)}")


def vocab_size_from_mapping(vocab: Dict[str, int]) -> int:
    """Effective size = max id + 1, validating ids (reference: pipeline.py:33-73)."""
    if not vocab:
        return 0
    ids = list(vocab.values())
    if any(i < 0 for i in ids):
        raise ValueError("Vocabulary contains negative token ids")
    if len(set(ids)) != len(ids):
        logger.warning("Vocabulary contains duplicate token ids")
    return max(ids) + 1


def fallback_vocab(size: int = 100) -> Dict[str, int]:
    vocab = dict(FALLBACK_SPECIALS)
    for i in range(4, size):
        vocab[f"<tok{i}>"] = i
    return vocab


def create_minimal_vocab_file(path: str | os.PathLike, size: int = 100) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(fallback_vocab(size), f, indent=2)
