"""Manual vocabulary handling (whitespace tokenizer) + HF tokenizer discovery.

A copy of ``apertis_llm_tpu/utils/vocab.py`` (which imports no JAX, but its
package does; reference: interface.py:343-454, pipeline.py:33-73): a Hugging
Face tokenizer when one is discoverable (``transformers`` installed), else a
plain ``vocab.json`` mapping with whitespace splitting and unk/out-of-bounds
remapping.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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


class ManualTokenizer:
    """Whitespace tokenizer over a {token: id} vocabulary."""

    def __init__(self, vocab: Dict[str, int], unk_token_id: int = 3,
                 model_vocab_size: Optional[int] = None):
        self.vocab = vocab
        self.reverse_vocab = {v: k for k, v in vocab.items()}
        self.unk_token_id = vocab.get("<unk>", unk_token_id)
        self.model_vocab_size = model_vocab_size

    def encode(self, text: str) -> List[int]:
        ids = [self.vocab.get(w, self.unk_token_id) for w in text.split()]
        if self.model_vocab_size is not None:
            ids = [i if i < self.model_vocab_size else self.unk_token_id for i in ids]
        return ids

    def decode(self, token_ids: List[int],
               skip_ids: Tuple[int, ...] = (0, 1, 2)) -> str:
        words = []
        for tid in token_ids:
            tid = int(tid)
            if tid in skip_ids:
                continue
            word = self.reverse_vocab.get(tid)
            words.append(word if word is not None else f"[UNK_ID:{tid}]")
        return " ".join(words)


def try_load_hf_tokenizer(path_or_name: str):
    """Attempt HF tokenizer discovery (reference: interface.py:98-126).
    Returns the tokenizer, or None (always where ``transformers`` is not
    installed)."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        logger.info("transformers not installed; HF tokenizer unavailable")
        return None
    p = Path(path_or_name)
    looks_like_dir = p.is_dir() and (
        (p / "tokenizer.json").exists()
        or ((p / "vocab.json").exists() and (p / "merges.txt").exists())
        or (p / "tokenizer_config.json").exists())
    try:
        if looks_like_dir or not p.is_dir():
            return AutoTokenizer.from_pretrained(str(path_or_name))
    except Exception as e:
        logger.debug("HF tokenizer load failed for %s: %s", path_or_name, e)
    return None
