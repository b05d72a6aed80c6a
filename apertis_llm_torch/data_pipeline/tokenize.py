"""Tokenize stage: text shards -> Parquet of ``input_ids``.

Behavioural port of the reference stage (reference:
src/data_pipeline/tokenize.py:7-75): per-worker HF tokenizer, truncate to
max_seq_length, no padding, Parquet output ("arrow" is an alias for parquet).
A manual ``vocab.json`` path is also accepted (whitespace tokenizer), so the
stage works without the transformers hub.

The port's copy of ``apertis_llm_tpu/data_pipeline/tokenize.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import json
import logging
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import List, Optional

from apertis_llm_torch.data_pipeline.config import TokenizeConfig

logger = logging.getLogger(__name__)

_WORKER_TOKENIZER = None


def _get_tokenizer(tokenizer_path: str):
    global _WORKER_TOKENIZER
    if _WORKER_TOKENIZER is None:
        if tokenizer_path.endswith(".json") and os.path.exists(tokenizer_path):
            try:
                from tokenizers import Tokenizer

                _WORKER_TOKENIZER = ("hf_fast", Tokenizer.from_file(tokenizer_path))
            except Exception:
                from apertis_llm_torch.utils.vocab import (
                    ManualTokenizer, load_vocabulary)

                _WORKER_TOKENIZER = (
                    "manual", ManualTokenizer(load_vocabulary(tokenizer_path)))
        else:
            from transformers import AutoTokenizer

            _WORKER_TOKENIZER = (
                "hf", AutoTokenizer.from_pretrained(tokenizer_path))
    return _WORKER_TOKENIZER


def _encode(text: str, tokenizer_path: str, max_len: int) -> List[int]:
    kind, tok = _get_tokenizer(tokenizer_path)
    if kind == "hf":
        return tok(text, truncation=True, max_length=max_len)["input_ids"]
    if kind == "hf_fast":
        return tok.encode(text).ids[:max_len]
    return tok.encode(text)[:max_len]


def _tokenize_file(args) -> str:
    path, config = args
    import pyarrow as pa
    import pyarrow.parquet as pq

    docs = [d.strip() for d in Path(path).read_text(encoding="utf-8").split("\n\n")
            if d.strip()]
    rows = [_encode(d, config.tokenizer_path, config.max_seq_length)
            for d in docs]
    rows = [r for r in rows if r]
    out_dir = Path(config.output_dir)
    out_file = out_dir / (Path(path).stem + ".parquet")
    table = pa.table({"input_ids": pa.array(rows, type=pa.list_(pa.int32()))})
    pq.write_table(table, out_file)
    return f"{out_file}:{len(rows)}"


def run_tokenize_stage(config: TokenizeConfig,
                       num_workers: Optional[int] = None) -> int:
    out_dir = Path(config.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fmt = config.output_format.lower()
    if fmt == "arrow":
        fmt = "parquet"  # alias, as in the reference (tokenize.py:62-65)
    if fmt != "parquet":
        raise ValueError(f"Unsupported output_format: {config.output_format}")

    files = sorted(str(p) for p in Path(config.input_dir).glob("**/*.txt"))
    if not files:
        logger.warning("No text files under %s", config.input_dir)
        return 0
    jobs = [(f, config) for f in files]
    if num_workers is None or num_workers > 1:
        with ProcessPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(_tokenize_file, jobs))
    else:
        results = [_tokenize_file(j) for j in jobs]
    total = sum(int(r.rsplit(":", 1)[1]) for r in results)
    logger.info("Tokenize stage: %d sequences -> %s", total, out_dir)
    return total


def load_tokenized_dataset(parquet_dir: str) -> List[List[int]]:
    """Read back tokenized shards (feeds the training loader)."""
    import pyarrow.parquet as pq

    rows: List[List[int]] = []
    for path in sorted(Path(parquet_dir).glob("**/*.parquet")):
        table = pq.read_table(path)
        rows.extend(table.column("input_ids").to_pylist())
    return rows
