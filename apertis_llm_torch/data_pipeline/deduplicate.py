"""Deduplicate stage: MinHash/LSH near-duplicate removal across text files.

Behavioural port of the reference stage (reference:
src/data_pipeline/deduplicate.py:85-154): MinHash signatures, LSH candidate
clustering, connected components, keep the minimum-id representative of each
duplicate cluster. Implementation is the vectorised numpy MinHasher +
union-find from :mod:`minhash` (no datasketch, no driver-side DFS).

The port's copy of ``apertis_llm_tpu/data_pipeline/deduplicate.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Tuple

from apertis_llm_torch.data_pipeline.config import DeduplicateConfig
from apertis_llm_torch.data_pipeline.minhash import deduplicate_texts

logger = logging.getLogger(__name__)


def _load_documents(input_dir: str) -> List[Tuple[str, str]]:
    """Read (source_file, document) pairs; documents are blank-line separated."""
    docs = []
    for path in sorted(Path(input_dir).glob("**/*.txt")):
        content = path.read_text(encoding="utf-8")
        for doc in content.split("\n\n"):
            doc = doc.strip()
            if doc:
                docs.append((path.name, doc))
    return docs


def run_deduplicate_stage(config: DeduplicateConfig) -> Tuple[int, int]:
    """Returns (total_documents, kept_documents)."""
    out_dir = Path(config.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    docs = _load_documents(config.input_dir)
    if not docs:
        logger.warning("No documents found under %s", config.input_dir)
        return 0, 0

    keep = deduplicate_texts(
        [d for _, d in docs],
        threshold=config.minhash_threshold,
        num_permutations=config.num_minhash_permutations,
        num_bands=config.lsh_num_bands,
    )
    kept_docs = [docs[i][1] for i in keep]

    shard_size = max(1, len(kept_docs) // max(config.num_partitions, 1) + 1)
    for shard_idx in range(0, len(kept_docs), shard_size):
        shard = kept_docs[shard_idx:shard_idx + shard_size]
        out_file = out_dir / f"part-{shard_idx // shard_size:05d}.txt"
        out_file.write_text("\n\n".join(shard), encoding="utf-8")

    logger.info("Deduplicate stage: kept %d / %d documents",
                len(kept_docs), len(docs))
    return len(docs), len(kept_docs)
