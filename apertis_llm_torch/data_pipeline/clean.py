"""Clean stage: WARC -> extracted text -> language + length filters.

Behavioural port of the reference clean stage (reference:
src/data_pipeline/clean.py:15-100): BeautifulSoup text extraction dropping
script/style/nav/header/footer/aside, language-ID whitelist, length filter.

Language ID uses fastText when the model file exists (as in the reference);
otherwise a dependency-free stopword heuristic stands in so the stage always
runs.

The port's copy of ``apertis_llm_tpu/data_pipeline/clean.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import List, Optional

from apertis_llm_torch.data_pipeline.config import CleanConfig
from apertis_llm_torch.data_pipeline.warc import iter_html_responses

logger = logging.getLogger(__name__)

_DROP_TAGS = ("script", "style", "nav", "header", "footer", "aside", "form")

_EN_STOPWORDS = frozenset(
    "the of and to in a is that it for on with as are was be this by an at "
    "or from have has had not but they you we he she his her its their".split())


def extract_text(html: bytes) -> str:
    try:
        from bs4 import BeautifulSoup

        soup = BeautifulSoup(html, "html.parser")
        for tag in soup(_DROP_TAGS):
            tag.decompose()
        text = soup.get_text(separator=" ", strip=True)
        return " ".join(text.split())
    except Exception:
        return ""


class LanguageFilter:
    def __init__(self, fasttext_model_path: Optional[str],
                 whitelist: List[str]):
        self.whitelist = set(whitelist)
        self._model = None
        if fasttext_model_path and os.path.exists(fasttext_model_path):
            try:
                import fasttext

                self._model = fasttext.load_model(fasttext_model_path)
            except Exception as e:
                logger.warning("fastText unavailable (%s); using heuristic "
                               "language filter.", e)

    def accept(self, text: str) -> bool:
        if not self.whitelist:
            return True
        if self._model is not None:
            labels, _ = self._model.predict(text.replace("\n", " ")[:1000])
            lang = labels[0].replace("__label__", "") if labels else ""
            return lang in self.whitelist
        # Heuristic fallback: English stopword density + ASCII ratio.
        if "en" not in self.whitelist:
            return True
        words = text.lower().split()
        if not words:
            return False
        stop_ratio = sum(1 for w in words[:500] if w in _EN_STOPWORDS) / min(
            len(words), 500)
        ascii_ratio = sum(1 for c in text[:2000] if ord(c) < 128) / max(
            len(text[:2000]), 1)
        return stop_ratio > 0.08 and ascii_ratio > 0.8


def clean_warc_file(warc_path: str, config: CleanConfig) -> List[str]:
    """Extract + filter all documents of one WARC file."""
    lang = LanguageFilter(config.fasttext_model_path, config.language_whitelist)
    texts = []
    try:
        for _uri, html in iter_html_responses(warc_path):
            text = extract_text(html)
            if not (config.min_text_length <= len(text) <= config.max_text_length):
                continue
            if lang.accept(text):
                texts.append(text)
    except Exception as e:
        logger.warning("Error processing %s: %s", warc_path, e)
    return texts


def _worker(args) -> tuple:
    path, config = args
    return path, clean_warc_file(path, config)


def run_clean_stage(config: CleanConfig,
                    num_workers: Optional[int] = None) -> int:
    """Process every WARC under input_dir; one output text file per input
    (documents separated by blank lines). Returns the document count."""
    in_dir, out_dir = Path(config.input_dir), Path(config.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    warc_files = sorted(str(p) for p in in_dir.glob("**/*")
                        if p.is_file() and ".warc" in p.name)
    if not warc_files:
        logger.warning("No WARC files found under %s", in_dir)
        return 0

    total = 0
    jobs = [(p, config) for p in warc_files]
    if num_workers is None or num_workers > 1:
        with ProcessPoolExecutor(max_workers=num_workers) as pool:
            results = pool.map(_worker, jobs)
            results = list(results)
    else:
        results = [_worker(j) for j in jobs]
    for path, texts in results:
        if not texts:
            continue
        out_file = out_dir / (Path(path).name.split(".warc")[0] + ".txt")
        with open(out_file, "w", encoding="utf-8") as f:
            f.write("\n\n".join(texts))
        total += len(texts)
    logger.info("Clean stage: %d documents from %d WARC files",
                total, len(warc_files))
    return total
