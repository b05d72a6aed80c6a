"""Download stage: fetch Common Crawl WARC files.

Behavioural port of the reference download stage (reference:
src/data_pipeline/download.py:8-85): fetch the crawl's ``warc.paths.gz``
manifest, take the first N paths, and stream each WARC to the output
directory — concurrently via a thread pool (downloads are IO-bound; the
reference used a Spark RDD for the same fan-out).

The port's copy of ``apertis_llm_tpu/data_pipeline/download.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import gzip
import io
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

from apertis_llm_torch.data_pipeline.config import DownloadConfig

logger = logging.getLogger(__name__)

CC_BASE = "https://data.commoncrawl.org/"


def fetch_warc_paths(warc_paths_url: str, limit: int) -> List[str]:
    import requests

    resp = requests.get(warc_paths_url, timeout=60)
    resp.raise_for_status()
    with gzip.open(io.BytesIO(resp.content), "rt") as f:
        paths = [line.strip() for line in f if line.strip()]
    return paths[:limit]


def download_warc(path: str, output_dir: str, base_url: str = CC_BASE) -> str:
    """Stream one WARC to disk; returns SUCCESS/FAILURE markers like the
    reference executors did (download.py:20-43)."""
    import requests

    url = base_url + path
    out_path = Path(output_dir) / Path(path).name
    if out_path.exists() and out_path.stat().st_size > 0:
        return f"SKIPPED {path}"
    try:
        with requests.get(url, stream=True, timeout=120) as r:
            r.raise_for_status()
            tmp = out_path.with_suffix(".part")
            with open(tmp, "wb") as f:
                for chunk in r.iter_content(chunk_size=1 << 20):
                    f.write(chunk)
            os.replace(tmp, out_path)
        return f"SUCCESS {path}"
    except Exception as e:
        logger.warning("Failed to download %s: %s", url, e)
        return f"FAILURE {path}: {e}"


def run_download_stage(config: DownloadConfig,
                       num_workers: Optional[int] = None) -> List[str]:
    Path(config.output_dir).mkdir(parents=True, exist_ok=True)
    if not config.warc_paths_url:
        logger.warning("No warc_paths_url configured; skipping download.")
        return []
    paths = fetch_warc_paths(config.warc_paths_url, config.num_warc_files)
    logger.info("Downloading %d WARC files to %s", len(paths), config.output_dir)
    workers = num_workers or min(16, max(4, len(paths)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(
            lambda p: download_warc(p, config.output_dir), paths))
    ok = sum(1 for r in results if r.startswith(("SUCCESS", "SKIPPED")))
    logger.info("Download stage: %d/%d succeeded", ok, len(results))
    return results
