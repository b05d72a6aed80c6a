"""Data pipeline orchestrator (reference: src/data_pipeline/main.py:20-51).

Runs the enabled stages in order on the selected backend. The local backend
(default) uses thread/process pools; the Spark backend delegates to
:mod:`spark_backend` when pyspark is installed.

The port's copy of ``apertis_llm_tpu/data_pipeline/main.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from apertis_llm_torch.data_pipeline.config import DataPipelineConfig

logger = logging.getLogger(__name__)

STAGE_ORDER = ("download", "clean", "deduplicate", "tokenize")


def run_pipeline(config: DataPipelineConfig) -> Dict[str, Any]:
    backend = config.backend
    if backend == "spark":
        try:
            import pyspark  # noqa: F401
        except ImportError:
            logger.warning("pyspark not installed; falling back to the local "
                           "backend.")
            backend = "local"

    if backend == "spark":
        from apertis_llm_torch.data_pipeline.spark_backend import (
            run_pipeline_spark)

        return run_pipeline_spark(config)

    results: Dict[str, Any] = {}
    stages = [s for s in STAGE_ORDER if s in config.stages]
    logger.info("Running data pipeline stages %s (local backend)", stages)
    for stage in stages:
        logger.info("=== stage: %s ===", stage)
        if stage == "download":
            from apertis_llm_torch.data_pipeline.download import run_download_stage

            results["download"] = run_download_stage(
                config.download, config.num_workers)
        elif stage == "clean":
            from apertis_llm_torch.data_pipeline.clean import run_clean_stage

            results["clean"] = run_clean_stage(config.clean, config.num_workers)
        elif stage == "deduplicate":
            from apertis_llm_torch.data_pipeline.deduplicate import (
                run_deduplicate_stage)

            results["deduplicate"] = run_deduplicate_stage(config.deduplicate)
        elif stage == "tokenize":
            from apertis_llm_torch.data_pipeline.tokenize import run_tokenize_stage

            results["tokenize"] = run_tokenize_stage(
                config.tokenize, config.num_workers)
    logger.info("Data pipeline finished: %s", {
        k: (v if not isinstance(v, list) else len(v)) for k, v in results.items()})
    return results
