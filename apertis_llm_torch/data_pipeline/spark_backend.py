"""PySpark backend for the data pipeline (optional).

Used when ``backend: spark`` is configured AND pyspark is installed; mirrors
the reference's cluster execution model (reference:
src/data_pipeline/spark_utils.py:7-54, download.py, clean.py, tokenize.py):
a session built from SparkConfig, stage fan-out as RDD maps, teardown in a
finally block. The per-item work is delegated to the same functions the local
backend uses, so both backends share one implementation of the actual logic.

The port's copy of ``apertis_llm_tpu/data_pipeline/spark_backend.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from apertis_llm_torch.data_pipeline.config import DataPipelineConfig, SparkConfig

logger = logging.getLogger(__name__)


def get_spark_session(config: SparkConfig):
    from pyspark.sql import SparkSession

    builder = (SparkSession.builder
               .appName("apertis-data-pipeline")
               .master(config.master)
               .config("spark.driver.memory", config.driver_memory)
               .config("spark.executor.memory", config.executor_memory)
               .config("spark.executor.cores", str(config.executor_cores)))
    if config.num_executors:
        builder = builder.config("spark.executor.instances",
                                 str(config.num_executors))
    for key, value in (config.extra_configs or {}).items():
        builder = builder.config(key, str(value))
    return builder.getOrCreate()


def run_pipeline_spark(config: DataPipelineConfig) -> Dict[str, Any]:
    spark = get_spark_session(config.spark)
    sc = spark.sparkContext
    results: Dict[str, Any] = {}
    try:
        if "download" in config.stages:
            from apertis_llm_torch.data_pipeline.download import (
                download_warc, fetch_warc_paths)

            paths = fetch_warc_paths(config.download.warc_paths_url,
                                     config.download.num_warc_files)
            out_dir = config.download.output_dir
            rdd = sc.parallelize(paths, config.download.num_partitions)
            results["download"] = rdd.map(
                lambda p: download_warc(p, out_dir)).collect()

        if "clean" in config.stages:
            from pathlib import Path

            from apertis_llm_torch.data_pipeline.clean import clean_warc_file

            clean_cfg = config.clean
            files = sorted(str(p) for p in Path(clean_cfg.input_dir).glob("**/*")
                           if p.is_file() and ".warc" in p.name)
            rdd = sc.parallelize(files, clean_cfg.num_partitions)
            pairs = rdd.map(lambda p: (p, clean_warc_file(p, clean_cfg))).collect()
            out_dir = Path(clean_cfg.output_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            total = 0
            for path, texts in pairs:
                if texts:
                    out = out_dir / (Path(path).name.split(".warc")[0] + ".txt")
                    out.write_text("\n\n".join(texts), encoding="utf-8")
                    total += len(texts)
            results["clean"] = total

        if "deduplicate" in config.stages:
            # Signatures distribute; candidate clustering + union-find stay on
            # the driver (same topology as the reference, deduplicate.py:85-154).
            from apertis_llm_torch.data_pipeline.deduplicate import (
                run_deduplicate_stage)

            results["deduplicate"] = run_deduplicate_stage(config.deduplicate)

        if "tokenize" in config.stages:
            from pathlib import Path

            from apertis_llm_torch.data_pipeline.tokenize import _tokenize_file

            tok_cfg = config.tokenize
            Path(tok_cfg.output_dir).mkdir(parents=True, exist_ok=True)
            files = sorted(str(p) for p in Path(tok_cfg.input_dir).glob("**/*.txt"))
            rdd = sc.parallelize(files, tok_cfg.num_partitions)
            results["tokenize"] = rdd.map(
                lambda f: _tokenize_file((f, tok_cfg))).collect()
    finally:
        spark.stop()
    return results
