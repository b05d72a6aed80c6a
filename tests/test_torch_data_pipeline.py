"""The port's data pipeline (``apertis_llm_torch/data_pipeline``) against the
JAX package's: the same inputs go through both (CPU, host-only stages, no
stage fetches anything). WARC files written by either package read back the
same in both; MinHash signatures and dedup decisions are equal; clean →
deduplicate → tokenize over a local WARC and vocabulary writes byte-equal
text files and equal Parquet rows; the YAML sample configuration is
byte-equal and round-trips; and the Spark backend falls back to the local
one without ``pyspark`` and, against a stand-in ``pyspark``, calls the same
API and gives the local backend's outputs (``tests/test_data_pipeline.py``'s
checks of the JAX package)."""

import dataclasses
import gzip
import importlib.util
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from apertis_llm_tpu.data_pipeline import config as jax_config
from apertis_llm_tpu.data_pipeline import main as jax_main
from apertis_llm_tpu.data_pipeline import minhash as jax_minhash
from apertis_llm_tpu.data_pipeline import spark_backend as jax_spark
from apertis_llm_tpu.data_pipeline import tokenize as jax_tokenize
from apertis_llm_tpu.data_pipeline import warc as jax_warc
from apertis_llm_torch.data_pipeline import config as port_config
from apertis_llm_torch.data_pipeline import main as port_main
from apertis_llm_torch.data_pipeline import minhash as port_minhash
from apertis_llm_torch.data_pipeline import spark_backend as port_spark
from apertis_llm_torch.data_pipeline import tokenize as port_tokenize
from apertis_llm_torch.data_pipeline import warc as port_warc

PACKAGES = {"jax": (jax_config, jax_main, jax_tokenize, jax_spark),
            "port": (port_config, port_main, port_tokenize, port_spark)}
VOCAB = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3,
         "the": 4, "cat": 5, "dog": 6, "sat": 7, "on": 8, "mat": 9, "sea": 10, "and": 11}


def _make_warc(path: Path, write_warc_response, n_pages=7):
    """The synthetic crawl of ``tests/test_data_pipeline.py``: two near
    duplicates, a German page, distinct English pages; one page more."""
    para = ("the cat sat on the mat and the dog ran fast in the sun while "
            "we were watching from the house by the old road ") * 8
    near_dup = para.replace("old road", "new road")
    foreign = ("das ist ein langer deutscher Text ohne englische Wörter "
               "überhaupt und er geht weiter und weiter ") * 8
    pages = [para, near_dup, foreign] + [
        f"page number {i} talks about the weather and the sea and the "
        f"mountains with many different words like {'word%d ' % i * 40}"
        for i in range(n_pages - 3)]
    with gzip.open(path, "wb") as f:
        for i, html_text in enumerate(pages):
            html = (f"<html><head><script>var x=1;</script></head><body><nav>menu</nav>"
                    f"<p>{html_text}</p></body></html>")
            write_warc_response(f, f"http://example.com/{i}", html.encode())
    return pages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_warc_read_back(tmp_path, writer):
    write = (jax_warc if writer == "jax" else port_warc).write_warc_response
    path = tmp_path / "crawl.warc.gz"
    _make_warc(path, write)
    ours = list(port_warc.iter_html_responses(str(path)))
    assert ours == list(jax_warc.iter_html_responses(str(path)))
    assert len(ours) == 7 and ours[0][0] == "http://example.com/0"
    assert list(port_warc.iter_warc_records(str(path))) == \
        list(jax_warc.iter_warc_records(str(path)))


def _texts(seed=0, n=12):
    rng = np.random.default_rng(seed)
    words = "alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu".split()
    base = [" ".join(rng.choice(words, 60)) for _ in range(n // 2)]
    edits = []
    for text in base:
        toks = text.split()
        toks[int(rng.integers(len(toks)))] = "omega"
        edits.append(" ".join(toks))
    return base + edits + ["short text", ""]


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.8])
def test_minhash_signatures_and_decisions(threshold):
    texts = _texts()
    for perms, seed in ((128, 1), (64, 7)):
        ours, theirs = port_minhash.MinHasher(perms, seed), jax_minhash.MinHasher(perms, seed)
        for text in texts:
            np.testing.assert_array_equal(ours.signature(text), theirs.signature(text))
    assert (port_minhash.deduplicate_texts(texts, threshold=threshold)
            == jax_minhash.deduplicate_texts(texts, threshold=threshold))
    sigs = [port_minhash.MinHasher(128).signature(t) for t in texts]
    pairs = port_minhash.lsh_candidate_pairs(sigs, 16)
    assert pairs == jax_minhash.lsh_candidate_pairs(sigs, 16) and pairs


def _pipeline_config(pkg, tmp_path, raw, vocab_path, **kw):
    cfg = PACKAGES[pkg][0]
    out = tmp_path / pkg
    return cfg.DataPipelineConfig(
        stages=["clean", "deduplicate", "tokenize"],
        clean=cfg.CleanConfig(input_dir=str(raw), output_dir=str(out / "clean"),
                              min_text_length=50, fasttext_model_path="/nonexistent"),
        deduplicate=cfg.DeduplicateConfig(input_dir=str(out / "clean"),
                                          output_dir=str(out / "dedup"),
                                          minhash_threshold=0.5, num_partitions=1),
        tokenize=cfg.TokenizeConfig(input_dir=str(out / "dedup"),
                                    output_dir=str(out / "tok"),
                                    tokenizer_path=str(vocab_path), max_seq_length=64),
        num_workers=1, **kw)


@pytest.fixture()
def crawl(tmp_path, monkeypatch):
    """Two WARC files and a vocabulary; the tokenizers each module caches
    a process are dropped so this test's vocabulary is read."""
    for module in (jax_tokenize, port_tokenize):
        monkeypatch.setattr(module, "_WORKER_TOKENIZER", None)
    raw = tmp_path / "raw"
    raw.mkdir()
    _make_warc(raw / "crawl-00.warc.gz", port_warc.write_warc_response)
    _make_warc(raw / "crawl-01.warc.gz", port_warc.write_warc_response, n_pages=5)
    vocab_path = tmp_path / "vocab.json"
    vocab_path.write_text(json.dumps(VOCAB))
    return raw, vocab_path


def _files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.txt"))}


def test_clean_dedup_tokenize_equal(tmp_path, crawl):
    raw, vocab_path = crawl
    results = {pkg: PACKAGES[pkg][1].run_pipeline(_pipeline_config(pkg, tmp_path, raw,
                                                                   vocab_path))
               for pkg in PACKAGES}
    assert results["port"] == results["jax"]
    # 12 pages, 10 English; 4 kept at a threshold of 0.5: one of the four
    # copies of the paragraph, three of the six page-number pages (whose
    # estimates are 0.50-0.56 where the bands pair them).
    assert results["port"]["deduplicate"] == (10, 4)
    assert results["port"]["tokenize"] == 4
    for stage in ("clean", "dedup"):
        ours, theirs = _files(tmp_path / "port" / stage), _files(tmp_path / "jax" / stage)
        assert ours == theirs and ours, stage
    rows = port_tokenize.load_tokenized_dataset(str(tmp_path / "port" / "tok"))
    assert rows == jax_tokenize.load_tokenized_dataset(str(tmp_path / "jax" / "tok"))
    assert len(rows) == 4 and all(len(r) <= 64 for r in rows) and any(4 in r for r in rows)


def test_yaml_config_round_trip(tmp_path):
    ours, theirs = tmp_path / "port.yaml", tmp_path / "jax.yaml"
    port_config.create_sample_pipeline_config(str(ours))
    jax_config.create_sample_pipeline_config(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    loaded = port_config.DataPipelineConfig.from_yaml(str(ours))
    assert dataclasses.asdict(loaded) == dataclasses.asdict(port_config.DataPipelineConfig())
    edited = tmp_path / "edited.yaml"
    edited.write_text("backend: spark\nnum_workers: 3\nstages: [clean, tokenize]\n"
                      "deduplicate:\n  minhash_threshold: 0.6\n  lsh_num_bands: 8\n"
                      "tokenize:\n  tokenizer_path: vocab.json\n  max_seq_length: 128\n"
                      "spark:\n  master: local[2]\n  extra_configs: {a: b}\n")
    ours_cfg = port_config.DataPipelineConfig.from_yaml(str(edited))
    theirs_cfg = jax_config.DataPipelineConfig.from_yaml(str(edited))
    assert dataclasses.asdict(ours_cfg) == dataclasses.asdict(theirs_cfg)
    assert (ours_cfg.backend, ours_cfg.num_workers, ours_cfg.deduplicate.lsh_num_bands,
            ours_cfg.spark.extra_configs) == ("spark", 3, 8, {"a": "b"})


def test_spark_backend_falls_back_to_local(tmp_path):
    if importlib.util.find_spec("pyspark") is not None:
        pytest.skip("pyspark installed; the fall-back is not taken")
    results = {}
    for pkg, (cfg, main, _, _) in PACKAGES.items():
        src = tmp_path / pkg / "clean"
        src.mkdir(parents=True)
        (src / "a.txt").write_text("some document text here\n\nanother doc")
        config = cfg.DataPipelineConfig(
            stages=["deduplicate"], backend="spark",
            deduplicate=cfg.DeduplicateConfig(input_dir=str(src),
                                              output_dir=str(tmp_path / pkg / "out"),
                                              num_partitions=1))
        results[pkg] = main.run_pipeline(config)
    assert results["port"] == results["jax"] and results["port"]["deduplicate"][0] == 2


def _fake_pyspark(monkeypatch, calls):
    class FakeRDD:
        def __init__(self, items):
            self.items = list(items)

        def map(self, fn):
            return FakeRDD([fn(x) for x in self.items])

        def collect(self):
            return list(self.items)

    class FakeSC:
        def parallelize(self, items, n=None):
            assert n is None or n >= 1
            return FakeRDD(items)

    class FakeSession:
        def __init__(self):
            self.sparkContext = FakeSC()

        def stop(self):
            calls["stopped"].append(True)

    class Builder:
        def appName(self, name):
            calls["configs"].append(("appName", name))
            return self

        def master(self, m):
            calls["configs"].append(("master", m))
            return self

        def config(self, k, v):
            calls["configs"].append((k, v))
            return self

        def getOrCreate(self):
            return FakeSession()

    fake_sql = types.ModuleType("pyspark.sql")
    fake_sql.SparkSession = type("SparkSession", (), {"builder": Builder()})
    fake = types.ModuleType("pyspark")
    fake.sql = fake_sql
    monkeypatch.setitem(sys.modules, "pyspark", fake)
    monkeypatch.setitem(sys.modules, "pyspark.sql", fake_sql)


def test_spark_backend_contract_with_fake_pyspark(tmp_path, crawl, monkeypatch):
    """``run_pipeline_spark`` against a stand-in ``pyspark`` (builder chain,
    ``parallelize``/``map``/``collect``, ``stop``): the same session
    settings and outputs as the JAX package's, and the local backend's
    outputs."""
    raw, vocab_path = crawl
    calls = {pkg: {"configs": [], "stopped": []} for pkg in PACKAGES}
    results = {}
    for pkg in PACKAGES:
        _fake_pyspark(monkeypatch, calls[pkg])
        config = _pipeline_config(pkg, tmp_path, raw, vocab_path, backend="spark")
        results[pkg] = PACKAGES[pkg][1].run_pipeline(config)
    assert calls["port"] == calls["jax"] and calls["port"]["stopped"] == [True]
    assert results["port"]["deduplicate"] == results["jax"]["deduplicate"] == (10, 4)
    counts = [sum(int(str(r).rsplit(":", 1)[1]) for r in results[pkg]["tokenize"])
              for pkg in PACKAGES]
    assert counts == [4, 4]
    for stage in ("clean", "dedup"):
        assert _files(tmp_path / "port" / stage) == _files(tmp_path / "jax" / stage)
    rows = port_tokenize.load_tokenized_dataset(str(tmp_path / "port" / "tok"))
    assert rows == jax_tokenize.load_tokenized_dataset(str(tmp_path / "jax" / "tok"))
    keys = dict(c for c in calls["port"]["configs"])
    assert keys["spark.driver.memory"] == port_config.SparkConfig().driver_memory
