"""The port's ``apertis-torch`` CLI against the JAX package's ``apertis``.

The parser has the JAX parser's subcommands, flags and defaults (the port
adds ``--device`` to ``create-model`` and ``eval``, whose JAX forms take no
device: the port's entry points run on the card unless told otherwise);
``create-model`` writes a checkpoint that JAX's ``load_pretrained`` reads
with an equal config; ``create-config`` writes JAX's sample; ``chat`` serves
a piped conversation; the two data-pipeline subcommands write JAX's sample
configuration and run the local stages to JAX's outputs. Everything runs on
the CPU (``--device cpu``).
"""

import gzip
import io
import json

import numpy as np
import pytest
import torch

from apertis_llm_tpu import cli as jax_cli
from apertis_llm_tpu.models.convert import load_pretrained as jax_load_pretrained
from apertis_llm_tpu.training.pipeline import create_sample_config as jax_sample_config
from apertis_llm_torch import cli
from apertis_llm_torch.models.convert import read_pretrained

torch.set_num_threads(2)

PORT_ONLY = {("create-model", "device"), ("eval", "device")}


def _actions(parser):
    """{subcommand: {dest: (flags, default, type, choices, required, nargs,
    const, action class)}} of a parser."""
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    out = {}
    for name, p in sub.choices.items():
        out[name] = {a.dest: (tuple(a.option_strings), a.default,
                              getattr(a.type, "__name__", a.type) if a.type else None,
                              tuple(a.choices) if a.choices else None, a.required, a.nargs,
                              a.const, type(a).__name__)
                     for a in p._actions if a.dest != "help"}
    return out


def test_parser_matches_jax():
    jax_parser, parser = _actions(jax_cli.build_parser()), _actions(cli.build_parser())
    assert list(parser) == list(jax_parser)
    for name, jax_flags in jax_parser.items():
        flags = {d: v for d, v in parser[name].items() if (name, d) not in PORT_ONLY}
        assert flags.keys() == jax_flags.keys(), name
        for dest, spec in jax_flags.items():
            if dest.startswith("use_"):          # the `_bool` converters: same behaviour
                assert spec[:2] == flags[dest][:2] and spec[3:] == flags[dest][3:], dest
                continue
            assert flags[dest] == spec, (name, dest)
    for name, dest in PORT_ONLY:
        assert parser[name][dest][1] is None      # default: the card
    args = cli.build_parser().parse_args(["chat"])
    assert (args.max_length, args.temperature, args.top_k, args.top_p) == (100, 0.7, 50, 0.9)


def test_create_model_is_read_by_jax(tmp_path, capsys):
    out = tmp_path / "m"
    config = cli.main(["create-model", "--target-params", "1M", "--vocab-size", "128",
                       "--attention-type", "selective_ssm", "--output-dir", str(out),
                       "--seed", "3", "--device", "cpu"])
    assert "Model created successfully!" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == ["config.json", "model.pt", "vocab.json"]
    jcfg, jparams = jax_load_pretrained(str(out))
    assert jcfg.to_dict() == config.to_dict()
    _, tree = read_pretrained(out)
    jleaves, leaves = dict(_flatten(jparams)), dict(_flatten(tree))
    assert leaves.keys() == jleaves.keys()
    for key, value in leaves.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jleaves[key]), err_msg=key)


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, name + "/")
        else:
            yield name, value


def test_create_config_matches_jax(tmp_path):
    cli.main(["create-config", "--output", str(tmp_path / "port.json")])
    jax_sample_config(str(tmp_path / "jax.json"))
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))


def test_chat_serves_piped_turns(tmp_path, monkeypatch, capsys):
    """Two turns, a reset and ``exit`` on stdin at temperature 0: each reply
    streams to stdout and equals the interface's ``generate`` reply, and
    the history holds the turns."""
    out = tmp_path / "m"
    cli.main(["create-model", "--target-params", "1M", "--vocab-size", "64",
              "--attention-type", "selective_ssm", "--output-dir", str(out), "--device", "cpu"])
    monkeypatch.setattr("sys.stdin", io.StringIO("hello there\nreset\nhow are you\nexit\n"))
    capsys.readouterr()
    iface = cli.main(["chat", "--model-path", str(out), "--device", "cpu", "--temperature", "0",
                      "--max-length", "6"])
    text = capsys.readouterr().out
    assert iface.actual_model_path_loaded == str(out)
    assert "Chat history reset" in text and text.count("Apertis: ") == 2
    assert [e["role"] for e in iface.chat_history] == ["user", "assistant"]
    reply = iface.chat_history[1]["content"]
    assert f"Apertis: {reply}\n" in text
    iface.reset_chat()
    assert iface.generate_response(iface._chat_prompt("how are you"), temperature=0.0,
                                   max_length=6) == reply


def _pipeline_yaml(root, name, raw, vocab):
    """A pipeline configuration of the local stages (clean, deduplicate,
    tokenize) over ``raw``, writing under ``root / name``."""
    out = root / name
    path = root / f"{name}.yaml"
    path.write_text(
        "stages: [clean, deduplicate, tokenize]\nnum_workers: 1\n"
        f"clean:\n  input_dir: {raw}\n  output_dir: {out / 'clean'}\n"
        "  min_text_length: 50\n  fasttext_model_path: /nonexistent\n"
        f"deduplicate:\n  input_dir: {out / 'clean'}\n  output_dir: {out / 'dedup'}\n"
        "  minhash_threshold: 0.5\n  num_partitions: 1\n"
        f"tokenize:\n  input_dir: {out / 'dedup'}\n  output_dir: {out / 'tok'}\n"
        f"  tokenizer_path: {vocab}\n  max_seq_length: 64\n")
    return path


@pytest.mark.parametrize("command", [["data-pipeline", "--config", "x.yaml"],
                                     ["create-pipeline-config"]])
def test_data_pipeline_subcommands_refuse(command, tmp_path, monkeypatch, capsys):
    """The two data-pipeline subcommands (which refused until the data
    pipeline was ported) against JAX's CLI: ``create-pipeline-config``
    writes JAX's file byte for byte; ``data-pipeline --config`` runs the
    local stages of a YAML configuration to JAX's outputs and returns the
    results, and a missing configuration exits with status 1."""
    from apertis_llm_tpu.data_pipeline import tokenize as jax_tokenize
    from apertis_llm_tpu.data_pipeline.warc import write_warc_response
    from apertis_llm_torch.data_pipeline import tokenize as port_tokenize
    from apertis_llm_torch.data_pipeline.tokenize import load_tokenized_dataset

    monkeypatch.chdir(tmp_path)
    if command[0] == "create-pipeline-config":
        cli.main(command)
        assert "Sample data pipeline configuration created at: pipeline_config.yaml" in \
            capsys.readouterr().out
        jax_cli.main(["create-pipeline-config", "--output", "jax.yaml"])
        assert (tmp_path / "pipeline_config.yaml").read_bytes() == \
            (tmp_path / "jax.yaml").read_bytes()
        return
    with pytest.raises(SystemExit) as missing:
        cli.main(command)
    assert missing.value.code == 1
    for module in (jax_tokenize, port_tokenize):
        monkeypatch.setattr(module, "_WORKER_TOKENIZER", None)
    raw = tmp_path / "raw"
    raw.mkdir()
    with gzip.open(raw / "crawl.warc.gz", "wb") as f:
        pages = ["the cat sat on the mat " * 20, "the cat sat on the mat " * 19 + "a dog",
                 "a dog ran in the sun and the sea was calm " * 12, "kurz und deutsch " * 30]
        for i, text in enumerate(pages):
            write_warc_response(f, f"http://example.com/{i}", f"<p>{text}</p>".encode())
    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps({"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3, "the": 4,
                                 "cat": 5, "dog": 6, "sat": 7, "on": 8, "mat": 9}))
    _pipeline_yaml(tmp_path, "x", raw, vocab)
    results = cli.main(command)
    jax_cli.main(["data-pipeline", "--config", str(_pipeline_yaml(tmp_path, "j", raw, vocab))])
    assert results["deduplicate"] == (3, 2) and results["tokenize"] == 2
    for stage, name in (("clean", "crawl.txt"), ("dedup", "part-00000.txt")):
        assert ((tmp_path / "x" / stage / name).read_bytes()
                == (tmp_path / "j" / stage / name).read_bytes())
    rows = load_tokenized_dataset(str(tmp_path / "x" / "tok"))
    assert rows == load_tokenized_dataset(str(tmp_path / "j" / "tok")) and len(rows) == 2


def test_train_subcommand_runs_a_config(tmp_path, capsys):
    """``train --config`` on a fine-tuning config of the created model (CPU,
    one update): the metrics come back and are printed."""
    base = tmp_path / "base"
    cli.main(["create-model", "--target-params", "1M", "--vocab-size", "64",
              "--attention-type", "selective_ssm", "--output-dir", str(base), "--device", "cpu"])
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3,
             **{f"w{i}": i for i in range(4, 64)}}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    rows = [{"instruction": " ".join(f"w{4 + (i + j) % 60}" for j in range(6)),
             "output": " ".join(f"w{10 + (i * j) % 50}" for j in range(5))} for i in range(4)]
    (tmp_path / "sft.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (tmp_path / "cfg.json").write_text(json.dumps({
        "data_config": {"train_data_path": str(tmp_path / "sft.jsonl"),
                        "tokenizer_path": str(tmp_path / "vocab.json"), "max_length": 16},
        "model_config": {},
        "training_config": {"task_type": "finetune", "device": "cpu", "bf16": False,
                            "pretrained_model_path_for_finetune": str(base),
                            "output_dir": str(tmp_path / "out"), "batch_size": 4,
                            "gradient_accumulation_steps": 1, "num_epochs": 1,
                            "use_gradient_checkpointing": False}}))
    metrics = cli.main(["train", "--config", str(tmp_path / "cfg.json")])
    assert metrics["final_step"] == 1 and np.isfinite(metrics["train_loss"][0])
    assert "Training completed!" in capsys.readouterr().out
