"""The port's AI Studio UI: the gradio wiring with gradio stubbed, as
``tests/test_ui_wiring.py`` checks the JAX package's, and the
``UIBackend`` handlers on a real interface on the CPU: chat, the models tab
(load, create), a pre-training and a fine-tuning job that train, and an AZR
job that self-plays with a local vocabulary."""

import inspect
import json
import sys
import types
from unittest import mock

import pytest
import torch

from apertis_llm_torch import cli
from apertis_llm_torch.inference.interface import ApertisInterface
from apertis_llm_torch.inference.ui import TrainingJob, UIBackend, launch_ui

torch.set_num_threads(2)


class _Component:
    def __init__(self, *args, **kwargs):
        self.kwargs = kwargs
        STUB.components.append(self)

    def _bind(self, fn, inputs=None, outputs=None):
        inputs = [] if inputs is None else inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = ([] if outputs is None else outputs if isinstance(outputs, (list, tuple))
                   else [outputs])
        STUB.bindings.append((fn, list(inputs), list(outputs)))

    click = submit = _bind

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def launch(self, **kwargs):
        STUB.launched.append(kwargs)


STUB = types.ModuleType("gradio")
for _name in ("Blocks", "Tabs", "TabItem", "Row", "Accordion", "Column", "Markdown", "Chatbot",
              "Textbox", "Button", "Image", "Slider", "Number", "Checkbox", "Dropdown"):
    setattr(STUB, _name, type(_name, (_Component,), {}))


@pytest.fixture()
def stub_gradio(monkeypatch):
    STUB.components, STUB.bindings, STUB.launched = [], [], []
    monkeypatch.setitem(sys.modules, "gradio", STUB)
    return STUB


def test_wiring_with_gradio_stubbed(stub_gradio):
    """Five tabs, a launch, and every binding's handler takes as many
    positional arguments as it is given input components."""
    interface = mock.Mock()
    interface.chat.return_value = "hi"
    launch_ui(interface, port=7860)
    assert sum(type(c).__name__ == "TabItem" for c in stub_gradio.components) == 5
    assert stub_gradio.launched and stub_gradio.launched[0]["server_port"] == 7860
    assert len(stub_gradio.bindings) >= 10
    for fn, inputs, outputs in stub_gradio.bindings:
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        assert len(params) == len(inputs), getattr(fn, "__name__", fn)
    chat = next(fn for fn, _, _ in stub_gradio.bindings if getattr(fn, "__name__", "") == "chat")
    assert chat("hello", None, 10, 0.7, 50, 0.9, []) == ([("hello", "hi")], "")


def _vocab(path):
    path.write_text(json.dumps({"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3,
                                **{f"w{i}": i for i in range(4, 64)}}))
    return path


def _wait(job):
    job.thread.join(timeout=600)
    assert not job.running()
    return job.status()


def test_backend_on_a_cpu_interface(tmp_path):
    """Chat, the models tab and three jobs on a real interface: the jobs
    train on the interface's device."""
    base = tmp_path / "base"
    cli.main(["create-model", "--target-params", "1M", "--vocab-size", "64", "--attention-type",
              "selective_ssm", "--output-dir", str(base), "--device", "cpu"])
    iface = ApertisInterface(model_path=str(base), device="cpu")
    backend = UIBackend(iface)
    history, cleared = backend.chat("hello", None, 4, 0.0, 50, 1.0, [])
    assert len(history) == 1 and history[0][0] == "hello" and cleared == ""
    assert backend.chat("   ", None, 4, 0.0, 50, 1.0, history) == (history, "")
    assert backend.clear_chat() == ([], "", None) and iface.chat_history == []

    assert backend.load_model("", "") == "Provide a model path."
    info = backend.load_model(str(base), "")
    assert info.startswith(f"Loaded: {base}") and "selective_ssm" in info
    made = backend.create_model("1M", 64, False, False, 8, 2, "selective_ssm", False,
                                str(tmp_path / "made"))
    assert made.startswith("Model created in") and (tmp_path / "made" / "model.pt").exists()

    vocab = _vocab(tmp_path / "vocab.json")
    rows = [" ".join(f"w{4 + (i * 3 + j) % 60}" for j in range(8)) for i in range(8)]
    (tmp_path / "pre.jsonl").write_text("".join(json.dumps({"text": r}) + "\n" for r in rows))
    (tmp_path / "sft.jsonl").write_text("".join(
        json.dumps({"instruction": r, "output": r[::-1]}) + "\n" for r in rows))
    msg = backend.start_finetuning(str(base), str(tmp_path / "sft.jsonl"), "", False, str(vocab),
                                   "", 16, str(tmp_path / "ft"), 4, 1e-3, 1, 1, False)
    assert msg.startswith("Fine-tuning launched")
    status = _wait(backend.finetune_job)
    assert "Fine-tuning finished" in status and '"final_step": 2' in status
    cfg = json.loads(open(msg.split("config: ")[1].rstrip(").")).read())
    assert cfg["training_config"]["device"] == "cpu"
    msg = backend.start_pretraining(str(tmp_path / "pre.jsonl"), "", str(vocab), "1M",
                                    "selective_ssm", False, False, 8, 2, False, "", 16,
                                    str(tmp_path / "pt"), 4, 1e-3, 1, 1, False)
    assert msg.startswith("Pre-training launched")
    assert "Pre-training finished" in _wait(backend.pretrain_job)
    assert backend.start_azr("", 64, 1, 1, 128, "standard_mha", 1, 1, 1, "").startswith(
        "Provide a local tokenizer")
    msg = backend.start_azr(str(vocab), 64, 1, 1, 128, "standard_mha", 1, 1, 1,
                            str(tmp_path / "azr"))
    assert msg.startswith("AZR training launched")
    status = _wait(backend.azr_job)
    assert "AZR training finished" in status and '"tasks_generated": 1' in status
    cfg = json.loads(open(msg.split("config: ")[1].rstrip(").")).read())
    assert cfg["training"]["device"] == "cpu" and cfg["data"]["tokenizer_name"] == str(vocab)
    assert (tmp_path / "azr" / "azr_checkpoints" / "model_iter_1" / "pytorch_model.bin").exists()
    assert backend.pretrain_job.stop() == "No Pre-training job is running."


def test_training_job_stop_and_status():
    job = TrainingJob("Demo")

    def run(stop):
        stop.wait(timeout=30)
        return {"stopped": stop.is_set()}

    job.start(run, job.stop_event)
    assert job.running() and job.stop().startswith("Stop requested")
    job.thread.join(timeout=30)
    assert "Demo stopped by user." in job.status()
