"""The port's AZR self-play pipeline against the JAX package's (CPU, tiny
models: one layer, 64 wide, a local word-level tokenizer).

The components (the heuristics, the seven rewards and the calculator) must
give equal numbers on the same strings; the executor must run, fail, time
out and cap output as JAX's does, with no CUDA device visible to the child.
Both trainers are built on one checkpoint that JAX's
``save_torch_checkpoint`` writes: with one scripted ``_generate_text`` they
must write equal summaries, metrics and records, with force-accept on and
off; their ``_generate_text`` at ``top_p=1e-9`` (one token survives top-p in
both) must give the same text; one SFT update from the same records must
agree to the training tests' tolerances (``tests/test_torch_training.py``:
the loss to a relative 1e-5, each parameter leaf to 1e-4 of its largest JAX
element), after which the trainer's engine serves the updated weights. The
full loop runs through the port's dispatcher on the CPU, and its checkpoint
loads in both packages to the same leaves. A tokenizer that is not local
raises before any model is built.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models.convert import load_pretrained as jax_load_pretrained
from apertis_llm_tpu.models.convert import save_torch_checkpoint as jax_save
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.training import azr as jax_azr
from apertis_llm_tpu.training.azr_pipeline import (
    AbsoluteZeroReasonerTrainer as JaxTrainer)
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import from_jax_params, load_pretrained, params_tree
from apertis_llm_torch.training import azr as port_azr
from apertis_llm_torch.training import train_from_config
from apertis_llm_torch.training.azr_pipeline import (
    AbsoluteZeroReasonerTrainer as PortTrainer, VocabTokenizer, load_tokenizer)
from apertis_llm_torch.utils.vocab import create_minimal_vocab_file

torch.set_num_threads(2)

GRAD_TOL = 1e-4       # a leaf within 1e-4 of its largest element (test_torch_training.py)
LOSS_RTOL = 1e-5

SAMPLE_TASKS = [
    "Consider the sequence: 3, 7, 16, 35, 74. What is the next number and "
    "what is the rule governing the sequence?",
    "All expert systems are intelligent. All intelligent systems use "
    "knowledge. Apertis is an expert system. What can you deduce?",
    "short one",
]

SAMPLE_SOLUTION = (
    "First, we look at the differences between terms. Therefore the rule is "
    "multiply by two and add one.\n1. Start with 3.\n2. Apply the rule.\n"
    "Conclusion: the next number is 153.")

_WORDS = ("the a cat dog sequence number problem reasoning if then what next and why is "
          "rule pattern comes therefore thus because first finally however all some none "
          "every any not or extraordinary consequently").split()


def _seeded_texts(n=4, seed=0):
    """Strings with sentences, numbers, operators, code blocks, numbered and
    bulleted lines, drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n):
        lines = []
        for _ in range(int(rng.integers(1, 6))):
            words = list(rng.choice(_WORDS, int(rng.integers(3, 18))))
            words += [str(x) for x in rng.integers(0, 100, int(rng.integers(0, 3)))]
            words += list(rng.choice(["+", "<=", "==", "*", "?", "!"], int(rng.integers(0, 3))))
            rng.shuffle(words)
            lead = rng.choice(["", "1. ", "2) ", "- ", "* ", "Conclusion: ", "Answer: "])
            lines.append(lead + " ".join(words) + str(rng.choice([".", "?", "!", ""])))
        if rng.random() < 0.5:
            lines.append("```python\nprint(1 + 2)\n```")
        texts.append("\n".join(lines))
    return texts


TEXTS = SAMPLE_TASKS + [SAMPLE_SOLUTION] + _seeded_texts()


def _make_local_tokenizer(tmp_path):
    """A tiny word-level Hugging Face tokenizer on disk (no network), as
    ``tests/test_azr.py`` builds it."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ("the a cat dog sequence number problem reasoning if then what "
             "next and why is rule pattern comes 2 4 6 8 create simple about "
             "numbers for example we have").split()
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3}
    for w in words:
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", bos_token="<bos>",
        eos_token="<eos>", unk_token="<unk>")
    tok_dir = tmp_path / "tok"
    fast.save_pretrained(tok_dir)
    return str(tok_dir)


# -- the components -------------------------------------------------------

@pytest.mark.parametrize("text", TEXTS)
def test_heuristics_equal(text):
    jt, pt = jax_azr.TaskValidator({}), port_azr.TaskValidator({})
    js, ps = jax_azr.SolutionValidator({}), port_azr.SolutionValidator({})
    assert pt.complexity(text) == jt.complexity(text)
    assert pt.clarity(text) == jt.clarity(text)
    assert ps.coherence(text) == js.coherence(text)
    assert ps.structure(text) == js.structure(text)
    for task in SAMPLE_TASKS:
        assert ps.relevance(task, text) == js.relevance(task, text)
    assert (port_azr.construction.extract_code_blocks(text)
            == jax_azr.construction.extract_code_blocks(text))


def _validations(seed=0, n=6):
    rng = np.random.default_rng(seed)
    keys = ("complexity", "clarity", "correctness", "coherence", "relevance", "structure")
    return [dict({k: float(rng.random()) for k in keys}, is_valid=bool(rng.random() < 0.7))
            for _ in range(n)]


@pytest.mark.parametrize("config", [{}, {"weight": 0.5, "target_complexity": 0.4,
                                         "tolerance": 0.3, "partial_credit_power": 2.0,
                                         "ngram_weights": [0.5, 0.3, 0.2]}])
def test_rewards_equal(config):
    names = ("ComplexityReward", "ClarityReward", "AccuracyReward", "CoherenceReward",
             "RelevanceReward", "StructureReward")
    for validation in _validations():
        for name in names:
            got = getattr(port_azr, name)(config).calculate(validation)
            assert got == getattr(jax_azr, name)(config).calculate(validation), name
    history = [{"task": t} for t in TEXTS[:4]]
    for text in TEXTS:
        for prev in ([], history):
            got = port_azr.DiversityReward(config).calculate({"task": text}, prev)
            assert got == jax_azr.DiversityReward(config).calculate({"task": text}, prev)
    reward_cfg = {"clarity": config, "accuracy": config}
    ours = port_azr.RewardCalculator(reward_cfg, port_azr.default_reward_modules(reward_cfg))
    theirs = jax_azr.RewardCalculator(reward_cfg, jax_azr.default_reward_modules(reward_cfg))
    for validation, text in zip(_validations(1), TEXTS):
        assert (ours.calculate_task_rewards({"task": text}, validation, history)
                == theirs.calculate_task_rewards({"task": text}, validation, history))
        assert (ours.calculate_solution_rewards(validation)
                == theirs.calculate_solution_rewards(validation))


CASES = {
    "success": ("print(6 * 7)", True, "42"),
    "error": ("raise ValueError('boom')", False, "boom"),
    "timeout": ("import time; time.sleep(30)", False, "timed out after 1 seconds"),
    "cap": ("print('x' * 5000)", True, "... [output truncated]"),
    "no card": ("import os; print(repr(os.environ.get('CUDA_VISIBLE_DEVICES')))", True,
                "''"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_executor(case):
    code, success, needle = CASES[case]
    config = {"timeout": 1, "max_output_size": 1000}
    got = port_azr.PythonExecutor(config).execute(code)
    assert got["success"] is success
    assert needle in (got["output"] if success else got["error"])
    theirs = jax_azr.PythonExecutor(config).execute(code)
    assert {k: got[k] for k in ("success", "return_code")} == \
        {k: theirs[k] for k in ("success", "return_code")}
    if case != "no card":
        assert got["output"] == theirs["output"]
    if case == "cap":
        assert len(got["output"]) == 1000 + len("\n... [output truncated]")


def test_executor_env_overrides_the_card():
    ex = port_azr.PythonExecutor({"env": {"CUDA_VISIBLE_DEVICES": "0"}})
    got = ex.execute("import os; print(os.environ['CUDA_VISIBLE_DEVICES'])")
    assert got["success"] and got["output"].strip() == "0"


# -- the trainers on one checkpoint ---------------------------------------

MODELS = {
    "ssm": dict(attention_type="selective_ssm", ssm_d_state=8),
    "mha": dict(attention_type="standard_mha"),
}


def _model_config(kind):
    return dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=128, max_position_embeddings=512,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **MODELS[kind])


def _checkpoint(tmp_path, tok_dir, kind, seed=0):
    """JAX's checkpoint of a perturbed random tree under the config the
    trainers build (the model dict with the tokenizer's size and ids)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tok_dir)
    cfg = dict(_model_config(kind), vocab_size=tok.vocab_size, pad_token_id=tok.pad_token_id,
               bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
               unk_token_id=tok.unk_token_id)
    jcfg = JaxConfig.from_dict(cfg)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.05, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    path = tmp_path / f"ckpt-{kind}"
    jax_save(tree, jcfg, path)
    return str(path)


def _write(tmp_path, name, tok_dir, kind, ckpt, azr):
    cfg = {"data": {"tokenizer_name": tok_dir}, "model": _model_config(kind),
           "training": {"method": "azr", "output_dir": str(tmp_path / f"out-{name}"),
                        "seed": 0, "device": "cpu", "pretrained_model_path": ckpt},
           "azr": azr}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _pair(tmp_path, tok_dir, kind, ckpt, azr):
    return (JaxTrainer(_write(tmp_path, "jax", tok_dir, kind, ckpt, azr)),
            PortTrainer(_write(tmp_path, "port", tok_dir, kind, ckpt, azr)))


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    return _make_local_tokenizer(tmp_path_factory.mktemp("azr-tok"))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, tok_dir):
    base = tmp_path_factory.mktemp("azr-ckpt")
    return {kind: _checkpoint(base, tok_dir, kind) for kind in MODELS}


TASK_REPLIES = [
    "Task: Consider the sequence: 3, 7, 16, 35, 74. What is the next number and what is "
    "the rule governing the sequence?",
    "Problem: if all cats are animals and some animals sleep, then what can we say about "
    "cats?\n```python\nprint(sum(range(10)))\n```",
    "short",
    "",
    "Question: ```python\nraise ValueError('no')\n``` Find the pattern in 2 4 6 8 and say "
    "why it holds for every number.",
    "What?",
]
SOLUTION_REPLIES = [
    SAMPLE_SOLUTION,
    "<answer>```python\nprint(6 * 7)\n```\nThe answer follows because the pattern doubles "
    "and we add one each time to reach the next value in this sequence.</answer>",
    "no",
    "```python\nimport sys; sys.exit(3)\n```\n- first we compute the value\n- therefore "
    "the answer is clear and the rule holds for the sequence\nAnswer: 42",
    "",
]


def _scripted():
    """One scripted ``_generate_text``: task prompts and solution prompts
    each cycle through their replies (code blocks that run and fail, valid,
    short and empty texts)."""
    seen = {"task": 0, "solution": 0}

    def generate(prompt, max_new_tokens=512, temperature=0.7, top_p=0.9):
        kind = "solution" if "### Solution ###" in prompt else "task"
        replies = SOLUTION_REPLIES if kind == "solution" else TASK_REPLIES
        seen[kind] += 1
        return replies[(seen[kind] - 1) % len(replies)]

    return generate


def _records(out):
    data = {}
    for path in sorted((out / "azr_data").rglob("*.json")):
        record = json.loads(path.read_text())
        record.pop("timestamp", None)
        data[str(path.relative_to(out))] = record
    return data


@pytest.mark.parametrize("force", [True, False])
def test_loop_parity(tmp_path, tok_dir, ckpts, force):
    azr = {"num_iterations": 2, "tasks_per_iteration": 3, "checkpoint_interval": 5,
           "force_accept_tasks": force, "force_accept_solutions": force,
           "task_generator": {"max_attempts": 2, "seed": 3, "task_types":
                              ["abduction", "deduction", "induction"]},
           "solution_generator": {"max_attempts": 1},
           "python_executor": {"timeout": 5}}
    jt, pt = _pair(tmp_path, tok_dir, "ssm", ckpts["ssm"], azr)
    jt._generate_text, pt._generate_text = _scripted(), _scripted()
    theirs, ours = jt.train(), pt.train()
    theirs.pop("timestamp")
    ours.pop("timestamp")
    assert ours == theirs
    assert ours["tasks_generated"] == 6
    assert _records(tmp_path / "out-port") == _records(tmp_path / "out-jax")
    assert (tmp_path / "out-port" / "azr_checkpoints" / "model_iter_2" / "pytorch_model.bin"
            ).exists()


PROMPTS = ["what is the next number in the sequence 2 4 6 8 and why",
           "### Problem ###\nthe cat and the dog create a pattern\n\n### Solution ###"]


def _recording(engine, out):
    generate = engine.generate

    def recorded(*args, **kwargs):
        ids = generate(*args, **kwargs)
        out.append(np.asarray(ids))
        return ids

    engine.generate = recorded


@pytest.mark.parametrize("kind", list(MODELS))
def test_generate_text_parity(tmp_path, tok_dir, ckpts, kind):
    """Both trainers' text, and the ids behind it, at top_p=1e-9 (the
    argmax survives top-p in both packages; the sampling draws differ)."""
    jt, pt = _pair(tmp_path, tok_dir, kind, ckpts[kind], {})
    theirs_ids, ours_ids = [], []
    _recording(jt.engine, theirs_ids)
    _recording(pt.engine, ours_ids)
    texts = []
    for prompt in PROMPTS:
        theirs = jt._generate_text(prompt, max_new_tokens=8, top_p=1e-9)
        ours = pt._generate_text(prompt, max_new_tokens=8, top_p=1e-9)
        assert ours == theirs
        texts.append(ours)
    for a, b in zip(ours_ids, theirs_ids):
        np.testing.assert_array_equal(a, b)
    assert len(ours_ids) == len(PROMPTS) and any(t.strip() for t in texts)


def _sft_records():
    pairs = [(SAMPLE_TASKS[0], SAMPLE_SOLUTION, True, 1.2),
             (SAMPLE_TASKS[1], "the rule is that every cat is a dog and so on", True, 0.7),
             (SAMPLE_TASKS[2], "not used: invalid", False, 3.0),
             ("what comes next in 2 4 6 8", "8 comes next because the rule adds 2", True, 0.4)]
    return [{"task": {"task": t}, "solution": {"solution": s},
             "validation": {"is_valid": valid}, "rewards": {"total": total}}
            for t, s, valid, total in pairs]


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float32)


@pytest.mark.parametrize("kind", list(MODELS))
def test_sft_update_parity(tmp_path, tok_dir, ckpts, kind):
    azr = {"num_iterations": 2, "enable_sft_updates": True,
           "sft": {"steps_per_iteration": 2, "batch_size": 5, "max_length": 32,
                   "learning_rate": 1e-3}}
    jt, pt = _pair(tmp_path, tok_dir, kind, ckpts[kind], azr)
    losses, step = [], jt._sft_step_fn

    def jax_step(state, batch):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics

    jt._sft_step_fn = jax_step
    for trainer in (jt, pt):
        trainer.tracker.solution_history.extend(_sft_records())
        trainer._sft_update(trainer.tracker)
    assert len(pt.sft_losses) == len(losses) == 2
    np.testing.assert_allclose(pt.sft_losses, losses, rtol=LOSS_RTOL)
    theirs = dict(_leaves(jt.engine.params))
    ours = dict(_leaves({k: v for k, v in params_tree(pt.engine.model).items()}))
    before = dict(_leaves(params_tree(load_pretrained(ckpts[kind], device="cpu"))))
    assert set(ours) <= set(theirs)
    moved = 0
    for name, got in ours.items():
        ref = theirs[name]
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got - ref).max()) <= GRAD_TOL * scale, name
        moved += not np.array_equal(got, before[name])
    assert moved > len(ours) // 2

    # The trainer's engine serves the updated weights.
    model = pt.engine.model
    fresh = InferenceEngine(pt.config, from_jax_params(params_tree(model), pt.config,
                                                       device="cpu"))
    ids = np.asarray([[1, 5, 9, 17, 4, 22, 8]], np.int64)
    served = pt.engine.generate(ids, max_new_tokens=12, do_sample=False)
    np.testing.assert_array_equal(served, fresh.generate(ids, max_new_tokens=12,
                                                         do_sample=False))
    # ... and another engine on the weights before the update would not.
    old = InferenceEngine(pt.config, load_pretrained(ckpts[kind], device="cpu"))
    with torch.no_grad():
        logits_new = model(torch.as_tensor(served))
        logits_old = old.model(torch.as_tensor(served))
    assert not torch.equal(logits_new, logits_old)


def test_full_loop_through_the_dispatcher(tmp_path, tok_dir):
    """The port's dispatcher runs self-play with real sampling and SFT on the
    CPU; the checkpoint loads in both packages to the same leaves, and a
    second run from the same seed writes the same records."""
    cfg = {"data": {"tokenizer_name": tok_dir}, "model": _model_config("ssm"),
           "training": {"method": "azr", "seed": 0, "device": "cpu"},
           "azr": {"num_iterations": 2, "tasks_per_iteration": 2, "checkpoint_interval": 2,
                   "enable_sft_updates": True,
                   "sft": {"steps_per_iteration": 2, "batch_size": 4, "max_length": 32,
                           "learning_rate": 1e-3},
                   "task_generator": {"max_new_tokens": 12, "max_attempts": 1, "seed": 0},
                   "solution_generator": {"max_new_tokens": 12, "max_attempts": 1}}}
    records = []
    for run in ("a", "b"):
        cfg["training"]["output_dir"] = str(tmp_path / run)
        path = tmp_path / f"{run}.json"
        path.write_text(json.dumps(cfg))
        summary = train_from_config(str(path))
        assert summary["iterations"] == 2 and summary["tasks_generated"] == 4
        records.append(_records(tmp_path / run))
    assert records[0] == records[1]
    ckpt = tmp_path / "a" / "azr_checkpoints" / "model_iter_2"
    assert {"config.json", "pytorch_model.bin", "tokenizer.json"} <= set(os.listdir(ckpt))
    ours = dict(_leaves(params_tree(load_pretrained(ckpt, device="cpu"))))
    _, jax_tree = jax_load_pretrained(str(ckpt))
    theirs = dict(_leaves(jax_tree))
    assert set(ours) == set(theirs)
    for name, value in ours.items():
        np.testing.assert_array_equal(value, theirs[name], err_msg=name)


def test_local_tokenizers_only(tmp_path, monkeypatch):
    vocab = tmp_path / "vocab.json"
    create_minimal_vocab_file(vocab, size=40)
    tok = load_tokenizer(str(vocab))
    assert isinstance(tok, VocabTokenizer) and tok.vocab_size == 40
    assert (tok.pad_token_id, tok.bos_token_id, tok.eos_token_id, tok.unk_token_id) == \
        (0, 1, 2, 3)
    assert tok("<bos> <tok5> word <tok9> <tok7>", truncation=True,
               max_length=4)["input_ids"] == [1, 5, 3, 9]
    assert tok.decode([1, 5, 2, 3, 0], skip_special_tokens=True) == "<tok5> <unk>"
    tok.save_pretrained(tmp_path / "saved")
    assert isinstance(load_tokenizer(str(tmp_path / "saved")), VocabTokenizer)

    def no_model(*args, **kwargs):
        raise AssertionError("a model was built before the tokenizer was refused")

    monkeypatch.setattr("apertis_llm_torch.models.params.init_params", no_model)
    monkeypatch.setattr("apertis_llm_torch.models.convert.from_jax_params", no_model)
    monkeypatch.setattr("apertis_llm_torch.models.convert.read_pretrained", no_model)
    for name in ("gpt2", str(tmp_path / "missing" / "vocab.json"), str(tmp_path / "empty")):
        (tmp_path / "empty").mkdir(exist_ok=True)
        path = _write(tmp_path, "refused", name, "ssm", None, {})
        with pytest.raises(ValueError, match="local"):
            PortTrainer(path)
    monkeypatch.undo()

    trainer = PortTrainer(_write(tmp_path, "local", str(vocab), "ssm", None,
                                 {"task_generator": {"seed": 0}}))
    assert trainer.config.vocab_size == 40 and trainer.engine.model.device.type == "cpu"
    text = trainer._generate_text("<tok4> <tok5> <tok6>", max_new_tokens=6)
    assert isinstance(text, str) and len(text.split()) <= 6
