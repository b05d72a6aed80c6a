"""Absolute Zero Reasoner self-play pipeline (``apertis_llm_tpu/training/
azr_pipeline.py``).

Per iteration the trainer PROPOSES ``tasks_per_iteration`` tasks (generate
-> validate -> reward), then SOLVES each valid task (generate -> validate ->
reward), with the force-accept warm-up (tasks while iteration <= threshold,
solutions while the valid-task count <= min), the tracker's records, and a
checkpoint every N iterations and at the end. As in the JAX package the loop
takes no optimizer step unless ``azr.enable_sft_updates`` installs the
built-in SFT update as ``update_hook``; the reference never updates weights
(SURVEY.md §3.4).

Config schema: ``{"data": {...}, "model": {...}, "training": {...},
"azr": {...}}``, dispatched on ``training.method == "azr"``. Where the port
differs from the JAX trainer:

  * **Device.** ``training.device`` (default ``"cuda"``) holds the model,
    the engine and the SFT update; the tests pass ``"cpu"``.
  * **Tokenizer.** ``data.tokenizer_name`` must be local (:func:`load_tokenizer`):
    a ``vocab.json`` (the whitespace tokenizer of ``utils/vocab.py``), or a
    tokenizer directory that ``transformers`` loads where it is installed.
    Anything else, the JAX default ``"gpt2"`` included, raises
    ``ValueError`` before a model is built: the JAX trainer downloads it.
  * **Model.** From ``training.pretrained_model_path`` (the checkpoint's
    weights under this config, as JAX keeps its own config) or from
    ``init_params`` with a generator seeded by ``training.seed``; served by
    ``InferenceEngine(config, model, dtype=training.dtype)``, which casts the
    model in place.
  * **Sampling.** One ``torch.Generator`` on the device, seeded once by
    ``training.seed``, draws every sampled token, so a run repeats.
  * **SFT update.** ``training/step.py``'s AdamW and ``train_step`` train
    the engine's own parameters in place, in the dtype the engine holds
    them (f32 unless ``training.dtype`` casts them), so the next
    generation samples from the updated weights.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.training.azr import (
    PythonExecutor, RewardCalculator, SelfPlayTracker, SolutionGenerator,
    SolutionValidator, TaskGenerator, TaskValidator, default_reward_modules)
from apertis_llm_torch.training.azr.executor import setup_logging as azr_setup_logging
from apertis_llm_torch.utils.vocab import (
    ManualTokenizer, load_vocabulary, try_load_hf_tokenizer, vocab_size_from_mapping)

logger = logging.getLogger(__name__)


class VocabTokenizer:
    """The part of a Hugging Face tokenizer's interface that the trainer
    calls, over a ``vocab.json`` and ``utils/vocab.py::ManualTokenizer``
    (whitespace words): ``tok(text, truncation=True, max_length=n)
    ["input_ids"]``, ``decode(ids, skip_special_tokens=True)`` (the pad, bos
    and eos ids skipped), ``vocab_size`` (the largest id + 1), the
    ``<pad>``, ``<bos>``, ``<eos>`` and ``<unk>`` ids (None where the
    vocabulary lacks one), and ``save_pretrained(directory)``, which copies
    the vocabulary there."""

    def __init__(self, vocab_file: str | os.PathLike):
        self.vocab_file = Path(vocab_file)
        vocab = load_vocabulary(self.vocab_file)
        self._tok = ManualTokenizer(vocab)
        self.vocab_size = vocab_size_from_mapping(vocab)
        self.pad_token_id = vocab.get("<pad>")
        self.bos_token_id = vocab.get("<bos>")
        self.eos_token_id = vocab.get("<eos>")
        self.unk_token_id = vocab.get("<unk>")

    def __call__(self, text: str, truncation: bool = False,
                 max_length: Optional[int] = None) -> Dict[str, List[int]]:
        ids = self._tok.encode(text)
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        skip = tuple(i for i in (self.pad_token_id, self.bos_token_id, self.eos_token_id)
                     if i is not None) if skip_special_tokens else ()
        return self._tok.decode(ids, skip_ids=skip)

    def save_pretrained(self, directory: str | os.PathLike) -> None:
        os.makedirs(directory, exist_ok=True)
        shutil.copyfile(self.vocab_file, Path(directory) / "vocab.json")


def load_tokenizer(name: str):
    """The tokenizer of ``data.tokenizer_name``, from local files only: a
    ``.json`` file is a vocabulary (:class:`VocabTokenizer`); a directory is
    loaded by ``transformers`` where it is installed and holds a tokenizer
    it reads, else through its ``vocab.json`` (as the trainer's checkpoints
    save it). Anything else raises ``ValueError``: a name such as
    ``"gpt2"`` would be a download."""
    path = Path(name)
    if path.is_file() and path.suffix == ".json":
        return VocabTokenizer(path)
    if path.is_dir():
        # A directory only: for any other name try_load_hf_tokenizer asks
        # the hub.
        tok = try_load_hf_tokenizer(str(path))
        if tok is not None:
            return tok
        if (path / "vocab.json").is_file():
            return VocabTokenizer(path / "vocab.json")
    raise ValueError(
        f"data.tokenizer_name {name!r} is not a local vocab.json or tokenizer directory: "
        "the PyTorch port loads its tokenizer from local files only (for example a "
        "vocab.json written by utils/vocab.py::create_minimal_vocab_file)")


class AbsoluteZeroReasonerTrainer:
    def __init__(self, config_path: str,
                 stop_event: Optional[threading.Event] = None):
        with open(config_path, "r", encoding="utf-8") as f:
            self.config_data = json.load(f)
        self.azr_config = self.config_data.get("azr", {})
        self.model_config_dict = self.config_data.get("model", {})
        self.data_config = self.config_data.get("data", {})
        self.training_config = self.config_data.get("training", {})
        self.output_dir = self.training_config.get("output_dir", "output")
        self.device = torch.device(self.training_config.get("device", "cuda"))

        self._setup_logging()
        self.config, self.engine, self.tokenizer = self._setup_model_and_tokenizer()
        self.generator = torch.Generator(device=self.engine.model.device).manual_seed(
            self.training_config.get("seed", 0))
        self._init_components()
        self.stop_event = stop_event or threading.Event()
        # Extension point: called as update_hook(tracker) after each iteration
        # to implement a real policy update over the scored self-play data.
        # The reference never updates weights (SURVEY.md §3.4); setting
        # azr.enable_sft_updates installs the built-in SFT update below.
        self.update_hook: Optional[Callable[[SelfPlayTracker], None]] = None
        if self.azr_config.get("enable_sft_updates", False):
            self._init_sft_updater()
        logger.info("Initialized all AZR components")

    def _setup_logging(self) -> None:
        log_file = self.azr_config.get("log_file")
        if log_file:
            os.makedirs(self.output_dir, exist_ok=True)
            log_file = os.path.join(self.output_dir, log_file)
        azr_setup_logging(self.azr_config.get("log_level", "INFO"), log_file)

    def _setup_model_and_tokenizer(self):
        from apertis_llm_torch.inference.engine import InferenceEngine
        from apertis_llm_torch.models.convert import from_jax_params, read_pretrained
        from apertis_llm_torch.models.params import init_params

        tokenizer_name = self.data_config.get("tokenizer_name", "gpt2")
        tokenizer = load_tokenizer(tokenizer_name)
        logger.info("Loaded tokenizer for AZR: %s", tokenizer_name)

        cfg = dict(self.model_config_dict)
        cfg["vocab_size"] = tokenizer.vocab_size
        for attr in ("pad_token_id", "bos_token_id", "eos_token_id",
                     "unk_token_id"):
            val = getattr(tokenizer, attr, None)
            if val is not None:
                cfg[attr] = val
        config = ApertisConfig.from_dict(cfg)

        base_path = self.training_config.get("pretrained_model_path")
        if base_path:
            _, tree = read_pretrained(base_path)
        else:
            gen = torch.Generator(device=self.device).manual_seed(
                self.training_config.get("seed", 0))
            tree = init_params(config, gen, device=self.device)
        model = from_jax_params(tree, config, device=self.device)
        del tree
        engine = InferenceEngine(config, model, dtype=self.training_config.get("dtype"))
        return config, engine, tokenizer

    def _init_components(self) -> None:
        self.python_executor = PythonExecutor(
            self.azr_config.get("python_executor", {}))
        self.task_generator = TaskGenerator(
            self.azr_config.get("task_generator", {}))
        self.task_validator = TaskValidator(
            self.azr_config.get("task_validator", {}), self.python_executor)
        self.solution_generator = SolutionGenerator(
            self.azr_config.get("solution_generator", {}))
        self.solution_validator = SolutionValidator(
            self.azr_config.get("solution_validator", {}), self.python_executor)
        reward_configs = self.azr_config.get("rewards", {})
        self.reward_calculator = RewardCalculator(
            reward_configs, default_reward_modules(reward_configs))
        self.tracker = SelfPlayTracker(
            self.azr_config, os.path.join(self.output_dir, "azr_data"))

    # -- model text generation -----------------------------------------
    def _generate_text(self, prompt: str, max_new_tokens: int = 512,
                       temperature: float = 0.7, top_p: float = 0.9) -> str:
        max_prompt = self.config.max_position_embeddings // 2
        ids = self.tokenizer(prompt, truncation=True,
                             max_length=max_prompt)["input_ids"]
        input_ids = np.asarray([ids], np.int32)
        out = self.engine.generate(
            input_ids,
            generator=self.generator,
            max_new_tokens=max_new_tokens,
            do_sample=True,
            temperature=temperature,
            top_p=top_p,
            eos_token_id=(self.tokenizer.eos_token_id
                          if self.tokenizer.eos_token_id is not None
                          else self.config.eos_token_id),
            pad_token_id=(self.tokenizer.pad_token_id
                          if self.tokenizer.pad_token_id is not None else 0),
        )
        new_ids = out[0, input_ids.shape[1]:].tolist()
        return self.tokenizer.decode(new_ids, skip_special_tokens=True)

    # -- built-in self-play SFT update ---------------------------------
    def _init_sft_updater(self) -> None:
        """Install an update_hook that fine-tunes the policy on the valid
        (task, solution) pairs collected so far — reward-weighted SFT.

        The optimizer trains the engine's model in place. Training takes a
        float tree only (``check_trainable``), and a float model's engine
        holds no derived copy of a weight that could go stale (the int8 tied
        head, the fused QKV and the int4 pack are int8 only; a MoE layer
        rebuilds its fat stack when an expert tensor's version changes), so
        the next ``generate`` serves exactly the updated weights."""
        from apertis_llm_torch.models.params import check_trainable
        from apertis_llm_torch.training.step import decay_mask, make_optimizer

        model = self.engine.model
        check_trainable(self.config, model.quantized, model.device)
        sft_cfg = self.azr_config.get("sft", {})
        self._sft_max_len = sft_cfg.get("max_length", 256)
        self._sft_batch = sft_cfg.get("batch_size", 4)
        self._sft_steps = sft_cfg.get("steps_per_iteration", 4)
        self._sft_min_reward = sft_cfg.get("min_total_reward", 0.0)
        self._sft_optimizer, _ = make_optimizer(
            dict(model.named_parameters()), decay_mask(model),
            sft_cfg.get("learning_rate", 1e-5),
            total_steps=self.azr_config.get("num_iterations", 100) * self._sft_steps,
            gradient_accumulation_steps=1)
        dtype = self.training_config.get("dtype")
        self._sft_dtype = getattr(torch, dtype) if dtype else None
        self._sft_seed = self.training_config.get("seed", 0)
        self._sft_micro = 0
        self._sft_consumed = 0
        self.sft_losses: List[float] = []
        self.update_hook = self._sft_update

    def _sft_update(self, tracker: SelfPlayTracker) -> None:
        from apertis_llm_torch.models.apertis import fold_seed
        from apertis_llm_torch.training.step import train_step

        records = tracker.solution_history[self._sft_consumed:]
        self._sft_consumed = len(tracker.solution_history)
        pairs = [
            (r["task"].get("task", ""), r["solution"].get("solution", ""),
             r["rewards"].get("total", 0.0))
            for r in records
            if r["validation"].get("is_valid", False)
            and r["rewards"].get("total", 0.0) >= self._sft_min_reward
        ]
        if not pairs:
            return
        tok, pad = self.tokenizer, (self.tokenizer.pad_token_id or 0)
        rows, labels_rows = [], []
        for task, solution, _reward in pairs:
            prompt_ids = tok(f"### Problem ###\n{task}\n\n### Solution ###",
                             truncation=True,
                             max_length=self._sft_max_len // 2)["input_ids"]
            sol_ids = tok("\n" + solution, truncation=True,
                          max_length=self._sft_max_len // 2)["input_ids"]
            ids = (prompt_ids + sol_ids)[: self._sft_max_len]
            lab = ([-100] * len(prompt_ids) + sol_ids)[: self._sft_max_len]
            n_pad = self._sft_max_len - len(ids)
            rows.append(ids + [pad] * n_pad)
            labels_rows.append(lab + [-100] * n_pad)
        ids = np.asarray(rows, np.int32)
        labels = np.asarray(labels_rows, np.int32)
        mask = (ids != pad).astype(np.int32)

        n = ids.shape[0]
        reps = -(-self._sft_batch // n)
        ids = np.tile(ids, (reps, 1))[: self._sft_batch]
        labels = np.tile(labels, (reps, 1))[: self._sft_batch]
        mask = np.tile(mask, (reps, 1))[: self._sft_batch]
        device = self.engine.model.device
        batch = {"input_ids": torch.as_tensor(ids, dtype=torch.int64, device=device),
                 "attention_mask": torch.as_tensor(mask, dtype=torch.int32, device=device),
                 "labels": torch.as_tensor(labels, dtype=torch.int64, device=device)}
        loss = None
        for _ in range(self._sft_steps):
            metrics = train_step(self.engine.model, self._sft_optimizer, batch,
                                 fold_seed(self._sft_seed, self._sft_micro), self._sft_dtype)
            self._sft_micro += 1
            loss = float(metrics["loss"])
            self.sft_losses.append(loss)
        # The policy the generators sample from IS the updated one: the
        # optimizer changed the engine's parameters in place.
        logger.info("AZR SFT update on %d pairs: loss=%.4f", len(pairs), loss)

    # -- main loop ------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        logger.info("Starting Absolute Zero Reasoner self-play loop")
        num_iterations = self.azr_config.get("num_iterations", 100)
        tasks_per_iteration = self.azr_config.get("tasks_per_iteration", 5)
        checkpoint_interval = self.azr_config.get("checkpoint_interval", 10)
        force_tasks = self.azr_config.get("force_accept_tasks", True)
        force_solutions = self.azr_config.get("force_accept_solutions", True)
        force_threshold = self.azr_config.get("force_accept_threshold", 10)
        min_valid_for_val = self.azr_config.get(
            "min_valid_tasks_before_validation", 20)

        start = self.tracker.get_metrics()["iterations"] + 1
        for iteration in range(start, start + num_iterations):
            if self.stop_event.is_set():
                logger.info("Stop event received at iteration %d.", iteration)
                break
            logger.info("AZR iteration %d/%d", iteration,
                        start + num_iterations - 1)
            metrics = self.tracker.get_metrics()
            should_force_tasks = force_tasks and iteration <= force_threshold
            should_force_solutions = (force_solutions
                                      and metrics["tasks_valid"] <= min_valid_for_val)

            valid_tasks = []
            attempted = valid_count = 0
            for _ in range(tasks_per_iteration):
                if self.stop_event.is_set():
                    break
                task_info = self.task_generator.generate_task(self._generate_text)
                attempted += 1
                validation = self.task_validator.validate(task_info)
                if should_force_tasks and not validation.get("is_valid", False):
                    validation["is_valid"] = True
                    validation["reason"] = "Forced accept"
                if validation["is_valid"]:
                    valid_count += 1
                    rewards = self.reward_calculator.calculate_task_rewards(
                        task_info, validation, valid_tasks)
                    self.tracker.update_task_metrics(task_info, validation, rewards)
                    valid_tasks.append(task_info)
                else:
                    self.tracker.update_task_metrics(task_info, validation,
                                                     {"total": 0})
            if self.stop_event.is_set():
                break
            task_rate = valid_count / attempted if attempted else 0

            sol_attempted = sol_valid = 0
            for task_info in valid_tasks:
                if self.stop_event.is_set():
                    break
                solution = self.solution_generator.generate_solution(
                    task_info, self._generate_text)
                sol_attempted += 1
                validation = self.solution_validator.validate(task_info, solution)
                if should_force_solutions and not validation.get("is_valid", False):
                    validation["is_valid"] = True
                    validation["reason"] = "Forced accept"
                if validation["is_valid"]:
                    sol_valid += 1
                    rewards = self.reward_calculator.calculate_solution_rewards(
                        validation)
                    self.tracker.update_solution_metrics(
                        task_info, solution, validation, rewards)
                else:
                    self.tracker.update_solution_metrics(
                        task_info, solution, validation, {"total": 0})
            if self.stop_event.is_set():
                break
            sol_rate = sol_valid / sol_attempted if sol_attempted else 0
            self.tracker.record_iteration_stats(task_rate, sol_rate)

            summary = self.tracker.get_summary_metrics()
            logger.info("Iteration %d: task rate=%.2f, solution rate=%.2f",
                        iteration, summary["task_valid_rate"],
                        summary["solution_valid_rate"])

            if self.update_hook is not None:
                self.update_hook(self.tracker)

            if iteration % checkpoint_interval == 0 and not self.stop_event.is_set():
                self._save_checkpoint(iteration)

        if not self.stop_event.is_set():
            self._save_checkpoint(self.tracker.get_metrics()["iterations"])
        logger.info("AZR training process finished.")
        return self.tracker.get_summary_metrics()

    def checkpoint_dir(self, iteration: int) -> str:
        """Where :meth:`_save_checkpoint` writes iteration ``iteration``."""
        return os.path.join(
            self.output_dir,
            self.azr_config.get("checkpoint_dir", "azr_checkpoints"),
            f"model_iter_{iteration}")

    def _save_checkpoint(self, iteration: int) -> None:
        from apertis_llm_torch.models.convert import params_tree, save_torch_checkpoint

        ckpt_dir = self.checkpoint_dir(iteration)
        try:
            save_torch_checkpoint(params_tree(self.engine.model), self.config, ckpt_dir)
            self.tokenizer.save_pretrained(ckpt_dir)
            logger.info("AZR saved model + tokenizer to %s", ckpt_dir)
        except Exception as e:
            logger.error("AZR checkpoint error: %s", e, exc_info=True)


def train_from_config(config_path: str,
                      stop_event: Optional[threading.Event] = None):
    trainer = AbsoluteZeroReasonerTrainer(config_path, stop_event)
    return trainer.train()


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1:
        train_from_config(sys.argv[1])
    else:
        print("Usage: python -m apertis_llm_torch.training.azr_pipeline <config.json>")
