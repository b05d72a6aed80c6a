"""Training orchestration: config file -> tokenizer -> model -> trainer
(``apertis_llm_tpu/training/pipeline.py``).

The same JSON schema as the JAX package and the reference (reference:
src/training/pipeline.py:709-991): ``{"data_config", "model_config",
"training_config"}`` with ``training_config.task_type`` in {pretrain,
finetune}, the same tokenizer resolution, special-token forcing into the
model config and dataset wiring. ``training_config.device`` (the port's own
key) names the device, the card by default. ``training_config.mesh_shape``
(data, model, expert, seq) lays the ranks out as the JAX trainer's mesh;
under torchrun ``train_from_config`` starts the process group first
(``parallel/mesh.py::initialize_distributed``). Fine-tuning from a base model
(``pretrained_model_path_for_finetune``) raises ``NotImplementedError`` until
its loading half is ported (ROADMAP.md, module 6).
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from apertis_llm_torch.models.factory import build_model_config
from apertis_llm_torch.models.params import init_params
from apertis_llm_torch.parallel.mesh import initialize_distributed
from apertis_llm_torch.training.datasets import ApertisFineTuneDataset, ApertisPretrainDataset
from apertis_llm_torch.training.trainer import ApertisTrainer
from apertis_llm_torch.utils.vocab import load_vocabulary, vocab_size_from_mapping

logger = logging.getLogger(__name__)


def _resolve_tokenizer(data_cfg: Dict, is_fine_tuning: bool):
    """Returns (hf_tokenizer|None, manual_vocab|None, vocab_size,
    special_ids dict, tokenizer_path)."""
    tokenizer_path = data_cfg.get("tokenizer_path")
    # `use_hf_tokenizer` works for both pre-training and fine-tuning (the
    # reference pretrain path is whitespace-only, pipeline.py:118-143); the
    # reference's finetune-only key is still honoured.
    use_hf = (data_cfg.get("use_hf_tokenizer", False)
              or (is_fine_tuning
                  and data_cfg.get("use_hf_tokenizer_for_finetune", False)))
    ids = {"pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2,
           "unk_token_id": 3}

    if use_hf:
        if not tokenizer_path:
            raise ValueError("HF tokenization requires data_config.tokenizer_path")
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(tokenizer_path)
        for attr in ids:
            val = getattr(tok, attr, None)
            if val is not None:
                ids[attr] = val
        return tok, None, len(tok), ids, tokenizer_path

    if not tokenizer_path:
        raise ValueError("data_config.tokenizer_path is required")
    vocab = load_vocabulary(tokenizer_path)
    size = vocab_size_from_mapping(vocab)
    for name, key in (("<pad>", "pad_token_id"), ("<bos>", "bos_token_id"),
                      ("<eos>", "eos_token_id"), ("<unk>", "unk_token_id")):
        if name in vocab:
            ids[key] = vocab[name]
    return None, vocab, size, ids, tokenizer_path


def train_from_config(config_path: str,
                      stop_event: Optional[threading.Event] = None
                      ) -> Optional[Dict[str, Any]]:
    initialize_distributed()
    with open(config_path, "r", encoding="utf-8") as f:
        config_data = json.load(f)

    data_cfg = config_data.get("data_config", {})
    model_cfg = config_data.get("model_config", {})
    train_cfg = config_data.get("training_config", {})
    is_fine_tuning = train_cfg.get("task_type", "pretrain") == "finetune"
    device = train_cfg.get("device", "cuda")

    hf_tok, manual_vocab, vocab_size, special_ids, tokenizer_path = \
        _resolve_tokenizer(data_cfg, is_fine_tuning)

    # --- model ---------------------------------------------------------
    if is_fine_tuning and train_cfg.get("pretrained_model_path_for_finetune"):
        raise NotImplementedError(
            "fine-tuning from a base model (load_pretrained, embedding resize) is not "
            "ported to PyTorch yet (see ROADMAP.md)")
    overrides = dict(model_cfg.get("config_overrides", {}))
    overrides.update(special_ids)
    config = build_model_config(
        target_param_count=model_cfg.get("target_param_count", "125M"),
        vocab_size_override=vocab_size,
        attention_type_override=model_cfg.get("attention_type"),
        multimodal=model_cfg.get("multimodal", False),
        use_expert_system=model_cfg.get("use_expert_system", False),
        num_experts_target_override=model_cfg.get("num_experts"),
        experts_per_token_target_override=model_cfg.get("experts_per_token"),
        use_flash_attention=model_cfg.get("use_flash_attention", False),
        ssm_d_inner=model_cfg.get("ssm_d_inner"),
        ssm_d_state=model_cfg.get("ssm_d_state", 16),
        ssm_dt_rank=model_cfg.get("ssm_dt_rank", "auto"),
        ssm_conv_kernel=model_cfg.get("ssm_conv_kernel", 4),
        config_overrides=overrides,
    )
    gen = torch.Generator(device=device).manual_seed(train_cfg.get("seed", 0))
    params = init_params(config, gen, device=device)

    # --- datasets ------------------------------------------------------
    max_length = data_cfg.get("max_length", 512)
    if is_fine_tuning:
        common = dict(
            tokenizer=hf_tok if hf_tok is not None else manual_vocab,
            max_length=max_length,
            prompt_template=data_cfg.get(
                "prompt_template", "User: {instruction}\nAssistant: {output}"),
            is_hf_tokenizer=hf_tok is not None,
            model_config_vocab_size=config.vocab_size,
            model_config_eos_token_id=config.eos_token_id,
            model_config_pad_token_id=config.pad_token_id,
            model_config_unk_token_id=config.unk_token_id,
            model_config_bos_token_id=config.bos_token_id,
        )
        train_ds = ApertisFineTuneDataset(data_cfg["train_data_path"], **common)
        val_ds = (ApertisFineTuneDataset(data_cfg["val_data_path"], **common)
                  if data_cfg.get("val_data_path") else None)
    else:
        common = dict(
            vocab_dict=manual_vocab,
            hf_tokenizer=hf_tok,
            model_config_vocab_size=config.vocab_size,
            max_length=max_length,
            multimodal=config.multimodal,
            image_dir=data_cfg.get("image_dir"),
            image_size=config.image_size,
            pad_token_id=config.pad_token_id,
            unk_token_id=config.unk_token_id,
            bos_token_id=config.bos_token_id,
            eos_token_id=config.eos_token_id,
        )
        train_ds = ApertisPretrainDataset(data_cfg["train_data_path"], **common)
        val_ds = (ApertisPretrainDataset(data_cfg["val_data_path"], **common)
                  if data_cfg.get("val_data_path") else None)

    trainer = ApertisTrainer(
        config, params, train_ds, val_ds,
        output_dir=train_cfg.get("output_dir", "output"),
        batch_size=train_cfg.get("batch_size", 4),
        learning_rate=train_cfg.get("learning_rate", 5e-5),
        weight_decay=train_cfg.get("weight_decay", 0.01),
        num_epochs=train_cfg.get("num_epochs", 3),
        warmup_steps=train_cfg.get("warmup_steps", 0),
        gradient_accumulation_steps=train_cfg.get("gradient_accumulation_steps", 4),
        max_grad_norm=train_cfg.get("max_grad_norm", 1.0),
        use_wandb=train_cfg.get("use_wandb", False),
        wandb_project=train_cfg.get("wandb_project", "apertis"),
        wandb_run_name=train_cfg.get("wandb_run_name"),
        bf16=train_cfg.get("bf16", train_cfg.get("fp16", True)),
        checkpoint_steps=train_cfg.get("checkpoint_steps", 0),
        iteration_checkpoint_steps=train_cfg.get("iteration_checkpoint_steps", 0),
        use_gradient_checkpointing=train_cfg.get("use_gradient_checkpointing", True),
        eval_every_n_epochs=train_cfg.get("eval_every_n_epochs", 1),
        dynamic_batch_sizing=train_cfg.get("dynamic_batch_sizing", True),
        mesh_shape=train_cfg.get("mesh_shape"),
        pipeline_stages=train_cfg.get("pipeline_stages", 0),
        pipeline_microbatches=train_cfg.get("pipeline_microbatches", 0),
        pipeline_schedule=train_cfg.get("pipeline_schedule", "gpipe"),
        stop_event=stop_event,
        is_fine_tuning=is_fine_tuning,
        tokenizer_path_to_save=tokenizer_path,
        seed=train_cfg.get("seed", 0),
        resume_from=train_cfg.get("resume_from"),
        profile_dir=train_cfg.get("profile_dir"),
        device=device,
    )
    logger.info("Starting %s with config %s",
                "fine-tuning" if is_fine_tuning else "pre-training", config_path)
    return trainer.train()


def get_available_devices() -> list:
    """The CUDA devices for the UI (the reference's get_available_gpus,
    pipeline.py:701-707)."""
    if not torch.cuda.is_available():
        return []
    return [{"id": i, "platform": "gpu", "kind": torch.cuda.get_device_name(i)}
            for i in range(torch.cuda.device_count())]


# The reference's name.
get_available_gpus = get_available_devices


class YoloStyleTrainingPipeline:
    """Compat wrapper (reference: pipeline.py:993-998)."""

    def __init__(self, config_path: str,
                 stop_event: Optional[threading.Event] = None):
        self.config_path = config_path
        self.stop_event = stop_event or threading.Event()

    def train(self):
        return train_from_config(self.config_path, self.stop_event)


def create_sample_config(output_path: str) -> None:
    """Write an annotated sample training config
    (reference: pipeline.py:1000-1072)."""
    sample = {
        "data_config": {
            "train_data_path": "data/train.jsonl",
            "val_data_path": "data/val.jsonl",
            "tokenizer_path": "data/vocab.json",
            "max_length": 512,
            "image_dir": None,
            "use_hf_tokenizer_for_finetune": False,
            "prompt_template": "User: {instruction}\nAssistant: {output}",
        },
        "model_config": {
            "target_param_count": "125M",
            "attention_type": "standard_mha",
            "multimodal": False,
            "use_expert_system": False,
            "num_experts": 8,
            "experts_per_token": 2,
            "ssm_d_state": 16,
            "ssm_dt_rank": "auto",
            "ssm_conv_kernel": 4,
            "use_flash_attention": False,
            "config_overrides": {
                "use_rmsnorm": False,
                "use_swiglu": False,
            },
        },
        "training_config": {
            "task_type": "pretrain",
            "output_dir": "output",
            "batch_size": 4,
            "learning_rate": 5e-5,
            "weight_decay": 0.01,
            "num_epochs": 3,
            "gradient_accumulation_steps": 4,
            "max_grad_norm": 1.0,
            "bf16": True,
            "use_gradient_checkpointing": True,
            "checkpoint_steps": 0,
            "iteration_checkpoint_steps": 0,
            "eval_every_n_epochs": 1,
            "use_wandb": False,
            "wandb_project": "apertis",
            "mesh_shape": None,
            "pipeline_stages": 0,
            "seed": 0,
            "resume_from": None,
            "pretrained_model_path_for_finetune": None,
            "device": "cuda",
        },
    }
    path = Path(output_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(sample, f, indent=2)
    logger.info("Sample training config written to %s", output_path)
