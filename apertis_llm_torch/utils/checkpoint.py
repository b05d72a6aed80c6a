"""Checkpointing: the full train state by ``torch.save`` plus the
reference-compatible weight export (``apertis_llm_tpu/utils/checkpoint.py``).

Every checkpoint directory holds:

  * ``state.pt`` (where the JAX package has its orbax ``state/``): the f32
    model ``state_dict``, the optimizer state, the update count, the
    micro-step and the seed of the step seeds, for a true resume; left out
    with ``full_state=False``;
  * ``pytorch_model.bin`` + ``config.json`` (+ the copied tokenizer or
    vocabulary files): loadable by the PyTorch reference and by either
    package's inference stack.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from apertis_llm_torch.models.convert import params_tree, save_torch_checkpoint

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def save_checkpoint(
    ckpt_dir,
    model,                          # ApertisForCausalLM with the f32 masters
    config,                         # ApertisConfig
    train_state: Optional[Dict[str, Any]] = None,
    tokenizer_src: Optional[str] = None,
    full_state: bool = True,
) -> None:
    """Write ``state.pt`` (``train_state`` beside the model's ``state_dict``)
    unless ``full_state`` is False, then the weight export; the trainer
    saves ``best_model`` weights-only, as the JAX trainer does."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if full_state:
        state = dict(train_state or {})
        state["model"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        tmp = ckpt_dir / (STATE_FILE + ".tmp")
        torch.save(state, tmp)
        tmp.replace(ckpt_dir / STATE_FILE)
    save_torch_checkpoint(params_tree(model), config, ckpt_dir)
    if tokenizer_src:
        src = Path(tokenizer_src)
        try:
            if src.is_file():
                shutil.copy2(src, ckpt_dir / src.name)
            elif src.is_dir():
                for f in src.iterdir():
                    if f.is_file() and f.suffix in (".json", ".txt", ".model"):
                        shutil.copy2(f, ckpt_dir / f.name)
        except OSError as e:
            logger.warning("Could not copy tokenizer from %s: %s", tokenizer_src, e)
    logger.info("Checkpoint saved to %s", ckpt_dir)


def restore_train_state(ckpt_dir, device="cpu") -> Dict[str, Any]:
    """The dict :func:`save_checkpoint` wrote to ``state.pt``, its tensors on
    ``device``."""
    return torch.load(Path(ckpt_dir).resolve() / STATE_FILE, map_location=device,
                      weights_only=True)


def latest_checkpoint(output_dir) -> Optional[Path]:
    """The most recent checkpoint directory under ``output_dir`` that holds a
    saved train state, or None."""
    output_dir = Path(output_dir)
    if not output_dir.exists():
        return None
    candidates = [d for d in output_dir.iterdir() if d.is_dir() and (d / STATE_FILE).exists()]
    if not candidates:
        return None
    return max(candidates, key=lambda d: (d / STATE_FILE).stat().st_mtime)
