"""Training (``apertis_llm_tpu/training``): the optimizer and steps
(``step``), the datasets, the trainer and the config-driven pipeline.

``train_from_config`` runs the standard trainer; the AZR self-play method
(``training.method == "azr"``) is not ported yet and raises
``NotImplementedError`` (ROADMAP.md, module 6).
"""

from __future__ import annotations

import json
import threading
from typing import Optional


def train_from_config(config_path: str, stop_event: Optional[threading.Event] = None):
    with open(config_path, "r", encoding="utf-8") as f:
        method = json.load(f).get("training", {}).get("method", "")
    if method == "azr":
        raise NotImplementedError(
            "the AZR self-play pipeline is not ported to PyTorch yet (see ROADMAP.md)")
    from apertis_llm_torch.training.pipeline import train_from_config as standard_train

    return standard_train(config_path, stop_event=stop_event)
