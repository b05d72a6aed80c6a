"""Training (``apertis_llm_tpu/training``): the optimizer and steps
(``step``), the datasets, the trainer, the config-driven pipeline and the
AZR self-play pipeline (``azr_pipeline``).

``train_from_config`` routes ``training.method == "azr"`` configs to the AZR
self-play pipeline and everything else to the standard trainer, as the JAX
package's dispatcher does (``training/__init__.py:17-28``).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

logger = logging.getLogger(__name__)


def train_from_config(config_path: str, stop_event: Optional[threading.Event] = None):
    with open(config_path, "r", encoding="utf-8") as f:
        method = json.load(f).get("training", {}).get("method", "")
    if method == "azr":
        from apertis_llm_torch.training.azr_pipeline import train_from_config as azr_train

        logger.info("Dispatching to AZR self-play pipeline")
        return azr_train(config_path, stop_event=stop_event)
    from apertis_llm_torch.training.pipeline import train_from_config as standard_train

    return standard_train(config_path, stop_event=stop_event)
