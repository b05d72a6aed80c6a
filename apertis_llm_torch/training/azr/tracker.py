"""Self-play metrics tracking + per-record persistence
(reference: src/training/azr/utils.py:145-278).

The port's copy of ``apertis_llm_tpu/training/azr/tracker.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from datetime import datetime
from typing import Any, Dict, List

from apertis_llm_torch.training.azr.executor import load_metrics

logger = logging.getLogger(__name__)


class SelfPlayTracker:
    def __init__(self, config: Dict[str, Any], output_dir: str):
        self.config = config
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.metrics = self._load_or_init()
        self.task_history: List[Dict[str, Any]] = []
        self.solution_history: List[Dict[str, Any]] = []

    def _load_or_init(self) -> Dict[str, Any]:
        metrics_file = os.path.join(self.output_dir, "metrics.json")
        if self.config.get("continue_from_checkpoint", False) and os.path.exists(metrics_file):
            logger.info("Continuing from existing metrics: %s", metrics_file)
            loaded = load_metrics(metrics_file)
            loaded.setdefault("task_rewards", [])
            loaded.setdefault("solution_rewards", [])
            loaded.setdefault("task_types", {})
            loaded.setdefault("validation_rates", {"tasks": [], "solutions": []})
            return loaded
        return {
            "iterations": 0,
            "tasks_generated": 0,
            "tasks_valid": 0,
            "solutions_generated": 0,
            "solutions_valid": 0,
            "task_rewards": [],
            "solution_rewards": [],
            "task_types": defaultdict(int),
            "validation_rates": {"tasks": [], "solutions": []},
        }

    def update_task_metrics(self, task_info, validation, rewards) -> None:
        self.metrics["tasks_generated"] += 1
        if validation.get("is_valid", False):
            self.metrics["tasks_valid"] += 1
        task_type = task_info.get("type", "unknown")
        types = self.metrics["task_types"]
        types[task_type] = types.get(task_type, 0) + 1
        self.metrics["task_rewards"].append(rewards)
        record = {"task": task_info, "validation": validation, "rewards": rewards}
        self.task_history.append(record)
        if self.config.get("save_tasks", True):
            self._save_record(record, "tasks",
                              f"task_{self.metrics['tasks_generated']:06d}.json")

    def update_solution_metrics(self, task_info, solution_info, validation,
                                rewards) -> None:
        self.metrics["solutions_generated"] += 1
        if validation.get("is_valid", False):
            self.metrics["solutions_valid"] += 1
        self.metrics["solution_rewards"].append(rewards)
        record = {"task": task_info, "solution": solution_info,
                  "validation": validation, "rewards": rewards}
        self.solution_history.append(record)
        if self.config.get("save_solutions", True):
            self._save_record(record, "solutions",
                              f"solution_{self.metrics['solutions_generated']:06d}.json")

    def record_iteration_stats(self, task_val_rate: float,
                               sol_val_rate: float) -> None:
        self.metrics["iterations"] += 1
        self.metrics["validation_rates"]["tasks"].append(task_val_rate)
        self.metrics["validation_rates"]["solutions"].append(sol_val_rate)
        self._save_metrics()

    def get_metrics(self) -> Dict[str, Any]:
        return self.metrics

    def get_task_history(self) -> List[Dict[str, Any]]:
        return self.task_history

    def _save_record(self, data, subdir: str, filename: str) -> None:
        record_dir = os.path.join(self.output_dir, subdir)
        os.makedirs(record_dir, exist_ok=True)
        record = dict(data)
        record["timestamp"] = datetime.now().isoformat()
        with open(os.path.join(record_dir, filename), "w", encoding="utf-8") as f:
            json.dump(record, f, indent=2)

    def _save_metrics(self) -> None:
        with open(os.path.join(self.output_dir, "metrics.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.get_summary_metrics(), f, indent=2)

    def get_summary_metrics(self) -> Dict[str, Any]:
        m = self.metrics
        rates = m["validation_rates"]

        def avg(xs):
            return sum(xs) / len(xs) if xs else 0

        return {
            "iterations": m.get("iterations", 0),
            "tasks_generated": m.get("tasks_generated", 0),
            "tasks_valid": m.get("tasks_valid", 0),
            "task_valid_rate": m.get("tasks_valid", 0) / max(1, m.get("tasks_generated", 0)),
            "solutions_generated": m.get("solutions_generated", 0),
            "solutions_valid": m.get("solutions_valid", 0),
            "solution_valid_rate": m.get("solutions_valid", 0) / max(1, m.get("solutions_generated", 0)),
            "task_types": dict(m.get("task_types", {})),
            "avg_task_rewards": self._avg_rewards(m.get("task_rewards", [])),
            "avg_solution_rewards": self._avg_rewards(m.get("solution_rewards", [])),
            "avg_validation_rates": {"tasks": avg(rates["tasks"]),
                                     "solutions": avg(rates["solutions"])},
            "timestamp": datetime.now().isoformat(),
        }

    @staticmethod
    def _avg_rewards(history: List[Dict[str, float]]) -> Dict[str, float]:
        if not history:
            return {}
        sums: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for rewards in history:
            for key, value in rewards.items():
                sums[key] += value
                counts[key] += 1
        return {k: sums[k] / counts[k] for k in sums}
