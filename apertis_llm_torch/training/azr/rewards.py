"""AZR reward modules + calculator (reference: src/training/azr/rewards.py,
utils.py:107-143).

Seven rewards: clarity/complexity/diversity score proposed tasks;
accuracy/coherence/relevance/structure score solutions. Each carries a
configured weight; the calculator sums the configured subset plus a total.

The port's copy of ``apertis_llm_tpu/training/azr/rewards.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List

logger = logging.getLogger(__name__)


class BaseReward:
    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.weight = config.get("weight", 1.0)

    def calculate(self, *args, **kwargs) -> float:
        raise NotImplementedError


class ComplexityReward(BaseReward):
    """Gaussian around a target complexity (rewards.py:18-27)."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.target = config.get("target_complexity", 0.7)
        self.tolerance = config.get("tolerance", 0.15)

    def calculate(self, validation_result: Dict[str, Any]) -> float:
        c = validation_result.get("complexity", 0.0)
        return self.weight * math.exp(
            -((c - self.target) ** 2) / (2 * self.tolerance ** 2))


class ClarityReward(BaseReward):
    def calculate(self, validation_result: Dict[str, Any]) -> float:
        return self.weight * validation_result.get("clarity", 0.0)


class DiversityReward(BaseReward):
    """1 - max weighted n-gram Jaccard vs task history (rewards.py:34-75)."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.ngram_weights = config.get("ngram_weights", [0.2, 0.4, 0.4])

    @staticmethod
    def _ngrams(text: str, n: int) -> set:
        words = text.lower().split()
        if len(words) < n:
            return set()
        return set(zip(*(words[i:] for i in range(n))))

    @staticmethod
    def _jaccard(a: set, b: set) -> float:
        if not a and not b:
            return 1.0
        if not a or not b:
            return 0.0
        return len(a & b) / len(a | b)

    def calculate(self, task_info: Dict[str, Any],
                  previous_tasks: List[Dict[str, Any]]) -> float:
        if not previous_tasks:
            return self.weight
        text = task_info.get("task", "")
        max_sim = 0.0
        for prev in previous_tasks:
            prev_text = prev.get("task", "")
            sim = sum(w * self._jaccard(self._ngrams(text, i + 1),
                                        self._ngrams(prev_text, i + 1))
                      for i, w in enumerate(self.ngram_weights))
            max_sim = max(max_sim, sim)
        return self.weight * (1.0 - max_sim)


class AccuracyReward(BaseReward):
    """correctness ** partial_credit_power, zero for invalid (rewards.py:77-87)."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.power = config.get("partial_credit_power", 1.5)

    def calculate(self, validation_result: Dict[str, Any]) -> float:
        if not validation_result.get("is_valid", False):
            return 0.0
        return self.weight * validation_result.get("correctness", 0.0) ** self.power


class CoherenceReward(BaseReward):
    def calculate(self, validation_result: Dict[str, Any]) -> float:
        return self.weight * validation_result.get("coherence", 0.0)


class RelevanceReward(BaseReward):
    def calculate(self, validation_result: Dict[str, Any]) -> float:
        return self.weight * validation_result.get("relevance", 0.0)


class StructureReward(BaseReward):
    def calculate(self, validation_result: Dict[str, Any]) -> float:
        return self.weight * validation_result.get("structure", 0.0)


def default_reward_modules(reward_configs: Dict[str, Any]) -> Dict[str, BaseReward]:
    return {
        "clarity": ClarityReward(reward_configs.get("clarity", {})),
        "complexity": ComplexityReward(reward_configs.get("complexity", {})),
        "diversity": DiversityReward(reward_configs.get("diversity", {})),
        "accuracy": AccuracyReward(reward_configs.get("accuracy", {})),
        "coherence": CoherenceReward(reward_configs.get("coherence", {})),
        "relevance": RelevanceReward(reward_configs.get("relevance", {})),
        "structure": StructureReward(reward_configs.get("structure", {})),
    }


class RewardCalculator:
    def __init__(self, config: Dict[str, Any],
                 reward_modules: Dict[str, BaseReward]):
        self.reward_modules = reward_modules
        self.task_reward_keys = config.get(
            "task_reward_keys", ["clarity", "complexity", "diversity"])
        self.solution_reward_keys = config.get(
            "solution_reward_keys",
            ["accuracy", "coherence", "relevance", "structure"])

    def calculate_task_rewards(self, task_info, validation_result,
                               task_history) -> Dict[str, float]:
        rewards: Dict[str, float] = {}
        for key in self.task_reward_keys:
            module = self.reward_modules.get(key)
            if module is None:
                continue
            try:
                if key == "diversity":
                    rewards[key] = module.calculate(task_info, task_history)
                else:
                    rewards[key] = module.calculate(validation_result)
            except Exception as e:
                logger.error("Error in task reward '%s': %s", key, e)
                rewards[key] = 0.0
        rewards["total"] = sum(rewards.values())
        return rewards

    def calculate_solution_rewards(self, solution_validation) -> Dict[str, float]:
        rewards: Dict[str, float] = {}
        for key in self.solution_reward_keys:
            module = self.reward_modules.get(key)
            if module is None:
                continue
            try:
                rewards[key] = module.calculate(solution_validation)
            except Exception as e:
                logger.error("Error in solution reward '%s': %s", key, e)
                rewards[key] = 0.0
        rewards["total"] = sum(rewards.values())
        return rewards
