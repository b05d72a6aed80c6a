"""Absolute Zero Reasoner (AZR) self-play components
(reference: src/training/azr/__init__.py:1-37).

The port's copy of ``apertis_llm_tpu/training/azr/__init__.py``, whose package imports JAX;
the port imports nothing of it.
"""

from apertis_llm_torch.training.azr.construction import (
    SolutionGenerator,
    SolutionValidator,
    TaskGenerator,
    TaskValidator,
)
from apertis_llm_torch.training.azr.executor import (
    PythonExecutor,
    load_metrics,
    save_metrics,
    setup_logging,
)
from apertis_llm_torch.training.azr.rewards import (
    AccuracyReward,
    BaseReward,
    ClarityReward,
    CoherenceReward,
    ComplexityReward,
    DiversityReward,
    RelevanceReward,
    RewardCalculator,
    StructureReward,
    default_reward_modules,
)
from apertis_llm_torch.training.azr.tracker import SelfPlayTracker

__all__ = [
    "TaskGenerator", "TaskValidator", "SolutionGenerator", "SolutionValidator",
    "PythonExecutor", "setup_logging", "save_metrics", "load_metrics",
    "BaseReward", "ClarityReward", "ComplexityReward", "DiversityReward",
    "AccuracyReward", "CoherenceReward", "RelevanceReward", "StructureReward",
    "default_reward_modules", "RewardCalculator", "SelfPlayTracker",
]
