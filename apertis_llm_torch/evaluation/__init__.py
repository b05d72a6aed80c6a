"""Evaluation harness: perplexity + multiple-choice (MMLU-style) accuracy
(``apertis_llm_tpu/evaluation``): batched log-likelihood scoring over JSONL
datasets, exposed through ``apertis-torch eval``."""

from apertis_llm_torch.evaluation.harness import (
    compute_perplexity,
    evaluate_multiple_choice,
    run_eval,
)

__all__ = ["compute_perplexity", "evaluate_multiple_choice", "run_eval"]
