"""AZR task/solution generation and validation.

Behavioural port of reference src/training/azr/data_construction.py. The
model dependency is abstracted to a ``generate_fn(prompt, max_new_tokens,
temperature, top_p) -> str`` callable (wrapping this framework's compiled
InferenceEngine) so the self-play logic is engine-agnostic and unit-testable.

Heuristic metrics are preserved exactly: complexity as the weighted mix of
word count / lexical density / long words / numbers / logical-math-comparison
ops / code blocks (data_construction.py:185-215), clarity via Flesch reading
ease + question bonus (232-251), coherence via transition words + adjacent
sentence Jaccard (416-440), relevance via task-solution Jaccard (442-452),
structure via numbered/bulleted/conclusion lines (454-468).

The port's copy of ``apertis_llm_tpu/training/azr/construction.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import string
from typing import Any, Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

GenerateFn = Callable[..., str]

STOP_WORDS = frozenset("""
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can can't cannot com
could couldn't did didn't do does doesn't doing don't down during each else
ever few for from further had hadn't has hasn't have haven't having he he'd
he'll he's her here here's hers herself him himself his how how's http i i'd
i'll i'm i've if in into is isn't it it's its itself just k let's like me
more most mustn't my myself no nor not of off on once only or other ought
our ours ourselves out over own r same shall shan't she she'd she'll she's
should shouldn't so some such than that that's the their theirs them
themselves then there there's these they they'd they'll they're they've this
those through to too under until up very was wasn't we we'd we'll we're
we've were weren't what what's when when's where where's which while who
who's whom why why's with won't would wouldn't www you you'd you'll you're
you've your yours yourself yourselves
""".split())


def extract_code_blocks(text: str) -> List[str]:
    matches = re.findall(r"```(?:python)?(.*?)```", text, re.DOTALL)
    return [m.strip() for m in matches if m.strip()]


class TaskGenerator:
    """Samples a task type and prompts the model to propose a task."""

    TYPE_PROMPTS = {
        "abduction": (" The problem must require abductive reasoning, where one "
                      "infers the most plausible explanation from a set of "
                      "observations. The answer should not be immediately obvious. "
                      "Example: 'A detective finds a room with a shattered window, "
                      "a valuable painting missing, and a single muddy footprint "
                      "near the window. What is the most likely sequence of events?'"),
        "deduction": (" The problem must require deductive reasoning, where a "
                      "conclusion is logically derived from a set of premises. It "
                      "should involve multiple steps of reasoning. Example: 'All "
                      "expert systems are intelligent. All intelligent systems use "
                      "knowledge. Apertis is an expert system. What can you deduce "
                      "about Apertis?'"),
        "induction": (" The problem must require inductive reasoning, where a "
                      "general rule is inferred from specific examples. The pattern "
                      "should be non-trivial. Example: 'Consider the sequence: 3, 7, "
                      "16, 35, 74. What is the next number and what is the rule "
                      "governing the sequence?'"),
    }

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.task_types = config.get("task_types",
                                     ["abduction", "deduction", "induction"])
        self.task_distribution = config.get("task_distribution", [0.3, 0.3, 0.4])
        self.max_attempts = config.get("max_attempts", 3)
        self.seed_tasks = self._load_seed_tasks(config.get("seed_tasks_path"))
        self._rng = np.random.default_rng(config.get("seed"))

    def _load_seed_tasks(self, path: Optional[str]) -> Dict[str, List[str]]:
        tasks = {t: [] for t in self.task_types}
        if not path or not os.path.exists(path):
            return tasks
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    try:
                        item = json.loads(line.strip())
                    except json.JSONDecodeError:
                        continue
                    if item.get("type") in tasks and "task" in item:
                        tasks[item["type"]].append(item["task"])
        except Exception as e:
            logger.error("Error loading seed tasks: %s", e)
        return tasks

    def generate_task(self, generate_fn: GenerateFn) -> Dict[str, Any]:
        task_type = str(self._rng.choice(self.task_types, p=self.task_distribution))

        seeds = self.seed_tasks.get(task_type, [])
        if seeds and self._rng.random() < self.config.get("seed_task_probability", 0.2):
            return {"task": str(self._rng.choice(seeds)), "type": task_type,
                    "from_seed": True}

        prompt = self._task_prompt(task_type)
        for attempt in range(self.max_attempts):
            try:
                text = generate_fn(
                    prompt,
                    max_new_tokens=self.config.get("max_new_tokens", 512),
                    temperature=self.config.get("temperature", 0.7),
                    top_p=self.config.get("top_p", 0.9)).strip()
                task = self._extract_task(text)
                if task:
                    if len(task) < 15:
                        task = (f"Create a more detailed and challenging "
                                f"{task_type} reasoning problem based on the "
                                f"concept of: '{task}'.")
                    return {"task": task, "type": task_type, "from_seed": False}
                logger.warning("Failed to extract task (attempt %d/%d)",
                               attempt + 1, self.max_attempts)
            except Exception as e:
                logger.error("Error generating task (attempt %d/%d): %s",
                             attempt + 1, self.max_attempts, e)

        if seeds:
            return {"task": str(self._rng.choice(seeds)), "type": task_type,
                    "from_seed": True}
        return {
            "task": (f"Create a simple {task_type} reasoning problem about "
                     "numbers. For example, if we have a sequence 2, 4, 6, 8, "
                     "what comes next and why?"),
            "type": task_type, "from_seed": False, "is_placeholder": True,
        }

    def _task_prompt(self, task_type: str) -> str:
        base = self.config.get(
            "base_prompt",
            "You are a problem designer. Generate a novel, challenging "
            "reasoning problem that requires deep thinking.")
        return base + self.TYPE_PROMPTS.get(task_type, "")

    @staticmethod
    def _extract_task(text: str) -> Optional[str]:
        lines = text.strip().split("\n")
        if not lines:
            return None
        task = lines[0]
        for prefix in ("Task:", "Problem:", "Question:"):
            if task.startswith(prefix):
                task = task[len(prefix):].strip()
        if len(task) < 15 and len(lines) > 1:
            task = " ".join(lines[:min(3, len(lines))])
        return task or None


class TaskValidator:
    """Length bounds + complexity/clarity heuristics (+ optional execution of
    code blocks for induction tasks)."""

    LOGICAL_OPS = frozenset({"and", "or", "not", "if", "then", "all", "some",
                             "none", "every", "any"})
    COMPARATIVE_OPS = ("<", ">", "<=", ">=", "==", "!=")

    def __init__(self, config: Dict[str, Any], python_executor=None):
        self.config = config
        self.python_executor = python_executor
        self.min_length = config.get("min_length", 15)
        self.max_length = config.get("max_length", 2500)

    def validate(self, task_info: Dict[str, Any]) -> Dict[str, Any]:
        task = task_info.get("task", "")
        if task_info.get("is_placeholder", False):
            return {"is_valid": True, "complexity": 0.5, "clarity": 0.5,
                    "executability": 1.0, "reason": "Placeholder task accepted"}
        if not task or len(task) < self.min_length:
            return {"is_valid": False, "reason": "Task too short"}
        if len(task) > self.max_length:
            return {"is_valid": False, "reason": "Task too long"}

        executability = {"score": 1.0}
        if task_info.get("type") == "induction" and self.python_executor:
            executability = self._check_executability(task)

        complexity = self.complexity(task)
        clarity = self.clarity(task)
        is_valid = (complexity >= self.config.get("min_complexity", 0.2)
                    and clarity >= self.config.get("min_clarity", 0.4))
        if not is_valid and task_info.get("from_seed", False):
            is_valid = True
        return {"is_valid": is_valid, "complexity": complexity,
                "clarity": clarity, "executability": executability["score"],
                "reason": None if is_valid else "Failed metric thresholds"}

    def complexity(self, task: str) -> float:
        words = task.lower().split()
        n = len(words)
        if n == 0:
            return 0.0
        unique = len(set(words))
        long_words = sum(1 for w in words if len(w) > 8)
        numbers = len(re.findall(r"\b\d+\.?\d*\b", task))
        logical = sum(1 for w in words if w in self.LOGICAL_OPS)
        math_ops = sum(task.count(op) for op in "+-*/^=")
        comparative = sum(task.count(op) for op in self.COMPARATIVE_OPS)
        code = len(extract_code_blocks(task))
        score = (min(1.0, n / 150) * 0.15
                 + min(1.0, unique / n * 1.5) * 0.20
                 + min(1.0, long_words / 10) * 0.15
                 + min(1.0, numbers / 8) * 0.15
                 + min(1.0, (logical + comparative) / 10) * 0.20
                 + min(1.0, math_ops / 8) * 0.10
                 + min(1.0, code * 0.5) * 0.05)
        return max(0.1, score)

    @staticmethod
    def _syllables(word: str) -> int:
        word = word.lower()
        vowels = "aeiouy"
        count = 1 if word and word[0] in vowels else 0
        for i in range(1, len(word)):
            if word[i] in vowels and word[i - 1] not in vowels:
                count += 1
        if word.endswith("e"):
            count -= 1
        if word.endswith("le") and len(word) > 2 and word[-3] not in vowels:
            count += 1
        return max(1, count)

    def clarity(self, task: str) -> float:
        sentences = [s for s in re.split(r"[.!?]+", task) if len(s.strip()) > 3]
        words = [w.strip(string.punctuation) for w in task.split()
                 if w.strip(string.punctuation)]
        if len(words) < 5 or not sentences:
            return 0.0
        avg_sentence_len = len(words) / len(sentences)
        avg_syllables = sum(self._syllables(w) for w in words) / len(words)
        flesch = 206.835 - 1.015 * avg_sentence_len - 84.6 * avg_syllables
        flesch_clarity = max(0.0, min(1.0, flesch / 100.0))
        question = 1.0 if "?" in task else 0.7
        return flesch_clarity * 0.85 + question * 0.15

    def _check_executability(self, task: str) -> Dict[str, Any]:
        blocks = extract_code_blocks(task)
        if not blocks:
            return {"score": 0.5}
        for code in blocks:
            result = self.python_executor.execute(code)
            if not result["success"]:
                return {"score": 0.0}
        return {"score": 1.0}


class SolutionGenerator:
    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.max_attempts = config.get("max_attempts", 3)

    def generate_solution(self, task_info: Dict[str, Any],
                          generate_fn: GenerateFn) -> Dict[str, Any]:
        task = task_info.get("task", "")
        task_type = task_info.get("type", "")
        prompt = self._solution_prompt(task, task_type)
        for attempt in range(self.max_attempts):
            try:
                text = generate_fn(
                    prompt,
                    max_new_tokens=self.config.get("max_new_tokens", 1024),
                    temperature=self.config.get("temperature", 0.6),
                    top_p=self.config.get("top_p", 0.9)).strip()
                solution = self._extract_solution(text)
                if solution:
                    return {"task": task, "type": task_type,
                            "solution": solution, "raw_generation": text}
            except Exception as e:
                logger.error("Error generating solution (attempt %d/%d): %s",
                             attempt + 1, self.max_attempts, e)

        placeholders = {
            "abduction": (f"To solve this abductive reasoning problem, the most "
                          f"plausible explanation must be inferred from the key "
                          f"observations in '{task[:60]}...'. This involves forming "
                          "and evaluating hypotheses based on the provided evidence."),
            "deduction": (f"To solve this deductive reasoning problem, logical "
                          f"rules must be strictly applied to the premises given in "
                          f"'{task[:60]}...'. The conclusion must necessarily follow "
                          "if the premises are true."),
            "induction": (f"To solve this inductive reasoning problem, a general "
                          f"pattern must be identified from the specific instances "
                          f"mentioned in '{task[:60]}...'. This pattern can then be "
                          "used to predict future outcomes or formulate a general rule."),
        }
        default = ("To solve this problem, I will first break it down into its "
                   "core components, analyze the relationships between them, and "
                   "then apply a step-by-step reasoning process to arrive at a "
                   "logical conclusion.")
        return {"task": task, "type": task_type,
                "solution": placeholders.get(task_type, default),
                "raw_generation": "", "is_placeholder": True}

    def _solution_prompt(self, task: str, task_type: str) -> str:
        base = self.config.get(
            "base_prompt",
            "You are a world-class reasoning expert. Solve the following "
            "problem by thinking step-by-step. Provide a clear, structured, "
            "and detailed explanation. Enclose your final answer within "
            "<answer> tags.")
        if self.config.get("include_task_type_hint", True):
            base += f" This is a {task_type} reasoning problem."
        return f"{base}\n\n### Problem ###\n{task}\n\n### Solution ###"

    @staticmethod
    def _extract_solution(text: str) -> Optional[str]:
        if not text.strip():
            return None
        matches = re.findall(r"<answer>(.*?)</answer>", text, re.DOTALL)
        return matches[0].strip() if matches else text.strip()


class SolutionValidator:
    def __init__(self, config: Dict[str, Any], python_executor=None):
        self.config = config
        self.python_executor = python_executor

    def validate(self, task_info: Dict[str, Any],
                 solution_info: Dict[str, Any]) -> Dict[str, Any]:
        task = task_info.get("task", "")
        task_type = task_info.get("type", "")
        solution = solution_info.get("solution", "")
        raw = solution_info.get("raw_generation", solution)
        if solution_info.get("is_placeholder", False):
            return {"is_valid": True, "correctness": 0.5, "coherence": 0.5,
                    "relevance": 0.5, "structure": 0.5,
                    "reason": "Placeholder solution accepted"}
        if not solution:
            return {"is_valid": False, "correctness": 0.0,
                    "reason": "Empty solution"}
        if task_type == "induction" and self.python_executor:
            return self._validate_with_execution(task, solution, raw)
        return self._validate_heuristic(task, solution, raw)

    def _validate_with_execution(self, task, solution, raw) -> Dict[str, Any]:
        blocks = extract_code_blocks(solution)
        if not blocks:
            return self._validate_heuristic(task, solution, raw)
        success = all(self.python_executor.execute(c)["success"] for c in blocks)
        metrics = self._validate_heuristic(task, solution, raw, is_executed=True)
        if success:
            metrics["correctness"] = max(metrics["correctness"], 0.8)
            metrics["reason"] = "Execution successful, combined with heuristics"
        else:
            metrics["correctness"] *= 0.5
            metrics["reason"] = "Execution failed, heuristic score penalized"
        metrics["is_valid"] = (metrics["correctness"]
                               >= self.config.get("min_correctness_exec", 0.4))
        return metrics

    def _validate_heuristic(self, task, solution, raw,
                            is_executed: bool = False) -> Dict[str, Any]:
        if len(solution.split()) < 10:
            return {"is_valid": False, "correctness": 0.0,
                    "reason": "Solution too short"}
        coherence = self.coherence(solution)
        relevance = self.relevance(task, solution)
        structure = self.structure(raw)
        correctness = (coherence + relevance + structure) / 3
        is_valid = (coherence >= self.config.get("min_coherence", 0.4)
                    and relevance >= self.config.get("min_relevance", 0.4)
                    and structure >= self.config.get("min_structure", 0.3)
                    and correctness >= self.config.get("min_correctness", 0.45))
        if not is_valid and len(solution.split()) >= 50 and not is_executed:
            is_valid = True
        return {"is_valid": is_valid, "correctness": correctness,
                "coherence": coherence, "relevance": relevance,
                "structure": structure,
                "reason": None if is_valid else "Failed heuristic metric thresholds"}

    TRANSITIONS = ("therefore", "thus", "hence", "consequently", "as a result",
                   "because", "first", "second", "third", "finally",
                   "in conclusion", "however", "although", "conversely",
                   "similarly", "likewise", "in addition", "furthermore")

    def coherence(self, solution: str) -> float:
        sentences = [s.strip() for s in re.split(r"[.!?]+", solution)
                     if len(s.strip().split()) > 3]
        if len(sentences) <= 1:
            return 0.3
        transitions = sum(solution.lower().count(w) for w in self.TRANSITIONS)
        transition_factor = min(1.0, transitions / (len(sentences) * 0.25))
        word_sets = [set(s.lower().split()) - STOP_WORDS for s in sentences]
        overlaps = []
        for a, b in zip(word_sets, word_sets[1:]):
            if not a or not b:
                continue
            union = len(a | b)
            overlaps.append(len(a & b) / union if union else 0.0)
        avg_overlap = sum(overlaps) / len(overlaps) if overlaps else 0.0
        return 0.2 + transition_factor * 0.4 + avg_overlap * 0.6

    @staticmethod
    def relevance(task: str, solution: str) -> float:
        task_words = {w.lower() for w in task.split() if w.lower() not in STOP_WORDS}
        sol_words = {w.lower() for w in solution.split() if w.lower() not in STOP_WORDS}
        if not task_words:
            return 0.5
        jaccard = len(task_words & sol_words) / len(task_words | sol_words)
        return min(1.0, 0.2 + jaccard * 2.0)

    @staticmethod
    def structure(solution: str) -> float:
        lines = solution.split("\n")
        if len(lines) <= 1:
            return 0.2
        non_empty = [ln for ln in lines if ln.strip()]
        numbered = sum(1 for ln in non_empty if re.match(r"^\s*\d+[.)]", ln))
        bullets = sum(1 for ln in non_empty if re.match(r"^\s*[-*•]", ln))
        conclusions = sum(1 for ln in non_empty if ln.lower().strip().startswith(
            ("conclusion:", "answer:", "therefore,", "in summary:")))
        elements = numbered + bullets + conclusions * 2
        ratio = min(1.0, elements / (len(non_empty) * 0.5)) if non_empty else 0.0
        return 0.2 + ratio * 0.8
