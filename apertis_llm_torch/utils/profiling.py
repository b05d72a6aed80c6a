"""Profiling and step-timing observability (``apertis_llm_tpu/utils/
profiling.py`` on ``torch.profiler``).

:func:`start_trace` / :func:`stop_trace` capture a ``torch.profiler``
trace of the CPU and, where there is one, the card into a directory (a
Chrome trace, ``trace.json``);
:class:`StepTimer` keeps rolling step-time statistics; and
:func:`device_peak_tflops` gives the card's dense bf16 peak for the trainer's
``mfu_pct``.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


def start_trace() -> torch.profiler.profile:
    """Start a ``torch.profiler`` capture of the CPU and the card; stop it
    with :func:`stop_trace`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, profile_dir: str) -> None:
    """Stop ``prof`` and write its Chrome trace to ``profile_dir/trace.json``."""
    prof.stop()
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
    logger.info("Profiler trace written to %s", profile_dir)


class StepTimer:
    """Rolling step-time / throughput statistics."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def stats(self, tokens_per_step: Optional[int] = None) -> Dict[str, float]:
        if not self.times:
            return {}
        times = sorted(self.times)
        mean = sum(times) / len(times)
        out = {
            "step_time_mean_s": mean,
            "step_time_p50_s": times[len(times) // 2],
            "step_time_p90_s": times[int(len(times) * 0.9)],
        }
        if tokens_per_step:
            out["tokens_per_sec"] = tokens_per_step / mean
        return out


# Dense bf16 peaks (TFLOP/s) keyed by a substring of the card's name, from
# NVIDIA's data sheets (the SXM part, without sparsity).
_GPU_PEAK_TFLOPS_BF16 = (
    ("H100", 989.0),
)


def device_peak_tflops() -> Optional[float]:
    """The dense bf16 peak of the card, for MFU accounting.

    ``APERTIS_PEAK_TFLOPS`` overrides (on any device, CPU test runs too);
    otherwise it is looked up by ``torch.cuda.get_device_name``, and None
    (no MFU reported) without a card or for a card not in the table."""
    env = os.environ.get("APERTIS_PEAK_TFLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            logger.warning("Unparseable APERTIS_PEAK_TFLOPS=%r", env)
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    for needle, peak in _GPU_PEAK_TFLOPS_BF16:
        if needle in name:
            return peak
    return None

