"""AZR support utilities: logging setup, metrics IO, sandboxed Python runner.

Behavioural port of reference src/training/azr/utils.py:12-105. The executor
keeps the subprocess boundary (timeout + output caps) — code generated during
self-play never runs in the trainer process, and the child sees no CUDA
device (``CUDA_VISIBLE_DEVICES`` empty unless ``config["env"]`` sets it).

The port's copy of ``apertis_llm_tpu/training/azr/executor.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


def setup_logging(log_level: str = "INFO", log_file: Optional[str] = None) -> None:
    numeric = getattr(logging, str(log_level).upper(), None)
    if not isinstance(numeric, int):
        numeric = logging.INFO
    for handler in logging.root.handlers[:]:
        logging.root.removeHandler(handler)
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        handlers.append(logging.FileHandler(log_file, mode="a"))
    logging.basicConfig(
        level=numeric,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        handlers=handlers)


def save_metrics(metrics: Dict[str, Any], filepath: str) -> bool:
    try:
        os.makedirs(os.path.dirname(filepath), exist_ok=True)
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(metrics, f, indent=2)
        return True
    except Exception as e:
        logger.error("Error saving metrics to %s: %s", filepath, e)
        return False


def load_metrics(filepath: str) -> Dict[str, Any]:
    try:
        if not os.path.exists(filepath):
            return {}
        with open(filepath, "r", encoding="utf-8") as f:
            return json.load(f)
    except Exception as e:
        logger.error("Error loading metrics from %s: %s", filepath, e)
        return {}


class PythonExecutor:
    """Run generated Python in a subprocess with a timeout and output caps
    (process-boundary sandbox, reference: utils.py:59-105)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.timeout = config.get("timeout", 5)
        self.max_output_size = config.get("max_output_size", 10000)
        # Generated code must never claim the card: the child interpreter
        # sees no CUDA device.
        self.env = dict(os.environ)
        self.env["CUDA_VISIBLE_DEVICES"] = ""
        self.env.update(config.get("env", {}))

    def execute(self, code: str) -> Dict[str, Any]:
        with tempfile.NamedTemporaryFile(
                suffix=".py", delete=False, mode="w", encoding="utf-8") as f:
            f.write(code)
            temp_file = f.name
        try:
            proc = subprocess.Popen(
                [sys.executable, temp_file],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, encoding="utf-8", env=self.env)
            try:
                stdout, stderr = proc.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                return {"success": False, "output": "",
                        "error": f"Execution timed out after {self.timeout} seconds",
                        "return_code": -1}
            cap = self.max_output_size
            if len(stdout) > cap:
                stdout = stdout[:cap] + "\n... [output truncated]"
            if len(stderr) > cap:
                stderr = stderr[:cap] + "\n... [error truncated]"
            return {"success": proc.returncode == 0, "output": stdout,
                    "error": stderr, "return_code": proc.returncode}
        except Exception as e:
            return {"success": False, "output": "", "error": str(e),
                    "return_code": -1}
        finally:
            if os.path.exists(temp_file):
                os.unlink(temp_file)
