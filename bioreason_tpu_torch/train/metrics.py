"""Metrics logging: one JSON row per log call to <log_dir>/metrics.jsonl
and a line on stdout, and `StepTimer` (the port's copy of
bioreason_tpu/train/metrics.py; the wandb mirror is not ported and raises).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 quiet: bool = False):
        if use_wandb:
            raise NotImplementedError("wandb logging is not ported to bioreason_tpu_torch yet")
        self.quiet = quiet
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        row = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
               for k, v in metrics.items()}
        if step is not None:
            row["step"] = step
        row["time"] = time.time()
        if self._jsonl:
            self._jsonl.write(json.dumps(row) + "\n")
            self._jsonl.flush()
        if not self.quiet:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in row.items() if k != "time")
            print(parts, flush=True)

    def log_table(self, name: str, columns, rows, step: Optional[int] = None):
        """A table as one JSONL row (the reference's completions table,
        grpo_trainer.py:718-738)."""
        if self._jsonl:
            self._jsonl.write(json.dumps({"table": name, "columns": list(columns),
                                          "rows": rows, "step": step}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None


class StepTimer:
    """Wall-clock per-step timing with warmup exclusion."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0 = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")
