"""Profiling hooks (the port of bioreason_tpu/utils/profiling.py, on
`torch.profiler` where the JAX package uses `jax.profiler`).

* `trace(logdir)`: a context manager that records the host and, where a
  card is present, the device, and writes a Chrome trace (`trace.json`,
  loadable in Perfetto or chrome://tracing) into `logdir` on exit;
* `annotate(name)`: a named range (`torch.profiler.record_function`) for
  host phases, which shows up in the same trace;
* `StepClock`: rolling per-step wall-clock statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Record into `logdir`/trace.json (nothing when logdir is None)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepClock:
    """Rolling per-step timing: mean / p50 / p90 over a window."""

    def __init__(self, window: int = 50):
        self.window = window
        self.samples: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return False

    def stats(self) -> dict:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {"step_time_mean": sum(s) / n, "step_time_p50": s[n // 2],
                "step_time_p90": s[min(n - 1, int(0.9 * n))]}
