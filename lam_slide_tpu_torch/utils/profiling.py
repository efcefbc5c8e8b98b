"""Profiling hooks (counterpart of ``lam_slide_tpu/utils/profiling.py``).

``trace`` wraps ``torch.profiler`` so any region of a training or eval run
can be captured to a Chrome trace (``chrome://tracing``, Perfetto);
``StepTimer`` (copied) tracks step wall-times and derived throughput,
feeding the trainer's metric stream.
"""

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host and device trace: ``with trace("traces/run"): run_steps()``
    writes ``<log_dir>/trace.json``. The device is traced when a card is
    present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step-time statistics + items/sec throughput."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return float(np.mean(self._times)) if self._times else float("nan")

    def record_epoch(self, epoch_s: float, n_steps: int):
        """Derive step time from a synced epoch wall time (the trainer's
        asynchronous loop: a per-step tick() would measure the enqueue, not
        device time)."""
        if n_steps > 0:
            self._times.append(epoch_s / n_steps)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = None

    def throughput(self, items_per_step: int) -> float:
        s = self.mean_step_s
        return items_per_step / s if s and np.isfinite(s) and s > 0 else float("nan")
