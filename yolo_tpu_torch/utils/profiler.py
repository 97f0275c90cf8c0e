"""Timing and tracing (the port's counterpart of
``yolo_tpu/utils/profiler.py``).

- ``time_synchronized``: the wall clock after the device's queued work,
  ``torch.cuda.synchronize()`` when CUDA is initialised;
- ``StepTimer``: a rolling mean of step times on the host clock;
- ``trace(logdir)``: ``torch.profiler`` over the block (CPU, and CUDA
  when it is there), its Chrome trace written into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def time_synchronized() -> float:
    """Wall time after draining pending device work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.time()


class StepTimer:
    """Lightweight rolling step timer for the train loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler. Its Chrome trace goes to
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
