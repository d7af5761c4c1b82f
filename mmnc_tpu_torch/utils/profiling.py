"""Profiling helpers: torch.profiler traces and step-time statistics
(mmnc_tpu/utils/profiling.py).

`trace(log_dir)` records the enclosed block with torch.profiler (host
ops, and the card's kernels and copies when CUDA is available) and writes
a Chrome trace (open it in chrome://tracing or Perfetto) into log_dir;
`start_trace` / `stop_trace` do the same across calls, as the train loop
needs. `StepTimer` accumulates wall-clock step times and reports
p50/p95/mean.
"""

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


def start_trace(log_dir: str):
    """Start a torch.profiler trace; returns the handle `stop_trace` takes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof, log_dir


def stop_trace(handle) -> str:
    """Wait for the card, stop the trace `start_trace` returned and write
    it as <log_dir>/trace_<time>.json; returns the path."""
    prof, log_dir = handle
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into log_dir."""
    handle = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(handle)


class StepTimer:
    """Wall-clock step statistics; call tick() once per step."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._times = []
        self._last: Optional[float] = None
        self._seen = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.skip_first:
                self._times.append(now - self._last)
        self._last = now

    def stats(self) -> dict:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / arr.mean()),
        }
