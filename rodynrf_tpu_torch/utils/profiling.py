"""Tracing and profiling hooks (port of rodynrf_tpu/utils/profiling.py).

The reference has no profiling support (SURVEY.md §5.1, tqdm only). Here:
  * `trace(logdir)`: a torch.profiler capture of the enclosed block (host
    and, on the card, CUDA activity), written to `logdir` as a Chrome trace
    (view in chrome://tracing or Perfetto);
  * `annotate(name)`: a named region in that trace (torch.profiler.
    record_function; an NVTX range when a CUDA tool records one);
  * `StepTimer`: rolling wall-clock statistics of the hot loop; on the card
    (its default; it refuses without one unless given the CPU) it
    synchronises at both ends of a timed block, so a step's time is the
    device's, not its enqueue's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from ..device import check_device


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into
    `logdir/trace.json`; yields the profiler (for key_averages())."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region in the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-clock stats (mean/p50/p95) for train/render steps. On
    the card (the default) each timed block starts and ends with a
    synchronisation; `device="cpu"` times host work."""

    def __init__(self, window: int = 200, device="cuda"):
        self.window = window
        self.samples = []
        self.device = check_device(device)
        self._t0: Optional[float] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.samples.append(time.perf_counter() - self._t0)
        if len(self.samples) > self.window:
            self.samples.pop(0)

    def stats(self) -> dict:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "mean_ms": 1000 * sum(s) / n,
            "p50_ms": 1000 * s[n // 2],
            "p95_ms": 1000 * s[min(n - 1, int(n * 0.95))],
            "steps_per_sec": n / sum(s),
        }
