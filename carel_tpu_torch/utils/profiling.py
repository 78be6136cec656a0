"""Profiling helpers, port of carel_tpu/utils/profiling.py: a torch.profiler
trace and a step-time meter.

The reference's only instrumentation is wall-clock minutes and a running loss
print (flagship :846-851, :990); here a trace of the base training is one
flag away (``--profile_dir``), plus a cheap streaming step timer for
throughput accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(profile_dir: str):
    """torch.profiler trace of the enclosed work (host, and the card's
    kernels where there is one), written into ``profile_dir`` as a Chrome
    trace, ``trace_<time>_<pid>.json``; a no-op when ``profile_dir`` is
    empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    name = f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(profile_dir, name))


class StepTimer:
    """Streaming step timer (keeps the last ``window`` steps); time only
    work that ends in a value fetch or a synchronize."""

    def __init__(self, window: int = 200):
        self.window = window
        self.times: list = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
        }
