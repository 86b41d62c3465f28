"""Phase timing and device profiling hooks (counterpart of
urban_tpu/utils/profiling.py).

The reference logs coarse per-iteration phase timers T_sample / T_update /
T_eval (reference: urban_planning/agents/urban_planning_agent.py:229-246);
PhaseTimer keeps them as a context manager, and device_trace records a
torch.profiler trace of the host and, where there is one, the CUDA device
around a hot phase.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class PhaseTimer:
    """Accumulates wall-clock per named phase; formats the reference's
    T_sample/T_update/T_eval log line."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def log_line(self) -> str:
        return '\t'.join(f'T_{k} {v:.2f}' for k, v in self.times.items())

    def reset(self) -> None:
        self.times.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None, name: str = 'phase'):
    """torch.profiler trace around a hot phase, written as a Chrome trace
    to log_dir/<name>.json (a no-op when log_dir is None). Yields the
    profiler (None when off) for reading its key_averages()."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f'{name}.json'))
