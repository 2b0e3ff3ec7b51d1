"""Per-phase wall-clock profiling and device traces (port of
ipdm_tpu/utils/profiling.py ``PhaseTimer`` and ``device_trace``).

Named wall-clock phases with running total and count, a ``phase(...)``
context manager, and a one-line report. The engine times the proj-stage +
convert and img-stage segments of every slice with it, and the host-side
metric and saving phases. CUDA launches are asynchronous, so a phase that
launched work on the card ends with ``torch.cuda.synchronize()``: its time
is the work's, not the launch's. :func:`device_trace` records a
``torch.profiler`` trace of a block.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @staticmethod
    def sync() -> None:
        """The fence at a phase's two ends: wait for the card."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        parts = []
        for k in sorted(self.totals):
            c = max(self.counts[k], 1)
            parts.append(f"{k}: {self.totals[k]:.2f}s"
                         f" ({self.totals[k]/c*1000:.0f}ms x{c})")
        return " | ".join(parts)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block (the host and, where CUDA is
    available, the card) → a Chrome trace in ``log_dir`` (TensorBoard's
    profile plugin reads it). No-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
