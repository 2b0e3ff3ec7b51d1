"""The port's profiling helpers (ipdm_tpu_torch/utils/profiling.py):
``device_trace`` as torch.profiler (JAX utils/profiling.py:66-79) and
``PhaseTimer``."""

import json
import os

import torch

from ipdm_tpu.utils import profiling as jax_profiling
from ipdm_tpu_torch.utils.profiling import PhaseTimer, device_trace


def test_device_trace_writes_a_trace_of_the_block(tmp_path):
    with device_trace(str(tmp_path)):
        y = (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert float(y) == 64.0 ** 3
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_device_trace_is_a_no_op_without_a_directory(tmp_path):
    for log_dir in (None, ""):
        with device_trace(log_dir), jax_profiling.device_trace(log_dir):
            torch.zeros(3).sum()
    assert os.listdir(tmp_path) == []


def test_phase_timer_counts_and_reports():
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            pass
    assert timer.counts["a"] == 2 and timer.totals["a"] >= 0.0
    assert timer.report().startswith("a: ")
    timer.reset()
    assert not timer.totals and not timer.counts
