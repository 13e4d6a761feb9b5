"""Profiling on the CPU: ``trace(logdir)`` writes a Chrome trace of the
enclosed work, and ``StepTimer`` on the host clock reports what the JAX
package's ``StepTimer`` reports for the same clock readings (exactly: both
scale the same durations by 1e3)."""

import itertools
import json
import time

import numpy as np
import torch

from easy_gaussian_splatting_tpu.utils import profiling as jprof
from easy_gaussian_splatting_torch.utils import profiling as tprof


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "profile") as window:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert window.path == tmp_path / "profile" / "trace.json"
    events = json.loads(window.path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)


def test_step_timer_matches_jax(monkeypatch):
    readings = np.cumsum(np.random.default_rng(0).uniform(0.01, 0.05, size=12)).tolist()
    summaries = []
    for timer in (jprof.StepTimer(), tprof.StepTimer("cpu")):
        clock = itertools.chain(readings)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        for _ in range(6):
            timer.start()
            timer.stop()
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1] and summaries[1]["steps"] == 6.0
    assert tprof.StepTimer("cpu").summary() == {}
