"""Profiling and step-metric observability (port of
``case_rg_tpu/runtime/profiling.py``).

* ``trace(logdir)`` — context manager around a ``torch.profiler`` session
  (CPU and, where there is a card, CUDA activities) that writes a Chrome
  trace (``<host>_<pid>.<ns>.pt.trace.json``) under ``logdir``, readable by
  TensorBoard's profiler plugin, Perfetto or ``chrome://tracing``; the
  training loop marks each epoch, checkpoint and dev evaluation in it
  (``train_epoch E``, ``checkpoint E``, ``dev_eval E``);
* ``StepMeter`` — host-side throughput/latency meter with EMA smoothing;
* ``MetricsLogger`` — JSONL per-step metric log (loss components, lr,
  step time), cheap enough to leave on.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StepMeter:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_s: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self) -> float:
        dt = time.time() - self._t0
        self.avg_s = dt if self.avg_s is None else (
            self.ema * self.avg_s + (1 - self.ema) * dt)
        return dt

    def steps_per_sec(self) -> float:
        return 1.0 / self.avg_s if self.avg_s else 0.0


class MetricsLogger:
    def __init__(self, path: Optional[str]):
        self.f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.f = open(path, "a", buffering=1)

    def log(self, step: int, metrics: Dict[str, float]):
        if self.f is None:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.f.write(json.dumps(rec) + "\n")

    def close(self):
        if self.f:
            self.f.close()
            self.f = None
