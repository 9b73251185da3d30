"""Tracing and per-stage timing.

Mirrors gpr_tpu/utils/profiling.py:1-80.  The reference times every
pipeline stage with std::chrono and writes per-frame latency text files
(reference apps/GaussianProcessLearn.cpp:104-162):

  * :class:`StageTimer`: named stages, CSV dump in the reference's
    trailing-comma single-line format (a copy of JAX's);
  * :func:`trace`: a ``torch.profiler`` scope writing a Chrome trace
    (``trace.json``, host and CUDA activity) into ``log_dir``, where JAX
    writes a ``jax.profiler`` TensorBoard directory;
  * :func:`device_memory_stats`: live, peak and total bytes per CUDA device
    from ``torch.cuda.memory_stats`` under JAX's keys; ``{}`` where there is
    no CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch


class StageTimer:
    """Wall-clock per named stage; ``csv()`` matches the reference's
    trailing-comma latency files (apps/GaussianProcessPredict.cpp:96-105)."""

    def __init__(self) -> None:
        self.stages: List[tuple] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out

    def csv(self) -> str:
        return "".join(f"{dt}," for _, dt in self.stages)

    def write(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(self.csv())


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` scope (host and, where there is a card, CUDA
    activity); on exit the Chrome trace ``log_dir/trace.json``, readable by
    chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict]:
    """Per-device live / peak / total bytes (profiling.py:64-80's keys)."""
    out: Dict[str, Dict] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
