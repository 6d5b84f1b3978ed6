"""Profiling helpers: named scopes on the hot phases and trace capture.

Counterpart of `psgd_tf_tpu/utils/profiling.py`. `scope(name)` labels a
region for `torch.profiler` (`record_function`) and, on a CUDA machine, for
NVTX; `trace(log_dir)` records the enclosed region with `torch.profiler`
(CPU, and CUDA activity where a card is present) and writes a Chrome trace
into `log_dir`; `wall_timer` reports a region's host wall clock.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """A named region: a `torch.profiler` record and an NVTX range. Also
    usable as a decorator."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and export it as
    `<log_dir>/<pid>.<ns>.pt.trace.json`; yields the profiler, whose
    `key_averages()` the caller may read after the region."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def wall_timer(label: str, sink=print) -> Iterator[None]:
    """Host wall clock of a region. It waits for nothing itself: call
    `torch.cuda.synchronize()` at both ends for device time."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {time.perf_counter() - t0:.4f}s")
