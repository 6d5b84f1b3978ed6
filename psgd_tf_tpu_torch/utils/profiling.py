"""Profiling helpers: named spans on the step's phases, and trace capture.

Counterpart of `psgd_tf_tpu/utils/profiling.py`. `scope(name)` labels a
region as an NVTX range (on a CUDA build of PyTorch, for Nsight Systems)
and, while a `torch.profiler` is recording, as a `record_function` range;
with no profiler it costs a flag check and, on a CUDA build, the NVTX push
and pop. `trace(log_dir)` records the enclosed region with `torch.profiler`
(CPU, and CUDA activity where a card is present) and writes a Chrome trace
into `log_dir`, where the spans lie on the same clock as the device's
operations.

The training step's spans (`optim/psgd.py`, `hvp.py`, `parallel/step.py`):
`psgd_step` (the whole step), `psgd_forward` (each forward pass of the
model), `psgd_grad` (the gradient at theta), `psgd_hvp` (the Hvp: the FD
perturbation, second gradient and difference, or the whole exact pass),
`psgd_exchange` (the step's collectives outside the preconditioner's
kernels), `psgd_q_update` (the Q update, with the apply where one sweep
does both) and `psgd_apply` (P g).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

# decided once: NVTX ships with every CUDA build and needs no device
_NVTX = torch.version.cuda is not None
_profiler_enabled = torch._C._autograd._profiler_enabled


class scope(contextlib.ContextDecorator):
    """A named region: an NVTX range, and a `torch.profiler` record while a
    profiler is active. Also usable as a decorator."""

    __slots__ = ("name", "_record")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def _recreate_cm(self):
        return scope(self.name)  # a decorated call gets its own, so calls may nest

    def __enter__(self):
        if _NVTX:
            torch.cuda.nvtx.range_push(self.name)
        if _profiler_enabled():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()

    def __exit__(self, *exc):
        if self._record is not None:
            record, self._record = self._record, None
            record.__exit__(*exc)
        if _NVTX:
            torch.cuda.nvtx.range_pop()
        return False


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
