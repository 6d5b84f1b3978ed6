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

A model's own parts add theirs (`models/granite_hybrid.py`: `model_mamba`
around each Mamba-2 mixer, `ops/ssd.py`: `model_ssd` around its scan).
`region(name, fn, x, ...)` runs `fn` inside `scope(name)` and, while a
profiler records, puts the backward pass's part of `fn` in a `scope(name)`
too: autograd runs a backward on a thread of its own, so that span lies on
the thread that launches the backward's work, from where the gradient
enters `fn`'s output to where it leaves through `x`.

The first span entered imports `torch._inductor`, as a first `torch.func`
call does (`_load_compiler`): `torch.profiler` imports it on its first
start, which would otherwise spend seconds inside the profiled run.
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
_compiler_loaded = False


def _load_compiler():
    """Import `torch._inductor` (and with it `torch._dynamo`) once.
    `torch.profiler`'s start asks `hasattr(torch, "_inductor")`, which
    runs torch's lazy import of it: about 8 s on the H100's host. Paid
    here, at the training's first span, a profiler started later starts
    at once, and the ranks of a mesh start theirs together."""
    global _compiler_loaded
    import torch._inductor  # noqa: F401

    _compiler_loaded = True


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
        if not _compiler_loaded:
            _load_compiler()
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


class _Region:
    """The open backward span of one call of `region`."""

    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name, self.span = name, None


class _Edge(torch.autograd.Function):
    """The identity. Its backward opens the region's span where the
    gradient enters the region (`at_output`) and closes it where the
    gradient leaves; the tangent passes through unchanged."""

    @staticmethod
    def forward(x, region, at_output):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.region, ctx.at_output = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        r = ctx.region
        if ctx.at_output:
            r.span = scope(r.name)
            r.span.__enter__()
        elif r.span is not None:
            r.span.__exit__(None, None, None)
            r.span = None
        return g, None, None

    @staticmethod
    def jvp(ctx, gx, *_):
        return gx


def region(name: str, fn, x: torch.Tensor, *args):
    """`fn(x, *args)` inside `scope(name)`; while a profiler records, also
    its backward, from the output's gradient to `x`'s (the module's
    docstring). `fn` returns one tensor."""
    with scope(name):
        if not _profiler_enabled():
            return fn(x, *args)
        r = _Region(name)
        return _Edge.apply(fn(_Edge.apply(x, r, False), *args), r, True)


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
