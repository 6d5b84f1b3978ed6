"""Structured per-step metrics with pluggable sinks.

Counterpart of `psgd_tf_tpu/utils/metrics.py`. `tree_norm` and
`finite_fraction` reduce a tree (`utils._tree`) to a 0-d tensor on the
device. The sinks (stdout or file JSONL, an in-memory history, any
callable) take host floats; `Reporter` reads the device scalars only on the
steps it reports, so the other steps queue without a host sync.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Callable, Iterable, Mapping

import torch

from psgd_tf_tpu_torch.utils import _tree

Scalars = Mapping[str, torch.Tensor]
Sink = Callable[[int, Mapping[str, float]], None]


def tree_norm(tree: Any) -> torch.Tensor:
    """The 2-norm of all tensor leaves together."""
    return torch.sqrt(sum(torch.sum(leaf * leaf) for leaf in _tree.tensors(tree)))


def finite_fraction(tree: Any) -> torch.Tensor:
    """The share of finite entries over all tensor leaves."""
    leaves = _tree.tensors(tree)
    total = sum(leaf.numel() for leaf in leaves)
    finite = sum(torch.sum(torch.isfinite(leaf)) for leaf in leaves)
    return finite / total


class JsonlSink:
    """One JSON object per line to a stream or path."""

    def __init__(self, path: str | None = None):
        self._f = open(path, "a") if path else sys.stdout
        self._owns = path is not None

    def __call__(self, step: int, scalars: Mapping[str, float]) -> None:
        self._f.write(json.dumps({"step": step, "t": time.time(), **scalars}) + "\n")
        self._f.flush()

    def close(self):
        if self._owns:
            self._f.close()


class History:
    """In-memory sink for tests/notebooks: history.rows -> list of dicts."""

    def __init__(self):
        self.rows: list[dict] = []

    def __call__(self, step: int, scalars: Mapping[str, float]) -> None:
        self.rows.append({"step": step, **scalars})


class Reporter:
    """Fans device scalars out to sinks every `every` steps; only a report
    step reads them on the host."""

    def __init__(self, sinks: Iterable[Sink] = (), every: int = 1):
        self.sinks = list(sinks)
        self.every = max(1, every)

    def push(self, step: int, scalars: Scalars) -> None:
        if step % self.every:
            return
        host = {k: float(v) for k, v in scalars.items()}
        for sink in self.sinks:
            sink(step, host)
