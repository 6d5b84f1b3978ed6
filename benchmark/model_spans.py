"""The model's own spans in a traced window, on every thread.

The program opens `model_mamba` around each Mamba-2 mixer and `model_ssd`
around each scan (`psgd_tf_tpu_torch/models/granite_hybrid.py`,
`ops/ssd.py`): in the forward on the step's thread, and in the backward
on the thread that autograd runs it on, which launches the backward's
work. A device operation belongs to a span when its launch (its runtime
call, joined by correlation id) lies inside a range of that name on the
launching thread. A program without the spans has none, and every read
is None.
"""
from __future__ import annotations

import bisect


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class ModelSpans:
    """The ranges called `name` in one `trace.Trace`, and what they launched."""

    def __init__(self, trace, name: str):
        self.steps = trace.steps
        ranges: dict = {}
        for e in trace.host:
            if e.get("cat") == "user_annotation" and e["name"] == name:
                ranges.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e["dur"]))
        self.forward_calls = len(ranges.get(trace.main_tid, []))
        self.backward_calls = sum(len(v) for tid, v in ranges.items() if tid != trace.main_tid)
        spans = {tid: _merge(v) for tid, v in ranges.items()}
        launch = {}
        for e in trace.runtime:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["ts"], e.get("tid"))
        self.ops = []  # device us of each operation launched inside a range
        for e in trace.device:
            ts_tid = launch.get((e.get("args") or {}).get("correlation"))
            if ts_tid is None or ts_tid[1] not in spans:
                continue
            s = spans[ts_tid[1]]
            i = bisect.bisect_right(s, [ts_tid[0], float("inf")]) - 1
            if i >= 0 and s[i][0] <= ts_tid[0] <= s[i][1]:
                self.ops.append(e["dur"])

    @property
    def found(self) -> bool:
        return bool(self.steps) and self.forward_calls + self.backward_calls > 0

    def device_ms(self) -> float | None:
        """Device ms a step launched inside the ranges."""
        return sum(self.ops) / 1e3 / self.steps if self.found else None

    def launches(self) -> float | None:
        """Device operations a step launched inside the ranges."""
        return len(self.ops) / self.steps if self.found else None
