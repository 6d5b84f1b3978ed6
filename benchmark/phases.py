"""The program's own phase spans in a traced window, and the device work
launched inside them.

When a profiler runs, the port labels its training step's phases with
`record_function` ranges (`psgd_tf_tpu_torch/utils/profiling.scope`):
`psgd_step`, `psgd_forward`, `psgd_grad`, `psgd_hvp`, `psgd_exchange`,
`psgd_q_update` and `psgd_apply`. `Phases` takes each name's ranges on the
window's main thread, merged into intervals, and puts a device operation
down to a phase when its launch (its runtime call, joined by correlation
id) falls inside one: the rule of `Trace.launched_in`, so the backward's
launches from autograd's device thread fall in the phase whose call waits
on them. A program without these spans has none, and every read is None.
"""
from __future__ import annotations

import bisect

NAMES = ("psgd_step",  # the whole step first, then its phases
         "psgd_forward", "psgd_grad", "psgd_hvp", "psgd_exchange",
         "psgd_q_update", "psgd_apply")


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Phases:
    """The phases of one `trace.Trace`."""

    def __init__(self, trace):
        self.steps = trace.steps
        spans: dict[str, list] = {}
        for e in trace.host:
            if (e.get("cat") == "user_annotation" and e["name"] in NAMES
                    and (trace.main_tid is None or e.get("tid") == trace.main_tid)):
                spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        self.spans = {k: _merge(v) for k, v in spans.items()}
        launch = {}
        for e in trace.runtime:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = e["ts"]
        # (launch time, device us) of every device operation whose launch is known
        self.ops = [(launch[c], e["dur"]) for e in trace.device
                    if (c := (e.get("args") or {}).get("correlation")) in launch]

    def has(self, *names: str) -> bool:
        """Whether the window holds a span of any of `names`."""
        return any(self.spans.get(n) for n in names)

    def _in(self, ts: float, name: str) -> bool:
        spans = self.spans.get(name)
        if not spans:
            return False
        i = bisect.bisect_right(spans, [ts, float("inf")]) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    def launched(self, inside, outside=()):
        """Device us of each operation launched inside a span of any name in
        `inside` and inside none of `outside`."""
        return [us for ts, us in self.ops
                if any(self._in(ts, n) for n in inside)
                and not any(self._in(ts, n) for n in outside)]

    def per_step(self, value: float) -> float | None:
        return value / self.steps if self.steps else None

    def device_ms(self, inside, outside=()) -> float | None:
        """Device ms a step launched inside `inside` and outside `outside`,
        or None where the window has no span of `inside` or no step."""
        if not self.has(*inside):
            return None
        return self.per_step(sum(self.launched(inside, outside)) / 1e3)
