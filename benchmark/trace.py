"""Spans from the benchmark's own files, and the reading of a profiler trace.

In a traced run only, `Spans` wraps the module attributes that the step
looks up at call time, each call in a `record_function` range named
`bench.span.<layer>`: the curvature (`hvp.finite_diff`, `hvp.grad_only`)
and the preconditioner (the family's `span_targets()`, e.g.
`kron.update_multi` and `kron.apply`, or `lra.update_apply` and
`lra.apply` on the module the optimizer holds in
`optim.psgd._FLAT_FAMILIES`). A name the program no longer has is skipped,
and the metrics that read its layer read nothing.

`Trace` reads the chrome trace that `torch.profiler` exports: the window
(`bench.window`, or in a trace of the card alone the first launch to the
last operation's end), the steps (`bench.step`), the spans, every device
operation (kernels, copies, fills) and the host's runtime calls, joined to
the device operations they launched by their correlation ids.
"""
from __future__ import annotations

import bisect
import gzip
import json

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")


def curvature_targets():
    from psgd_tf_tpu_torch import hvp
    return [(hvp, "finite_diff"), (hvp, "grad_only")]


def _targets(fn):
    try:
        return fn()
    except (ImportError, AttributeError):
        return []


class Spans:
    """Install the wrappers on entry, restore the originals on exit; counts
    the calls of each wrapped function. `family` is the cell's
    `families/<family>.py`."""

    def __init__(self, family):
        self.layers = {"curvature": curvature_targets, "precond": family.span_targets}
        self.calls: dict[str, int] = {}
        self._saved = []

    def __enter__(self):
        from torch.profiler import record_function

        for layer, targets in self.layers.items():
            for mod, attr in _targets(targets):
                fn = getattr(mod, attr, None) if mod is not None else None
                if fn is None:
                    continue
                key = f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}"
                self.calls[key] = 0

                def wrapped(*a, _fn=fn, _key=key, _span=f"bench.span.{layer}", **k):
                    self.calls[_key] += 1
                    with record_function(_span):
                        return _fn(*a, **k)

                self._saved.append((mod, attr, fn))
                setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


def _merge(intervals):
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """One rank's traced window. Times are the trace's microseconds."""

    def __init__(self, path: str):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        events = [e for e in events if e.get("ph") == "X" and "ts" in e]
        for e in events:
            e["ts"] = float(e["ts"])
            e["dur"] = float(e.get("dur", 0.0))
        ann = [e for e in events if e.get("cat") == "user_annotation"]
        window = [e for e in ann if e["name"] == "bench.window"]
        runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        if window:
            w = window[0]
            self.start, self.end = w["ts"], w["ts"] + w["dur"]
            self.main_tid = w.get("tid")
        elif runtime:
            # a trace of the card alone: from the first launch to the last
            # call's or device operation's end
            ends = [e["ts"] + e["dur"] for e in events if e.get("cat") in _DEVICE_CATS] + [
                e["ts"] + e["dur"] for e in runtime]
            self.start, self.end = min(e["ts"] for e in runtime), max(ends)
            self.main_tid = None
        else:
            raise ValueError("the trace holds no bench.window range and no runtime call")
        inside = lambda e: self.start <= e["ts"] <= self.end
        self.steps = sum(1 for e in ann if e["name"] == "bench.step" and inside(e))
        self.spans = {}
        for e in ann:
            if e["name"].startswith("bench.span.") and inside(e):
                self.spans.setdefault(e["name"][len("bench.span."):], []).append(
                    (e["ts"], e["ts"] + e["dur"]))
        for k in self.spans:
            self.spans[k] = _merge(sorted(self.spans[k]))
        self.device = [e for e in events if e.get("cat") in _DEVICE_CATS
                       and e["ts"] < self.end and e["ts"] + e["dur"] > self.start]
        self.runtime = [e for e in runtime if inside(e)]
        launch_ts = {}
        for e in self.runtime:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
        self._launch = launch_ts
        self.host = [e for e in events if e.get("cat") in _HOST_CATS and inside(e)]

    # -------------------------------------------------------------- reads

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def _clipped(self):
        return [(max(e["ts"], self.start), min(e["ts"] + e["dur"], self.end)) for e in self.device]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(e - s for s, e in _merge(sorted(self._clipped()))) / 1e6

    def launched_in(self, e, layer: str) -> bool:
        """Whether device operation `e` was launched inside a span of `layer`."""
        ts = self._launch.get((e.get("args") or {}).get("correlation"))
        spans = self.spans.get(layer)
        if ts is None or not spans:
            return False
        i = bisect.bisect_right(spans, [ts, float("inf")]) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    def device_ms(self, layer: str) -> float | None:
        """Device ms of the operations launched inside `layer`'s spans, or
        None where the window has no such span."""
        if not self.spans.get(layer):
            return None
        return sum(e["dur"] for e in self.device if self.launched_in(e, layer)) / 1e3

    def device_ms_named(self, *needles: str) -> float:
        """Device ms of the operations whose name holds any needle (any case)."""
        needles = [n.lower() for n in needles]
        return sum(e["dur"] for e in self.device
                   if any(n in e["name"].lower() for n in needles)) / 1e3

    def top_device_ops(self, k: int = 10):
        tot: dict[str, float] = {}
        for e in self.device:
            tot[e["name"][:120]] = tot.get(e["name"][:120], 0.0) + e["dur"] / 1e6
        return sorted(tot.items(), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Idle device time by what the host's main thread was doing when
        each gap began (its innermost range), the largest k."""
        busy = _merge(sorted(self._clipped()))
        gaps, at = [], self.start
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.end:
            gaps.append((at, self.end))
        host = sorted((e for e in self.host if e.get("tid") == self.main_tid),
                      key=lambda e: (e["ts"], -e["dur"]))
        tot: dict[str, float] = {}
        stack, j = [], 0
        for s, e in gaps:
            while j < len(host) and host[j]["ts"] <= s:
                stack.append(host[j])
                j += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < s:
                stack.pop()
            inner = [h for h in stack if h["ts"] + h["dur"] >= s]
            name = inner[-1]["name"][:120] if inner else "(no host range)"
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        return sorted(tot.items(), key=lambda x: -x[1])[:k]
