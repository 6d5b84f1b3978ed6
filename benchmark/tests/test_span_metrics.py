"""The readers of the program's phase spans (`phases.py`) on a hand-built
chrome trace: two steps on the main thread, one with the FD update and one
gradient-only with an exchange; runtime calls joined to their device
operations by correlation id, one issued from a second thread during
`psgd_grad` as autograd's device thread does; a launch outside every
phase. Each reader's value against the hand-computed one, and None where
its span is absent."""
import json

import pytest

from benchmark import harness, spec
from benchmark.trace import Trace

MAIN, AUTOGRAD, STREAM = 1, 2, 7

# (name, start, end) of the main thread's ranges, in trace microseconds
RANGES = [
    ("bench.window", 0, 1000),
    ("bench.step", 10, 410), ("bench.step", 500, 900),
    # step 1: gradient, FD Hvp, Q update, apply
    ("psgd_step", 20, 400),
    ("bench.span.curvature", 28, 302),
    ("psgd_grad", 30, 150), ("psgd_forward", 35, 80),
    ("psgd_hvp", 160, 300), ("psgd_forward", 170, 210),
    ("psgd_q_update", 310, 340), ("psgd_apply", 350, 370),
    # step 2: gradient only, the data mean, apply
    ("psgd_step", 510, 800),
    ("bench.span.curvature", 518, 652),
    ("psgd_grad", 520, 650), ("psgd_forward", 525, 560),
    ("psgd_exchange", 660, 690), ("psgd_apply", 700, 720),
]

# (launch time, launching thread, device category, device name, device us);
# each operation starts 4 us after its launch and ends before the next one
LAUNCHES = [
    (40, MAIN, "kernel", "fwd_gemm", 40),           # forward
    (100, AUTOGRAD, "kernel", "bwd_gemm", 20),      # backward, from autograd's thread
    (175, MAIN, "kernel", "fwd_gemm", 30),          # forward at theta + delta v
    (250, AUTOGRAD, "kernel", "bwd_add", 24),       # backward
    (290, MAIN, "kernel", "fd_diff", 6),            # the FD difference
    (320, MAIN, "kernel", "kron_update", 3),        # Q update
    (360, MAIN, "kernel", "kron_apply", 2),         # apply
    (380, MAIN, "gpu_memset", "Memset", 1),         # tail
    (530, MAIN, "kernel", "fwd_gemm", 10),          # forward
    (600, AUTOGRAD, "kernel", "bwd_gemm", 20),      # backward
    (670, MAIN, "kernel", "ncclAllReduce", 5),      # exchange
    (710, MAIN, "kernel", "kron_apply", 2),         # apply
    (750, MAIN, "gpu_memcpy", "Memcpy DtoD", 4),    # tail
    (850, MAIN, "kernel", "after_step", 7),         # inside bench.step, outside psgd_step
]


def _events(ranges, launches, orphan=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": e - s, "tid": MAIN,
           "pid": 0} for n, s, e in ranges]
    for corr, (ts, tid, cat, name, us) in enumerate(launches, start=1):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 3, "tid": tid, "pid": 0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts + 4, "dur": us, "tid": STREAM,
                   "pid": 1, "args": {"correlation": corr}})
    if orphan:  # a device operation with no runtime call in the window
        ev.append({"ph": "X", "cat": "kernel", "name": "orphan", "ts": 950, "dur": 9,
                   "tid": STREAM, "pid": 1, "args": {"correlation": 999}})
    return ev


def _reading(tmp_path, ranges, launches=LAUNCHES):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events(ranges, launches)}))
    tr = Trace(str(path))
    return harness.Reading(tr, tr, 0, None, None)


def _read(name, r):
    return spec.reader(name).read(r)


EXPECTED = {  # two steps: device us / 1e3 / 2
    "forward_dev_ms": (40 + 30 + 10) / 2e3,
    "backward_dev_ms": (20 + 24 + 6 + 20) / 2e3,
    "step_tail_dev_ms": (1 + 4) / 2e3,
    "step_launches": 13 / 2,
    "data_exchange_dev_ms": 5 / 2e3,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value(tmp_path, name):
    assert _read(name, _reading(tmp_path, RANGES)) == pytest.approx(EXPECTED[name], rel=1e-12)


def test_forward_and_backward_make_the_curvature_span(tmp_path):
    r = _reading(tmp_path, RANGES)
    both = _read("forward_dev_ms", r) + _read("backward_dev_ms", r)
    assert both == pytest.approx(_read("curvature_dev_ms", r), rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_none_without_the_programs_spans(tmp_path, name):
    bench_only = [x for x in RANGES if not x[0].startswith("psgd_")]
    assert _read(name, _reading(tmp_path, bench_only)) is None


def test_exchange_is_none_on_a_step_without_one(tmp_path):
    r = _reading(tmp_path, [x for x in RANGES if x[0] != "psgd_exchange"])
    assert _read("data_exchange_dev_ms", r) is None
    assert _read("step_launches", r) == EXPECTED["step_launches"]
    # the exchange's launch now falls in the tail
    assert _read("step_tail_dev_ms", r) == pytest.approx((1 + 4 + 5) / 2e3, rel=1e-12)


def test_backward_is_none_without_forward_spans(tmp_path):
    r = _reading(tmp_path, [x for x in RANGES if x[0] != "psgd_forward"])
    assert _read("backward_dev_ms", r) is None and _read("forward_dev_ms", r) is None


def test_spans_of_another_thread_are_not_phases(tmp_path):
    path = tmp_path / "trace.json"
    ev = _events([x for x in RANGES if not x[0].startswith("psgd_")], LAUNCHES)
    ev += [dict(e, tid=AUTOGRAD) for e in _events([x for x in RANGES
                                                    if x[0].startswith("psgd_")], [], False)]
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace(str(path))
    r = harness.Reading(tr, tr, 0, None, None)
    assert all(_read(name, r) is None for name in EXPECTED)


def test_idle_gaps_name_the_phases(tmp_path):
    gaps = dict(_reading(tmp_path, RANGES).trace.idle_gaps())
    assert {"psgd_grad", "psgd_hvp", "psgd_forward"} <= set(gaps)
