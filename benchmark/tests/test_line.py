"""The last line's schema, and the checks printed last on stderr."""
import json

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.parametrize("traced", [False, True])
def test_last_line(traced, capsys):
    cell = tiny.cell("nmt_kron.tok127k")
    harness.emit(harness.measure(cell, 2**32 + 17, 0.2, traced, 0.0, device="cpu"))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    names = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == names
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), tail):
        assert text == f"check {name} {c['value']!r} limit {c['limit']!r}"
