"""`BENCHMARK.json` and the files it names, found by name.

A configuration's file names its `model` (`models/<model>.py`, the
model's sizes, weights, inputs and FLOPs) and its optimizer's
`preconditioner` (`families/<family>.py`, the program's options, spans and
least work of that family; `reference/<family>.py`, its plain reference).
A cell's traffic is `traffic/<traffic>.json` and its limits
`limits/<cell>.json`. A name with no file raises.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_LOADED: dict = {}


def part(kind: str, name: str, root: Path = ROOT):
    """The module of `benchmark/<kind>/<name>.py` under `root`."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise ValueError(f"no file benchmark/{kind}/{name}.py for {name!r}")
        spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    root: Path = ROOT     # the checkout the files came from

    @property
    def model(self):
        return part("models", self.config["model"], self.root)

    @property
    def family(self):
        return part("families", self.config["optimizer"]["preconditioner"], self.root)

    @property
    def reference_family(self):
        return part("reference", self.config["optimizer"]["preconditioner"], self.root)

    @property
    def mesh(self) -> dict | None:
        return self.traffic.get("mesh")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell called `name`; raises KeyError for a name the file lacks."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "benchmark"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
    )


def reader(metric: str, root: Path = ROOT):
    """The module of `metrics/<metric>.py`."""
    return part("metrics", metric, root)
