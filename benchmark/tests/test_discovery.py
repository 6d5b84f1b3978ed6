"""A new configuration, cell, traffic mix and per-layer metric are found by
name, with no code edited: only BENCHMARK.json's entries and files are
added. A family or model with no file of its own raises."""
import json
import shutil

import pytest

from benchmark import harness, spec
from benchmark.tests import tiny


@pytest.fixture
def root(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    here = tmp_path / "benchmark"
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a new configuration: the lra one at rank 4
    conf = json.loads((here / "configs" / "nmt_ref_lra.json").read_text())
    conf["optimizer"]["rank"] = 4
    (here / "configs" / "nmt_ref_lra_r4.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "nmt_ref_lra_r4", "source": conf["source"],
                             "file": "benchmark/configs/nmt_ref_lra_r4.json", "reduced": [],
                             "why": "rank 4"})
    bench["workloads"] += [
        {"name": "nmt_lra.tok63k", "config": "nmt_ref_lra", "traffic": "tok63k", "chips": 1,
         "why": "half the batch"},
        {"name": "nmt_lra_r4.tok127k", "config": "nmt_ref_lra_r4", "traffic": "tok127k",
         "chips": 1, "why": "rank 4"}]
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_span", "layer": "step dispatch",
                               "moves": "train_tokens_per_s", "workloads": ["nmt_lra.tok63k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((here / "traffic" / "tok127k.json").read_text())
    traffic.update(batch=2048)
    (here / "traffic" / "tok63k.json").write_text(json.dumps(traffic))
    for cell in ("nmt_lra.tok63k", "nmt_lra_r4.tok127k"):
        shutil.copy(here / "limits" / "nmt_lra.tok127k.json", here / "limits" / f"{cell}.json")
    (here / "metrics" / "steps_traced.py").write_text("def read(r):\n    return float(r.trace.steps)\n")
    return tmp_path


def _tiny(cell):
    cell.config.update(tiny.TINY_MODEL)
    cell.traffic.update(batch=4, src_len=5, tgt_len=4, trace_steps=2)
    return cell


def test_a_new_cell_is_found_by_name(root):
    cell = spec.load("nmt_lra.tok63k", root)
    assert cell.traffic["batch"] == 2048 and cell.config["optimizer"]["preconditioner"] == "lra"
    assert [m["name"] for m in cell.per_layer][-1] == "steps_traced"
    assert "exchange_dev_ms" not in [m["name"] for m in cell.per_layer]
    with pytest.raises(KeyError):
        spec.load("nmt_lra.nowhere", root)


def test_a_new_cell_runs_with_its_new_metric(root):
    cell = _tiny(spec.load("nmt_lra.tok63k", root))
    res = harness.measure(cell, 31337, 0.1, True, 0.0, device="cpu")
    assert res["correct"]
    assert res["metrics"]["steps_traced"]["value"] == 2.0


def test_a_new_configuration_runs(root):
    cell = _tiny(spec.load("nmt_lra_r4.tok127k", root))
    assert cell.config["optimizer"]["rank"] == 4
    res = harness.measure(cell, 2**31 + 99, 0.1, False, 0.0, device="cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_parts_are_the_files_under_the_root(root):
    (root / "benchmark" / "families" / "lra.py").write_text(
        (spec.HERE / "families" / "lra.py").read_text() + "\nFOUND_UNDER_ROOT = True\n")
    cell = spec.load("nmt_lra.tok63k", root)
    assert cell.family.FOUND_UNDER_ROOT
    assert cell.model.tokens_per_step(cell.traffic) == 2048 * (18 + 13)


@pytest.mark.parametrize("key,value,missing", [("preconditioner", "splu", "families/splu.py"),
                                               ("model", "lenet5", "models/lenet5.py")])
def test_a_family_or_model_without_a_file_raises(root, key, value, missing):
    cell = spec.load("nmt_lra_r4.tok127k", root)
    if key == "model":
        cell.config["model"] = value
    else:
        cell.config["optimizer"]["preconditioner"] = value
    with pytest.raises(ValueError, match=missing):
        harness.measure(_tiny(cell), 7, 0.1, False, 0.0, device="cpu")
