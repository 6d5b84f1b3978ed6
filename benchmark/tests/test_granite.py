"""The Granite-4.0-H configuration and its cell: the adapter's sizes,
formats, FLOPs and the scan's work; the four readers of the model's spans
on a hand-built trace; the cell's traffic file; and whole runs of a tiny
copy of `granite_h_kron.seq2k` on the CPU, sound and broken."""
import copy
import json
import math

import pytest
import torch

from benchmark import harness, spec, work
from benchmark.reference import kron as ref_kron
from benchmark.trace import Trace
from benchmark.tests.test_faults import half_batch, state_unchanged

CELL = "granite_h_kron.seq2k"
# every width shrunk; the layer pattern, the multipliers and the traffic's shape kept.
# A vocabulary above 1,024 gives the embedding a (scale, dense) pair.
TINY = {"vocab_size": 1500, "hidden_size": 64, "intermediate_size": 128,
        "shared_intermediate_size": 128, "mamba_n_heads": 4, "mamba_d_head": 32,
        "mamba_d_state": 16, "mamba_chunk_size": 8, "num_attention_heads": 4,
        "num_key_value_heads": 2}


def tiny_cell(name=CELL) -> spec.Cell:
    c = copy.deepcopy(spec.load(name))
    c.config.update(TINY)
    c.traffic.update(batch=2, seq_len=19, trace_steps=2)
    return c


@pytest.fixture
def cell():
    return spec.load(CELL)


def test_published_sizes(cell):
    m, cfg = cell.model, cell.config
    shapes = m.shapes(cfg)
    assert len(shapes) == 118 and m.parameter_count(cfg) == 951_991_232
    assert m.layer_types(cfg) == ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
    assert shapes[:3] == [(100352, 2048), (2048, 1), (2048, 8512)]
    assert m.tokens_per_step(cell.traffic) == 4096


def test_formats_are_reference_pairs(cell):
    fmts = cell.model.formats(cell.config)
    assert all(tuple(f) in ref_kron._PAIRS for f in fmts)
    counts = {f: fmts.count(f) for f in set(fmts)}
    assert counts == {("norm", "scale"): 41, ("scale", "dense"): 50, ("dense", "dense"): 27}


def test_forward_flops_against_a_hand_count(cell):
    mlp = 2 * 2048 * 16384 + 2 * 8192 * 2048
    mamba = 2 * 2048 * 8512 + 2 * 4096 * 2048 + 4 * 64 * 128 * 64 + mlp
    attention = 2 * 2048 * 2048 * 2 + 2 * 2048 * 512 * 2 + 2 * 2 * 2048 * 2049 / 2 + mlp
    per_seq = 2048 * (9 * mamba + attention) + 2047 * 2 * 2048 * 100352
    fwd = cell.model.forward_flops(cell.config, cell.traffic)
    assert fwd == pytest.approx(2 * per_seq, rel=1e-12)
    assert fwd / 4096 == pytest.approx(1.93e9, rel=2e-3)
    assert 6 * fwd == pytest.approx(47.4e12, rel=2e-3)


def test_scan_work(cell):
    (fb, ff), (bb, bf) = cell.model.ssd_work(cell.config, cell.traffic)
    tokens = 4096
    assert fb == bb == 4 * (tokens * (2 * 4096 + 2 * 128 + 64) + 64)
    assert ff == 4 * 64 * 128 * 64 * tokens and bf == 2 * ff
    # operation-bound: 8.6 GFLOP against 138 MB a call
    assert work.bound_by(fb, ff) == "operations"
    assert cell.model.ssd_bound_ms(cell.config, cell.traffic, 2, 1) == pytest.approx(
        (2 * ff + bf) / 67e12 * 1e3)


def test_new_traffic_loads():
    c = spec.load(CELL)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    assert {w["name"]: w["traffic"] for w in bench["workloads"]}[CELL] == "seq2k"
    assert c.chips == 1 and c.mesh is None and c.traffic["update_probability"] == 1.0
    assert set(c.limits) >= {"loss_gap", "grad_gap", "change_gap"}
    assert (c.traffic["batch"], c.traffic["seq_len"], c.traffic["trace_steps"]) == (2, 2048, 4)
    assert {"mamba_dev_ms", "ssd_dev_ms", "ssd_launches", "ssd_roofline"} <= {
        m["name"] for m in c.per_layer}


# ------------------------------------------------------------------ span readers

MAIN, AUTOGRAD, STREAM = 1, 2, 7
RANGES = [  # (thread, name, start, end)
    (MAIN, "bench.window", 0, 1000), (MAIN, "bench.step", 10, 900),
    (MAIN, "model_mamba", 100, 200), (MAIN, "model_ssd", 140, 160),          # forward
    (AUTOGRAD, "model_mamba", 400, 600), (AUTOGRAD, "model_ssd", 450, 500),  # backward
]
LAUNCHES = [  # (launch time, thread, device us)
    (110, MAIN, 10),       # mixer, outside the scan
    (150, MAIN, 4),        # scan forward
    (300, MAIN, 100),      # outside every span
    (420, AUTOGRAD, 20),   # mixer backward
    (460, AUTOGRAD, 6),    # scan backward
    (470, AUTOGRAD, 2),    # scan backward
    (480, MAIN, 50),       # main thread, during the backward span of another thread
]


def _reading(tmp_path, ranges=RANGES, steps=2):
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": e - s, "tid": tid,
           "pid": 0} for tid, n, s, e in ranges]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 905 + i, "dur": 1,
            "tid": MAIN, "pid": 0} for i in range(steps - 1)]
    for corr, (ts, tid, us) in enumerate(LAUNCHES, start=1):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 2, "tid": tid, "pid": 0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts + 3, "dur": us,
                   "tid": STREAM, "pid": 1, "args": {"correlation": corr}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace(str(path))
    return harness.Reading(tr, tr, 0, None, None)


def _read(name, r):
    return spec.reader(name).read(r)


def test_span_readers(tmp_path, cell):
    r = _reading(tmp_path)
    assert _read("mamba_dev_ms", r) == pytest.approx((10 + 4 + 20 + 6 + 2) / 2e3, rel=1e-12)
    assert _read("ssd_dev_ms", r) == pytest.approx((4 + 6 + 2) / 2e3, rel=1e-12)
    assert _read("ssd_launches", r) == 1.5
    cell.model.shapes(cell.config)
    cell.model.inputs(cell.traffic, cell.config, torch.Generator().manual_seed(0))
    bound = cell.model.ssd_bound_ms(cell.config, cell.traffic, 1, 1)
    assert _read("ssd_roofline", r) == pytest.approx(100 * bound / ((4 + 6 + 2) / 1e3), rel=1e-12)


@pytest.mark.parametrize("name", ["mamba_dev_ms", "ssd_dev_ms", "ssd_launches", "ssd_roofline"])
def test_span_readers_are_none_without_the_spans(tmp_path, name):
    r = _reading(tmp_path, [x for x in RANGES if not x[1].startswith("model_")])
    assert _read(name, r) is None


def test_loss_entries_and_roofline_need_a_granite_configuration(tmp_path, cell, monkeypatch):
    """The loss entries raise before the adapter has made anything, and the
    roofline reader reads nothing where the configuration recorded last is
    not a Granite one."""
    model = cell.model
    monkeypatch.setattr(model, "_CURRENT", {})
    for entry in (model.program_loss(), model.reference_loss()):
        with pytest.raises(RuntimeError, match="configuration"):
            entry(None, None)
    model._CURRENT.update(cfg=dict(cell.config, model="nmt"), traffic=cell.traffic)
    assert _read("ssd_roofline", _reading(tmp_path)) is None


# ------------------------------------------------------------------ whole runs

SEED = 2**31 + 4242


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_is_correct(traced):
    c = tiny_cell()
    res = harness.measure(c, SEED, 0.2, traced, 0.0, device="cpu")
    assert res["correct"], res["checks"]
    names = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    assert set(res["metrics"]) <= names
    if traced:
        assert {"mamba_dev_ms", "ssd_dev_ms", "ssd_launches"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == names


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_a_broken_step_is_not_correct(fault):
    res = harness.measure(tiny_cell(), SEED, 0.1, False, 0.0, device="cpu", fault=fault)
    assert not res["correct"], res["checks"]


def test_the_reference_takes_the_quadratic_form():
    """The reference's scan and the program's chunked scan agree on the
    tiny cell's sizes (float64, ~1e-15 apart)."""
    from benchmark.reference import granite_hybrid as ref
    from psgd_tf_tpu_torch.ops import ssd

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 19, 4, 32, generator=gen, dtype=torch.float64)
    dt = torch.nn.functional.softplus(torch.randn(2, 19, 4, generator=gen, dtype=torch.float64))
    A = -torch.arange(1, 5, dtype=torch.float64)
    B, C = (torch.randn(2, 19, 16, generator=gen, dtype=torch.float64) for _ in range(2))
    torch.testing.assert_close(ssd.chunked(x, dt, A, B, C, 8), ref.ssd(x, dt, A, B, C),
                               rtol=1e-12, atol=1e-12)
    assert math.isfinite(float(ref.ssd(x, dt, A, B, C).abs().max()))
