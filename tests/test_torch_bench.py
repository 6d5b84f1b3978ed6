"""The port's benchmark harness (`psgd_tf_tpu_torch/bench.py`, the CLI's
`bench`) against the repo-root `bench.py` and the work model `chip_smoke.py`
used before the model moved into the harness.

On the CPU: the state-entry counts and the row table equal the JAX bench's;
the NMT route table names JAX's kernel route for every layer at the
reference widths; the work models and the bound give what `chip_smoke.py`'s
helpers gave; every row runs end to end at tiny sizes with the card's timer
stubbed by the host clock (no kernel launches on the CPU); the headline line
stays within its length; and `bench` refuses to run without a card.
"""
import importlib
import inspect
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from psgd_tf_tpu.groups import kron as jkron
from psgd_tf_tpu.models import nmt as jnmt
from psgd_tf_tpu_torch import bench
from psgd_tf_tpu_torch.__main__ import main
from psgd_tf_tpu_torch.models import nmt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py:606-620: (row name, family, n, chain iterations, state dtype)
JAX_FAMILY_ROWS = [
    ("diag", "diag", 1 << 22, 100, "float32"),
    ("xmat", "xmat", 1 << 22, 100, "float32"),
    ("shift", "shift", 1 << 22, 100, "float32"),
    ("lra", "lra", 1 << 20, 100, "float32"),
    ("lra_bf16", "lra", 1 << 20, 100, "bfloat16"),
    ("splu", "splu", 1 << 16, 100, "float32"),
    ("splu_big", "splu_big", 1 << 20, 100, "float32"),
    ("dense", "dense", 1 << 12, 100, "float32"),
    ("dense_8k", "dense", 1 << 13, 20, "float32"),
    ("dense_16k", "dense", 1 << 14, 8, "float32"),
]
# bench.py:678-683: name -> (format pair, probe shape, chain iterations); the
# TPU traffic-pass count beside them is not carried over
JAX_KRON_ROWS = {
    "kron_nd": (("norm", "dense"), (131072, 512), 10),
    "kron_ns": (("norm", "scale"), (65536, 8192), 10),
    "kron_ns_wide": (("norm", "scale"), (512, 1_000_000), 6),
    "kron_ds": (("dense", "scale"), (512, 131072), 10),
}
# bench.py:476 (the toy NMT's chain), :481 (the reference NMT's), :101 (LeNet5's)
JAX_CHAINS = {"nmt": 30, "nmt_ref": 8, "lenet5": 200}


@pytest.fixture(scope="module")
def jbench():
    """The repo-root bench.py (JAX on the CPU, as tests/conftest.py pins it)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module("bench")


@pytest.mark.parametrize("family", ["diag", "xmat", "shift", "lra", "splu", "splu_big",
                                    "dense"])
def test_family_nnz_matches_jax(jbench, family):
    for n, r in [(2, 1), (400, 10), (1021, 3), (1 << 16, 10), (3841, 64), (1 << 20, 10)]:
        assert bench.family_nnz(family, n, r) == jbench.family_nnz(family, n, r)
    assert bench.family_nnz(family, 1 << 22) == jbench.family_nnz(family, 1 << 22)


def test_row_table_matches_jax(jbench):
    rows = [(r, f, n, c, str(d).split(".")[-1]) for r, f, n, c, d in bench.FAMILY_ROWS]
    assert rows == JAX_FAMILY_ROWS
    assert bench.KRON_ROWS == JAX_KRON_ROWS
    assert {"nmt": bench.NMT_CHAIN, "nmt_ref": bench.NMT_REF_CHAIN,
            "lenet5": bench.LENET5_CHAIN} == JAX_CHAINS
    defaults = lambda fn: {k: p.default for k, p in inspect.signature(fn).parameters.items()}
    assert defaults(jbench.bench_nmt_ref_dims)["iters"] == bench.NMT_REF_CHAIN
    assert defaults(jbench.bench_lenet5_steps_per_sec)["chain"] == bench.LENET5_CHAIN
    assert defaults(jbench.bench_lenet5_steps_per_sec)["batch_size"] == 64


@pytest.mark.parametrize("cfg", ["ref", "wide_attention"])
def test_nmt_routes_match_jax(cfg, monkeypatch):
    """The route table names JAX's route for every layer of the same
    (format, shape), but for the documented one: the port's (dense, dense)
    chain has no side cap, so it names 'kron_dd' where JAX says 'xla' above
    1024 (ROADMAP queue 3)."""
    jcfg = jnmt.ref_config()
    if cfg == "wide_attention":  # an attention width past the (dense, dense) side cap
        jcfg = jcfg._replace(attn=1500)
        monkeypatch.setattr(nmt, "ref_config", lambda: nmt.Config(*jcfg))
    routes = bench.nmt_ref_routes()
    want = {}
    for (m, n), fmt in zip(jnmt.layer_shapes(jcfg), jnmt.kron_formats(jcfg)):
        r = jkron.route(fmt, (m, n))
        if fmt == ("dense", "dense") and max(m, n) > 1024:
            assert r == "xla"
            r = "kron_dd"
        want[f"{fmt[0][0]}{fmt[1][0]}_{m}x{n}"] = r
    assert routes == want
    if cfg == "ref":
        assert routes["dd_1x10"] == "kron_dd" and len(routes) == 7
        bench.check_nmt_routes(routes)
        for key, route in [("ns_1025x4935", "xla"), ("sd_9414x256", "plain")]:
            with pytest.raises(RuntimeError, match="kernel coverage regressed"):
                bench.check_nmt_routes({**routes, key: route})
        bench.check_nmt_routes({**routes, "dd_1x10": "xla"})  # 10 entries: latency-trivial


# chip_smoke.py's work model before it moved into the harness (commit
# 0062644: `_bound`, `_kron_work`, phase 8b's `splu_work`, and the lra and
# dense bounds written at phases 7, 8, 8d, S1 and the kernel table)
def old_bound(nbytes, flops):
    tb, tf = nbytes / 3.35e12, flops / 67e12
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def old_kron_work(fmt, shape):
    m, n = shape
    side = {"dense": lambda k: k * (k + 1) / 2 + k * k, "scale": lambda k: 2 * k,
            "norm": lambda k: 4 * k}
    nbytes = 4 * (2 * m * n + side[fmt[0]](m) + side[fmt[1]](n))
    flops = 0.0
    for f, k, o in ((fmt[0], m, n), (fmt[1], n, m)):
        flops += 4 * k * k * o + 2 * k**3 / 3 if f == "dense" else 6 * k * o
    return nbytes, flops


def old_splu_work(n, r=10, apply=True):
    nt = n - r
    if apply:
        flops = 2.0 * (2 * r * r + 5 * r + r * (r + 1) / 2 + 2 * r) * nt + 40 * r * nt
        return 4 * (4 * r * n + 8 * n), flops
    return 4 * (4 * r * n + 6 * n), 2.0 * (2 * r * r + 5 * r) * nt + 32 * r * nt


def old_lra_bound(n, r=10):
    if r == 10:
        return old_bound(4 * (4 * 10 * n + 6 * n), 2 * 2 * 22**2 * n + 30 * 10 * n)
    z = 2 * r + 2
    return old_bound(4 * (4 * r * n + 6 * n), 2 * 2 * z * z * n + 30 * r * n)


def old_dense_bound(n):
    return old_bound(4 * (n * (n + 1) / 2 + n * n + 4 * n), 8.0 * n * n)


LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
DD = ("dense", "dense")
KRON_CASES = (
    [(DD, s) for s in LENET5]
    + list(zip(nmt.kron_formats(nmt.Config()), nmt.layer_shapes(nmt.Config())))
    + list(zip(nmt.kron_formats(nmt.ref_config()), nmt.layer_shapes(nmt.ref_config())))
    + [(("norm", "dense"), (131072, 512)), (("norm", "scale"), (512, 1_000_000)),
       (("norm", "scale"), (64, 3_000_017)), (("norm", "scale"), (65536, 8192)),
       (("dense", "scale"), (512, 131072)), (("scale", "norm"), (1024, 2305)),
       (DD, (1, 10)), (DD, (1024, 1024)), (DD, (768, 768)), (DD, (200, 256))]
    + [(f, (130, 65)) for f in [("norm", "scale"), ("dense", "scale"), ("norm", "dense")]])


@pytest.mark.parametrize("fmt,shape", KRON_CASES)
def test_kron_work_and_bound_as_before_the_move(fmt, shape):
    assert bench.kron_work(fmt, shape) == old_kron_work(fmt, shape)
    assert bench._bound(*bench.kron_work(fmt, shape)) == old_bound(*old_kron_work(fmt, shape))
    # the bench rows' pair adds P dG written once and the apply's products
    nbytes, flops = bench.kron_work(fmt, shape, apply=True)
    m, n = shape
    extra = sum(2 * k * k * o if f == "dense" else 4 * k * o
                for f, k, o in ((fmt[0], m, n), (fmt[1], n, m)))
    assert nbytes == old_kron_work(fmt, shape)[0] + 4 * m * n
    assert flops == pytest.approx(old_kron_work(fmt, shape)[1] + extra, rel=1e-12)


@pytest.mark.parametrize("n,r", [(400, 10), (1021, 10), (1 << 20, 10), (100_003, 33),
                                 (1 << 20, 64), (100_003, 128), (100_003, 256)])
def test_family_work_as_before_the_move(n, r):
    assert bench._bound(*bench.family_work("lra", n, r)) == old_lra_bound(n, r)
    for apply in (True, False):
        assert bench.splu_work(n, r, apply=apply) == old_splu_work(n, r, apply=apply)
    assert bench.family_work("splu", n, r) == old_splu_work(n, r)
    assert bench.family_work("splu_big", n, r) == old_splu_work(n, r)


@pytest.mark.parametrize("n", [1, 2, 128, 129, 400, 1021, 1536, 3841, 4096, 8192, 16384])
def test_dense_work_as_before_the_move(n):
    assert bench._bound(*bench.family_work("dense", n)) == old_dense_bound(n)


def test_elementwise_family_work():
    for n in (64, 1 << 22):
        assert bench.family_work("diag", n) == (24 * n, 10.0 * n)
        assert bench.family_work("xmat", n) == bench.family_work("shift", n) == (32 * n, 30.0 * n)
        assert bench._bound(*bench.family_work("diag", n))[1] == "bytes"
    with pytest.raises(ValueError, match="unknown family"):
        bench.family_work("kron", 10)
    # a bf16 row's FLOPs are judged at the tensor cores' bf16 rate
    assert bench._bound(1.0, 989e12, bench.BF16_FLOPS) == (1e3, "operations")


class _HostEvent:
    """torch.cuda.Event on the host clock (the card's timer, stubbed)."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture(scope="module")
def cpu_results():
    """`bench.measure` at tiny sizes on the CPU, chains of one, one rep:
    bench.py's row names and formats, the card's timer stubbed."""
    tiny = {"dense": 40}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "_DEV", torch.device("cpu"))
        mp.setattr(torch.cuda, "Event", _HostEvent)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(bench, "STREAM_N", 1 << 12)
        mp.setattr(bench, "PEAK_N", 64)
        mp.setattr(bench, "FAMILY_ROWS", [(r, f, tiny.get(f, 64), c, d)
                                          for r, f, n, c, d in bench.FAMILY_ROWS])
        mp.setattr(bench, "KRON_ROWS", {k: (fmt, (24, 16), c)
                                        for k, (fmt, s, c) in bench.KRON_ROWS.items()})
        mp.setattr(nmt, "ref_config", lambda: nmt.Config(vocab_src=40, vocab_tgt=30, embed=8,
                                                         units=16))
        return bench.measure(iters=1, reps=1)


ROWS = ([r for r, *_ in bench.FAMILY_ROWS] + list(bench.KRON_ROWS) + ["nmt_fd"]
        + [f"nmt_ref_{p}" for p in ("grad", "hvp", "qupd", "full")] + ["lenet5"])


def test_rows_run_end_to_end_on_the_cpu(cpu_results):
    res = cpu_results
    for row in ROWS:
        assert len(res[f"{row}_slopes_us"]) == 1 and res[f"{row}_slopes_us"][0] > 0
        assert res[f"{row}_rel_spread"] == 0.0
        assert res[f"{row}_launches_per_iter"] == {}  # plain versions on the CPU
    for row in [r for r, *_ in bench.FAMILY_ROWS] + list(bench.KRON_ROWS):
        for key in ("us", "bound_ms", "pct_of_bound", "achieved_gb_per_sec",
                    "pct_of_stream_bound", "pct_of_fp32_peak"):
            assert math.isfinite(res[f"{row}_{key}"]) and res[f"{row}_{key}"] > 0, (row, key)
        assert res[f"{row}_binding"] in ("bytes", "operations")
        assert res[f"{row}_pct_of_bound"] == pytest.approx(
            res[f"{row}_bound_ms"] * 1e3 / res[f"{row}_us"])
    for row, *_ in bench.FAMILY_ROWS:
        assert res[f"{row}_nnz_per_sec"] > 0
    for row in bench.KRON_ROWS:
        assert res[f"{row}_gelem_per_sec"] > 0
    assert res["lenet5_steps_per_sec"] == pytest.approx(1e6 / res["lenet5_slopes_us"][0])
    assert res["nmt_fd_step_us"] > 0 and res["nmt_ref_full_us"] > 0
    assert len(res["nmt_ref_routes"]) == 7
    assert res["hbm_stream_gb_per_sec"] > 0 and res["fp32_peak_flops"] > 0
    assert res["hbm_spec_gb_per_sec"] == 3350.0 and res["fp32_spec_flops"] == 67e12
    assert not any(k.endswith("_law") for k in res)  # the TPU's laws are not carried over


def test_last_line_at_full_size(cpu_results):
    """Every figure at its longest 4-digit form, the card's name beside it:
    the headline keeps every HEADLINE field and stays within LAST_LINE_MAX."""
    res = {k: (-1.234e-05 if isinstance(v, float) else v) for k, v in cpu_results.items()}
    res["lenet5_steps_per_sec"] = 81.23456789
    res["card"] = "NVIDIA H100 80GB HBM3, 700.00 W"
    line = bench.last_line(res)
    head = json.loads(line)
    assert len(line) <= bench.LAST_LINE_MAX
    assert set(head) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert (head["metric"], head["unit"], head["vs_baseline"]) == (
        "lenet5_kron_steps_per_sec", "steps/s", 1.0)
    assert head["value"] == 81.23
    assert list(head["detail"]) == bench.HEADLINE
    # a longer detail is cut from its end, the headline kept
    res["card"] = "x" * 1000
    line = bench.last_line(res)
    detail = json.loads(line)["detail"]
    assert len(line) <= bench.LAST_LINE_MAX and list(detail) == bench.HEADLINE[:len(detail)]
    assert 0 < len(detail) < len(bench.HEADLINE)
    # the full dict, printed on the line before it, runs past 2,000 characters
    assert len(json.dumps(cpu_results)) > 2000


def test_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: `bench` would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["bench"])
    ran = subprocess.run([sys.executable, "-m", "psgd_tf_tpu_torch", "bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert ran.returncode != 0
    assert "no CUDA device" in ran.stderr and "H100" in ran.stderr
    assert ran.stdout.strip() == ""


def test_a_row_that_raises_fails_the_command(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("row failed")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "_card", lambda: "card")
    monkeypatch.setattr(bench, "measure", broken)
    with pytest.raises(RuntimeError, match="row failed"):
        main(["bench"])
