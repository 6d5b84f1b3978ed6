"""No module that the benchmark loads is JAX's or the JAX package's, and a
run without a card prints no result and fails."""
import os
import subprocess
import sys

import pytest

from benchmark import spec

ROOT = str(spec.ROOT)

_PROBE = r"""
import sys, pkgutil, importlib
sys.path.insert(0, {root!r})
import benchmark
for m in pkgutil.walk_packages(benchmark.__path__, "benchmark."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from benchmark import harness, spec
for name in ("host_ms_per_step", "curvature_dev_ms", "precond_dev_ms", "precond_roofline",
             "exchange_dev_ms", "device_idle_pct", "peak_mem_gib"):
    spec.reader(name)
from benchmark.tests import tiny
harness.measure(tiny.cell("nmt_lra.tok127k"), 5, 0.1, True, 0.0, device="cpu")
loaded = {{m.split(".")[0] for m in sys.modules}}
print(sorted(loaded & {{"jax", "jaxlib", "flax", "psgd_tf_tpu"}}), "psgd_tf_tpu_torch" in loaded)
"""


def _clean_env():
    return {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}


def test_no_jax_is_loaded():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)], capture_output=True,
                         text=True, env=_clean_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_name_check_compares_whole_top_level_names():
    from benchmark import harness

    assert harness.forbidden_modules(["psgd_tf_tpu_torch.ops.hopper", "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["psgd_tf_tpu.optim.psgd"]) == ["psgd_tf_tpu"]
    assert harness.forbidden_modules(["jaxlib.xla_client", "flax", "jax"]) == ["flax", "jax",
                                                                              "jaxlib"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a machine without a CUDA card: here the run would measure")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nmt_kron.tok127k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, env=_clean_env(), cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
