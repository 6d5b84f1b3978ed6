#!/usr/bin/env python3
"""`chip_smoke.py`'s phase S5 alone on the card, and whether gloo takes a
reduce-scatter of CUDA tensors between two ranks sharing the card.

    python3 tools/run_s5.py

Run from the root of the repository on a machine with one CUDA card. It
builds the kernels, spawns two gloo ranks for the reduce-scatter and then
S5's four (`chip_smoke._s5_job`: the reference NMT with parameters split
over `data`, `shard` or both on mesh (data=2, shard=2), under kron and lra,
against the same steps in one process), prints S5's lines
(`chip_smoke._s5_report`; S4's rates, which this run does not make, as
nan) and exits non-zero if a check failed.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def reduce_scatter_job(rank, world):
    """('ok', this rank's sum of the ranks' halves) or ('refused', why)."""
    import torch
    import torch.distributed as dist

    x = torch.arange(8, dtype=torch.float32, device="cuda:0") + 10 * rank
    out = torch.empty(4, device="cuda:0")
    try:
        dist.reduce_scatter_tensor(out, x)
        return "ok", out.cpu().tolist()
    except RuntimeError as e:
        return "refused", str(e)[:300]


def main() -> int:
    import torch

    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"gloo reduce_scatter_tensor of CUDA tensors on two ranks: "
          f"{chip_smoke._spawn(reduce_scatter_job, 2)}", flush=True)
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            print(f"FAIL {what}", flush=True)

    launches = {name: 0 for name in hopper.counts}
    t0 = time.perf_counter()
    ranks = chip_smoke._spawn(chip_smoke._s5_job, 4)
    chip_smoke._s5_report(torch, ranks, check, launches, smi,
                          {fam: float("nan") for fam in chip_smoke.TP_FIELDS},
                          time.perf_counter() - t0)
    print(f"launches on the four ranks: {({k: v for k, v in launches.items() if v})}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
