"""CLI: run any workload with config files and overrides.

Counterpart of `psgd_tf_tpu/__main__.py`:

    python -m psgd_tf_tpu_torch list
    python -m psgd_tf_tpu_torch run mnist_lenet5 --set epochs=3 --set lr=0.05
    python -m psgd_tf_tpu_torch run nmt_attention --config my.json
    python -m psgd_tf_tpu_torch run hello_psgd --set device=cpu
    python -m psgd_tf_tpu_torch bench

A workload runs on the card unless `--set device=cpu` says otherwise. The
last line of `run`'s output is the result as JSON; the exit code is 0 when
the result's `success` holds, else 1. `bench` runs `psgd_tf_tpu_torch.bench`
(the counterpart of the repo-root `bench.py`) on the card: its last line is
the headline JSON; without a CUDA device, or when a row raises, it exits
non-zero.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

from psgd_tf_tpu_torch import config as config_mod

WORKLOADS = [
    "hello_psgd",
    "all_preconditioners",
    "mnist_lenet5",
    "lstm_xor",
    "rnn_xor_lra",
    "nmt_attention",
]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="psgd_tf_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list workloads and their config schemas")

    runp = sub.add_parser("run", help="run a workload")
    runp.add_argument("workload", choices=WORKLOADS)
    runp.add_argument("--config", help="JSON config file")
    runp.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override one config key (repeatable)",
    )

    sub.add_parser("bench", help="run the benchmark harness")

    args = parser.parse_args(argv)

    if args.cmd == "list":
        for name in WORKLOADS:
            mod = importlib.import_module(f"psgd_tf_tpu_torch.workloads.{name}")
            print(f"{name}: {json.dumps(config_mod.schema(mod.run), default=str)}")
        return 0

    if args.cmd == "bench":
        from psgd_tf_tpu_torch import bench

        return bench.main()

    mod = importlib.import_module(f"psgd_tf_tpu_torch.workloads.{args.workload}")
    kwargs = config_mod.load(mod.run, args.config, args.set)
    result = mod.run(**kwargs)
    print(json.dumps(result, default=str))
    return 0 if result.get("success", True) else 1


if __name__ == "__main__":
    sys.exit(main())
