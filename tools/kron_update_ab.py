#!/usr/bin/env python3
"""Time the streaming Kronecker updates of two checkouts of the port on one card.

    python3 tools/kron_update_ab.py OTHER_TREE

Run from the root of the repository on a machine with one CUDA card.
OTHER_TREE is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a directory `.gitignore` lists).
Each tree runs in its own process, in the order other, this, this, other,
so a drift of the card or the host shows as a spread between the two runs
of one tree. Each process builds its tree's kernels and times one
`kron.update` (CUDA events over chained calls, TF32 off) at shapes where
the device's work, not the host's enqueue, sets the time:

  - K9, (norm, dense): bench.py's kron_nd row (131072, 512), and the
    reference NMT model's widest layer under PSGD's default formats
    (2305, 1024);
  - K10, (dense, scale): (512, 65536) and (1024, 16384), K = m products
    over wide probes.

Each time is printed with the update's max relative difference from the
plain version on the same inputs. Then the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CASES = [(("norm", "dense"), (131072, 512), 20), (("norm", "dense"), (2305, 1024), 50),
         (("dense", "scale"), (512, 65536), 20), (("dense", "scale"), (1024, 16384), 20)]


def _time(torch, fn, reps):
    """ms per call of fn() from CUDA events over `reps` chained calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def run_tree(tree: str, label: str) -> None:
    """Time every case with the port of `tree`."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from psgd_tf_tpu_torch import kron
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build

    if not torch.cuda.is_available():
        raise SystemExit("kron_update_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for fmt, shape, reps in CASES:
        st = kron.init(shape, fmt=fmt, init_scale=0.8, device=dev)
        dx, dg = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
        try:
            st = kron.update(st, dx, dg, step=0.1)
        except NotImplementedError:  # a tree from before the route's kernel
            out.append(f"{fmt} {shape} not ported")
            continue
        got = kron.update(st, dx, dg, step=0.1)
        with hopper.disabled():
            ref = kron.update(st, dx, dg, step=0.1)
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in ((got.ql, ref.ql), (got.qr, ref.qr)))
        ms = _time(torch, lambda: kron.update(st, dx, dg, step=0.1), reps)
        out.append(f"{fmt} {shape} {ms:.4f} ms (rel err {rel:.2e})")
    print(f"{label} ({_build.CSRC.parent}): " + " | ".join(out), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tree":
        run_tree(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = str(Path(__file__).resolve().parents[1])
    for tree, label in [(sys.argv[1], "other"), (here, "this"), (here, "this"),
                        (sys.argv[1], "other")]:
        subprocess.run([sys.executable, __file__, "--tree", tree, label], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
