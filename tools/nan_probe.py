#!/usr/bin/env python3
"""Whether the flat families' kernels on the card propagate a non-finite
value, as their plain versions and the JAX package's kernels do, or fault.

    python3 tools/nan_probe.py

Run from the root of the repository on a machine with one CUDA card. Each
case runs in a child process of its own, since a device fault leaves the
CUDA context unusable:

  - one update + apply (`lra`, `splu`, `dense` `.update_apply`) on a probe v
    or a state holding one NaN (`--case FAMILY N v|state nan|inf` runs one
    case, an inf too), at the sizes the paths and the
    bench give each kernel (K13, K15, K16, K11, K12), beside the plain
    version on the same inputs;
  - `--chain`: lra at n = 2^20, r = 10, its P' v fed back as the next probe
    for up to 1000 calls, each synchronised: the call at which the state
    stops being finite, and what the next calls do.

One line a case: finite or not, the kernel's launches, or the error it
raised.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

CASES = [("lra", 1 << 20), ("lra", 1021), ("splu", 1 << 16), ("splu", 1 << 20), ("dense", 400),
         ("dense", 4096)]


def _state(fam, n, g, dev):
    from psgd_tf_tpu_torch import dense, lra, splu

    if fam == "lra":
        return lra.init(g, n, rank=10, device=dev)
    if fam == "splu":
        return splu.init(n, rank=10, device=dev)
    return dense.init(n, device=dev)


def _poison(fam, st, value):
    """The state with one entry of its largest field set to `value`."""
    name = {"lra": "UV", "splu": "Lt", "dense": "Q"}[fam]
    field = getattr(st, name).clone()
    field.view(-1)[5] = value
    return dataclasses.replace(st, **{name: field})


def case(fam, n, where, value):
    import torch

    from psgd_tf_tpu_torch import dense, lra, splu
    from psgd_tf_tpu_torch.ops import hopper

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    st = _state(fam, n, g, dev)
    v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
    value = float(value)
    if where == "v":
        v[n // 3] = value
    else:
        st = _poison(fam, st, value)
    mod = {"lra": lra, "splu": splu, "dense": dense}[fam]
    kw = {"coins": (False, True)} if fam == "lra" else {}
    call = lambda: mod.update_apply(st, v, h, gr, 0.01, **kw)
    with hopper.disabled():
        _, pre = call()
    head = (f"{fam} n={n}, one {value} in {where}: plain P' g finite "
            f"{bool(torch.isfinite(pre).all())}")
    hopper.reset_counts()
    try:
        _, pre = call()
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(pre).all())
        print(f"{head}; kernel P' g finite {finite}, launches "
              f"{ {k: c for k, c in hopper.counts.items() if c} }", flush=True)
    except RuntimeError as e:
        print(f"{head}; kernel raised {e}", flush=True)


def chain(n=1 << 20, calls=1000):
    import torch

    from psgd_tf_tpu_torch import lra

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(101)
    st = lra.init(g, n, rank=10, device=dev)
    v, h = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    coin = torch.Generator().manual_seed(101)
    first_bad = None
    for i in range(calls):
        coins = (torch.rand((), generator=coin).item() < 0.01,
                 torch.rand((), generator=coin).item() < 0.5)
        try:
            st, v = lra.update_apply(st, v, h, v, step=1e-4, coins=coins)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"lra chain n={n}: call {i} (coins {coins}) raised {e}; the state was first "
                  f"not finite after call {first_bad}", flush=True)
            return
        finite = bool(torch.isfinite(st.UV).all() and torch.isfinite(st.d).all())
        if not finite and first_bad is None:
            first_bad = i
            print(f"lra chain n={n}: state not finite after call {i}, max |v| before it "
                  f"{v.abs().max().item():.3e}", flush=True)
        if first_bad is not None and i >= first_bad + 5:
            print(f"lra chain n={n}: five calls on the non-finite state ran", flush=True)
            return
    print(f"lra chain n={n}: {calls} calls, state finite", flush=True)


def main():
    if sys.argv[1:2] == ["--case"]:
        fam, n, where, value = sys.argv[2:6]
        return case(fam, int(n), where, value)
    if sys.argv[1:2] == ["--chain"]:
        return chain()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = [["--case", fam, str(n), where, "nan"] for fam, n in CASES
            for where in ("v", "state")] + [["--chain"]]
    for args in runs:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), *args], cwd=root, env=env,
                             capture_output=True, text=True, timeout=600)
        lines = [l for l in out.stdout.splitlines() if l.strip()]
        print("\n".join(lines) if lines else f"{args}: rc {out.returncode}, "
              f"{out.stderr.strip().splitlines()[-1:]}", flush=True)


if __name__ == "__main__":
    main()
