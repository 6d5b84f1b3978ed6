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
  - `--lra k13|k14 N R UV|d|v nan|inf`: one lra update + apply and update
    through K13 or K14 (on a one-rank gloo group, pipelined off and on) at
    rank R with one non-finite entry in UV, d or v, against the plain chain
    on the same inputs: the same non-finite entries and the finite ones
    within 1e-4 of the plain chain's largest; exit code 1 where they differ.
    `--lra-all` runs LRA_CASES in one process (a fault ends it);
  - `--chain`: lra at n = 2^20, r = 10, its P' v fed back as the next probe
    for 1000 calls, each synchronised: the call at which the state stops
    being finite, and that every call ran.

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
# (kernel, n, r, where, value): K13 and K14 on both rank chains, a NaN in
# the state and in the probe, an inf in d
LRA_CASES = [(k, n, r, where, value) for k in ("k13", "k14")
             for n, r in ((1 << 20, 10), (1021, 10), (100_003, 40))
             for where, value in (("UV", "nan"), ("v", "nan"), ("d", "inf"))]


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


def _agree(got, want):
    """'' where got is non-finite exactly where want is and the finite
    entries agree within 1e-4 of want's largest finite entry; else why not."""
    import torch

    bad = ~torch.isfinite(want)
    if not torch.equal(~torch.isfinite(got), bad):
        return (f"non-finite entries differ ({int((~torch.isfinite(got)).sum())} against "
                f"{int(bad.sum())})")
    if bad.all():
        return ""
    err = ((got - want)[~bad].abs().max() / want[~bad].abs().max().clamp_min(1e-30)).item()
    return "" if err < 1e-4 else f"finite entries differ by {err:.3e}"


def lra_case(kernel, n, r, where, value, mesh=None):
    """One K13 or K14 call on a state or probe with one non-finite entry,
    against the plain chain; True when they agree (a fault raises)."""
    import torch

    from psgd_tf_tpu_torch import lra
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import lra_upd

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(n + r)
    st = lra.init(g, n, rank=r, init_scale=0.8, device=dev)
    v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
    UV, d = st.UV.clone(), st.d.clone()
    target = {"UV": UV.view(-1), "d": d, "v": v}[where]
    target[target.numel() // 3] = float(value)
    calls = []
    for coins in ((False, True), (True, False)):
        if kernel == "k13":
            calls += [lambda c=coins: lra_upd.fused_update_apply(UV, d, v, h, gr, 0.05, c),
                      lambda c=coins: lra_upd.fused_update(UV, d, v, h, 0.05, c)]
        else:
            calls += [lambda c=coins, p=p: lra_upd.fused_update_apply_sharded(
                UV, d, v, h, gr, 0.05, c, mesh, pipelined=p) for p in (False, True)]
            calls += [lambda c=coins: lra_upd.fused_update_sharded(UV, d, v, h, 0.05, c, mesh)]
    why = []
    for call in calls:
        with hopper.disabled():
            want = call()
        got = call()
        torch.cuda.synchronize()
        why += [w for w in (_agree(a, b) for a, b in zip(got, want, strict=True)) if w]
    verdict = "ok" if not why else "MISMATCH " + "; ".join(why[:3])
    print(f"lra {kernel} n={n} r={r}, one {value} in {where}: {len(calls)} calls, no fault, "
          f"{verdict}", flush=True)
    return not why


def lra_cases(cases):
    """lra_case over `cases` in this process, K14 on a one-rank gloo group;
    exit code 1 if any disagrees."""
    import torch
    import torch.distributed as dist

    from psgd_tf_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(data=1, shard=1, device=torch.device("cuda"))
        ok = [lra_case(k, int(n), int(r), where, value, mesh) for k, n, r, where, value in cases]
    finally:
        dist.destroy_process_group()
    sys.exit(0 if all(ok) else 1)


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
            sys.exit(1)
        finite = bool(torch.isfinite(st.UV).all() and torch.isfinite(st.d).all())
        if not finite and first_bad is None:
            first_bad = i
            print(f"lra chain n={n}: state not finite after call {i}, max |v| before it "
                  f"{v.abs().max().item():.3e}", flush=True)
    print(f"lra chain n={n}: {calls} calls ran without a device error; the state "
          f"{'stayed finite' if first_bad is None else f'was first not finite after call {first_bad}'}",
          flush=True)


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    if sys.argv[1:2] == ["--case"]:
        fam, n, where, value = sys.argv[2:6]
        return case(fam, int(n), where, value)
    if sys.argv[1:2] == ["--lra"]:
        return lra_cases([sys.argv[2:7]])
    if sys.argv[1:2] == ["--lra-all"]:
        return lra_cases(LRA_CASES)
    if sys.argv[1:2] == ["--chain"]:
        return chain()
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = [["--case", fam, str(n), where, "nan"] for fam, n in CASES
            for where in ("v", "state")] + [["--lra", *map(str, c)] for c in LRA_CASES] + [
        ["--chain"]]
    for args in runs:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), *args], cwd=root, env=env,
                             capture_output=True, text=True, timeout=600)
        lines = [l for l in out.stdout.splitlines() if l.strip()]
        print("\n".join(lines) if lines else f"{args}: rc {out.returncode}, "
              f"{out.stderr.strip().splitlines()[-1:]}", flush=True)


if __name__ == "__main__":
    main()
