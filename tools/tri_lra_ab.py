#!/usr/bin/env python3
"""Time K19 (the blocked triangular solve) and K13 (the lra update) of two
checkouts of the port on one card, or sweep K19's schedule on this one, or
time K11 and K12 (the dense update), or the sparse-LU update (K15, K16 and
the sharded K16), of two checkouts.

    python3 tools/tri_lra_ab.py OTHER_TREE
    python3 tools/tri_lra_ab.py --sweep
    python3 tools/tri_lra_ab.py --dense OTHER_TREE
    python3 tools/tri_lra_ab.py --splu OTHER_TREE

Run from the root of the repository on a machine with one CUDA card.
OTHER_TREE is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a directory `.gitignore` lists).
Each tree runs in its own process, in the order other, this, this, other,
so a drift of the card or the host shows as a spread between the two runs
of one tree. Each process builds its tree's kernels and times (CUDA events
over chained calls, TF32 off):

  - K19, `tri.solve_triangular`, at n = 2048, nrhs = 512 in the four
    orientations, each beside one `torch.linalg.solve_triangular` of the
    same system, and LeNet5's 40 solves (its ten factor sides, the other
    side as nrhs, four orientations) in ms a call;
  - K13, `lra.update_apply` at n = 400, 1,021 and 2^20, r = 10, in ms a call
    and in host ms a call (the host clock around 20 calls, no synchronise).

`--dense` times the dense update of both trees, in the same order: K11 at
n = 2, 400 and 1536 and K12 at n = 3841 and 16384 (hello_psgd's, the
tensor decomposition's, K11's cap, the dense RNN's, K12's cap), update
(`dense.update`) and update + apply (`dense.update_apply`) each: ms a call
chained (CUDA events over chained calls), ms a call queued (the calls
enqueued behind a spinning kernel: the device's own time), host us a call
(the host clock around calls with no synchronise) and launches a call
(`torch.profiler`, memsets counted), each timing the median of five
windows.

`--splu` times the sparse-LU update of both trees, in the same order and
the same four ways: K16 (`splu.update`) at n = 2^20 with r = 10, 32, 33,
64 and 128 and at the reference NMT's n = 12,424,273 (r = 10), its fused
apply (`splu_upd.fused_update(g=...)`) and the one-launch kernel at 2^20,
r = 10 (and at 100,003, r = 64, where a tree takes it), K15's update and
update + apply at (n, r) = (65,536, 10), (400, 10) and (400, 64) (on a
tree whose `splu_upd.launch_mono` takes `schedule`, also through that
entry under each schedule of its one launch), and on a one-rank NCCL
group the sharded K16 at 2^20 with r = 10 and 64, update and update +
apply.

`--sweep` times this tree's K19 by schedule: the leaf rows NB (64, 128,
256), the right-looking order `tri.schedule` builds against a recursive
split into halves (X1 = solve(M11, B1), B2 -= M21 X1, X2 = solve(M22, B2),
built here), through the same C entry; and the substitution kernel against
the blocked schedule for small systems (the SUBST_MAX_N threshold). Then
the card's name and power limit.
"""
from __future__ import annotations

import inspect
import subprocess
import sys
import time
from pathlib import Path

LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
ORIENTS = [(False, False), (False, True), (True, False), (True, True)]


def _time(torch, fn, reps=20):
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


def _setup(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from psgd_tf_tpu_torch.ops.hopper import _build

    if not torch.cuda.is_available():
        raise SystemExit("tri_lra_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    dev = torch.device("cuda")
    return torch, dev, torch.Generator(device=dev).manual_seed(0)


def _factor(torch, g, dev, n, lower):
    u = torch.triu(0.1 / n**0.5 * torch.randn(n, n, generator=g, device=dev), 1)
    u = u + torch.diag(0.5 + torch.rand(n, generator=g, device=dev))
    return u.T.contiguous() if lower else u


def _lenet_solves(torch, g, dev):
    return [(_factor(torch, g, dev, side, lo), torch.randn(side, rhs, generator=g, device=dev),
             lo, tr)
            for m, n in LENET5 for side, rhs in ((m, n), (n, m)) for lo, tr in ORIENTS]


def run_tree(tree: str, label: str) -> None:
    """Time K19 and K13 with the port of `tree`."""
    torch, dev, g = _setup(tree)
    from psgd_tf_tpu_torch.groups import lra
    from psgd_tf_tpu_torch.ops.hopper import tri

    out = []
    for lo, tr in ORIENTS:
        q, b = _factor(torch, g, dev, 2048, lo), torch.randn(2048, 512, generator=g, device=dev)
        m = q.T if tr else q
        ms = _time(torch, lambda: tri.solve_triangular(q, b, lower=lo, trans=tr))
        lib = _time(torch, lambda: torch.linalg.solve_triangular(m, b, upper=lo == tr))
        out.append(f"K19 (2048, 512) lower={lo} trans={tr} {ms:.4f} ms (library {lib:.4f})")
    cases = _lenet_solves(torch, g, dev)
    ms = _time(torch, lambda: [tri.solve_triangular(q, b, lower=lo, trans=tr)
                               for q, b, lo, tr in cases], 50)
    out.append(f"K19 LeNet5's {len(cases)} solves {ms / len(cases):.4f} ms a call")
    for n in (400, 1021, 1 << 20):
        st = lra.init(torch.Generator().manual_seed(n), n, rank=10, init_scale=0.8, device=dev)
        v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
        call = lambda: lra.update_apply(st, v, h, gr, 0.05, (False, True))
        ms = _time(torch, call, 50 if n > 10**5 else 200)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            call()
        host = (time.perf_counter() - t) / 20 * 1e3
        torch.cuda.synchronize()
        out.append(f"K13 n={n} {ms:.4f} ms, host {host:.4f} ms a call")
    print(f"{label} ({Path(tree).resolve()}):\n  " + "\n  ".join(out), flush=True)


DENSE_N = [2, 400, 1536, 3841, 16384]


def _median_windows(fn, windows=5):
    vals = sorted(fn() for _ in range(windows))
    return vals[len(vals) // 2]


def _queued(torch, fn, reps):
    """ms a call of `reps` calls enqueued behind a spinning kernel."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _host_us(torch, fn, reps):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _launches(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def run_dense(tree: str, label: str) -> None:
    """Time K11 and K12 with the port of `tree`."""
    torch, dev, g = _setup(tree)
    from psgd_tf_tpu_torch import dense
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import dense_upd

    out = []
    for n in DENSE_N:
        q = torch.triu(0.02 / n**0.5 * torch.randn(n, n, generator=g, device=dev))
        q += 0.8 * torch.eye(n, device=dev)
        with hopper.disabled():
            for _ in range(2):
                q = dense_upd.fused_update(q, *(torch.randn(n, generator=g, device=dev)
                                                for _ in range(2)), 0.1)
        v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
        st = dense.DenseState(Q=q)
        big = n > 8192
        for what, fn in (("update", lambda: dense.update(st, v, h, 0.1)),
                         ("update+apply", lambda: dense.update_apply(st, v, h, gr, 0.1))):
            chained = _median_windows(lambda: _time(torch, fn, 5 if big else 50))
            queued = _median_windows(lambda: _queued(torch, fn, 5 if big else 20))
            host = _median_windows(lambda: _host_us(torch, fn, 5 if big else 50))
            out.append(f"{dense.route(n, dev)} n={n} {what}: chained {chained:.4f} ms, queued "
                       f"{queued:.4f} ms, host {host:.1f} us a call, {_launches(torch, fn)} launches")
        del q, st
        torch.cuda.empty_cache()
    print(f"{label} ({Path(tree).resolve()}):\n  " + "\n  ".join(out), flush=True)


SPLU_N = [(1 << 20, 10), (1 << 20, 32), (1 << 20, 33), (1 << 20, 64), (1 << 20, 128),
          (12_424_273, 10)]
# K15's (n, r): bench.py:615's n, the tensor decomposition's, and past rank 32
K15_N = [(1 << 16, 10), (400, 10), (400, 64)]


def run_splu(tree: str, label: str) -> None:
    """Time K15, K16, the fused apply, mono and the sharded K16 with the
    port of `tree`."""
    import socket

    torch, dev, g = _setup(tree)
    import torch.distributed as dist
    from psgd_tf_tpu_torch.groups import splu
    from psgd_tf_tpu_torch.ops.hopper import splu_upd
    from psgd_tf_tpu_torch.parallel import make_mesh

    out = []

    def case(n, r):
        st = splu.walked_state(n, r, g, dev)
        return st, (st.Lt, st.l3, st.U12, st.u3), [torch.randn(n, generator=g, device=dev)
                                                   for _ in range(3)]

    def timed(what, fn, big):
        try:
            fn()
        except ValueError as e:  # a tree whose one launch keeps the rank-32 cap
            out.append(f"{what}: raises ({str(e)[:60]})")
            return
        chained = _median_windows(lambda: _time(torch, fn, 5 if big else 50))
        queued = _median_windows(lambda: _queued(torch, fn, 5 if big else 20))
        host = _median_windows(lambda: _host_us(torch, fn, 5 if big else 50))
        out.append(f"{what}: chained {chained:.4f} ms, queued {queued:.4f} ms, host {host:.1f} "
                   f"us a call, {_launches(torch, fn)} launches")

    for n, r in SPLU_N:
        st, fs, (v, h, gr) = case(n, r)
        timed(f"{splu.route(r, n, dev)} n={n} r={r} update", lambda: splu.update(st, v, h, 0.05),
              True)
        if (n, r) == (1 << 20, 10):
            timed(f"splu_upd_apply n={n} r={r} update+apply",
                  lambda: splu_upd.fused_update(*fs, v, h, 0.05, g=gr), True)
            timed(f"splu_upd_mono n={n} r={r} update+apply",
                  lambda: splu_upd.fused_update_apply_mono(*fs, v, h, gr, 0.05), True)
        del st, fs, v, h, gr
        torch.cuda.empty_cache()
    st, fs, (v, h, gr) = case(100_003, 64)
    timed("splu_upd_mono n=100003 r=64 update+apply",
          lambda: splu_upd.fused_update_apply_mono(*fs, v, h, gr, 0.05), False)
    forced = (hasattr(splu_upd, "launch_mono")
              and "schedule" in inspect.signature(splu_upd.launch_mono).parameters)
    for n, r in K15_N:
        st, fs, (v, h, gr) = case(n, r)
        timed(f"splu_one n={n} r={r} update", lambda: splu.update(st, v, h, 0.05), False)
        timed(f"splu_one n={n} r={r} update+apply", lambda: splu.update_apply(st, v, h, gr, 0.05),
              False)
        for sched in ("grid", "cluster") if forced else ():
            for what, gg in (("update", None), ("update+apply", gr)):
                timed(f"splu_one n={n} r={r} {what} ({sched}, the entry)",
                      lambda: splu_upd.launch_mono("splu_one", *fs, v, h, 0.05, gg,
                                                   schedule=sched), False)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh(data=1, shard=1, device=dev)
        n = 1 << 20
        for r in (10, 64):
            st, fs, (v, h, gr) = case(n, r)
            for what, gg in (("update", None), ("update+apply", gr)):
                timed(f"splu_upd_sharded one NCCL rank n={n} r={r} {what}",
                      lambda: splu_upd.fused_update_sharded(*fs, v, h, 0.05, mesh, None, gg), True)
            del st, fs, v, h, gr
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"{label} ({Path(tree).resolve()}):\n  " + "\n  ".join(out), flush=True)


def _recursive(tri, n, lower, trans, nb):
    """The recursive split as schedule records: leaves of nb rows, one
    update a split, S read from B until an update has written the rows."""
    forward = lower != trans
    nl = -(-n // nb)
    ops = [(tri.OP_INV, 0, n, 0, 0, 0)]

    def rows(a, b):
        return a * nb, min(b * nb, n) - a * nb

    def split(a, b):
        touched = int(a > 0 if forward else b < nl)
        if b - a == 1:
            ops.append((tri.OP_LEAF, *rows(a, b), 0, 0, touched))
            return
        h = (a + b) // 2
        first, second = ((a, h), (h, b)) if forward else ((h, b), (a, h))
        split(*first)
        ops.append((tri.OP_UPDATE, *rows(*second), *rows(*first), touched))
        split(*second)

    split(0, nl)
    return ops


def sweep() -> None:
    """K19 by schedule and leaf rows, and the substitution threshold."""
    torch, dev, g = _setup(".")
    from psgd_tf_tpu_torch.ops.hopper import _build, tri

    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    for n in (1024, 2048, 4096):
        for lo, tr in ((False, False), (True, True)):
            q, b = _factor(torch, g, dev, n, lo), torch.randn(n, 512, generator=g, device=dev)
            ref = tri.solve_triangular_plain(q, b, lower=lo, trans=tr)
            x = torch.empty_like(b)
            row = []
            for nb in (64, 128, 256):
                scratch = torch.empty(lib.psgd_tri_solve_scratch_floats(n, 512, nb, 0), device=dev)
                for name, ops in (("right-looking", tri.schedule(n, lo, tr, nb, 0)),
                                  ("recursive", _recursive(tri, n, lo, tr, nb))):
                    flat = _build.int_array([v for op in ops for v in op])
                    call = lambda: lib.psgd_tri_solve(n, 512, int(lo), int(tr), nb, flat, len(ops),
                                                      q.data_ptr(), b.data_ptr(), x.data_ptr(),
                                                      scratch.data_ptr(), stream)
                    _build.check(call(), "tri_solve")
                    rel = ((x - ref).abs().max() / ref.abs().max()).item()
                    row.append(f"{name} NB={nb} {_time(torch, call):.4f} ms ({rel:.1e})")
            m = q.T if tr else q
            lib_ms = _time(torch, lambda: torch.linalg.solve_triangular(m, b, upper=lo == tr))
            print(f"K19 n={n} nrhs=512 lower={lo} trans={tr}: library {lib_ms:.4f} ms\n  "
                  + "\n  ".join(row), flush=True)
    nb, subst_max = tri.NB, tri.SUBST_MAX_N
    cases = _lenet_solves(torch, g, dev)
    for n, nrhs in [(300, 64), (384, 256), (512, 256), (640, 200)]:
        cases.append((_factor(torch, g, dev, n, False),
                      torch.randn(n, nrhs, generator=g, device=dev), False, False))
    for label, group in (("LeNet5's 40 solves", cases[:40]),) + tuple(
            (f"n={q.shape[0]} nrhs={b.shape[1]}", [(q, b, lo, tr)]) for q, b, lo, tr in cases[40:]):
        row = []
        for sm in (0, 4096):
            tri.SUBST_MAX_N = sm
            ms = _time(torch, lambda: [tri.solve_triangular(q, b, lower=lo, trans=tr)
                                       for q, b, lo, tr in group], 50)
            row.append(f"{'substitution' if sm else 'blocked'} {ms / len(group):.4f}")
        print(f"K19 {label}: {', '.join(row)} ms a call (NB={nb})", flush=True)
    tri.SUBST_MAX_N = subst_max


def main() -> None:
    runs = {"--tree": run_tree, "--dense-tree": run_dense, "--splu-tree": run_splu}
    if len(sys.argv) == 4 and sys.argv[1] in runs:
        runs[sys.argv[1]](sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) == 2 and sys.argv[1] == "--sweep":
        sweep()
    elif len(sys.argv) == 3 and sys.argv[1] in ("--dense", "--splu"):
        for tree, label in ((sys.argv[2], "other"), (".", "this"), (".", "this"),
                            (sys.argv[2], "other")):
            subprocess.run([sys.executable, __file__, sys.argv[1] + "-tree", tree, label],
                           check=True)
    elif len(sys.argv) == 2:
        for tree, label in ((sys.argv[1], "other"), (".", "this"), (".", "this"),
                            (sys.argv[1], "other")):
            subprocess.run([sys.executable, __file__, "--tree", tree, label], check=True)
    else:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
