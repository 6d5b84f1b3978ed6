#!/usr/bin/env python3
"""Where the time of K1's list update, of K3 and of the streaming
(norm, scale) and (dense, scale) updates goes on the card.

    python3 tools/profile_kron_chain.py

Run from the root of the repository on a machine with one CUDA card. It
builds the port's kernels and traces three cases with `torch.profiler`:

  - K1 on LeNet5's five (dense, dense) layers, through `kron.update_multi`;
  - K1 on the toy NMT model's seven layers of mixed kinds;
  - K3 alone (`tri.inverse_upper`) on LeNet5's ten factors.

For each case it reports:

  - the host time of one call (the host clock around 200 calls with no
    synchronise; the device keeps up, so this is the enqueue), for K1 of
    `kron.update_multi`, of `kron_multi.fused_update_multi` inside it and
    of `kron_dd.launch` (the wrapper of the C entry) inside that;
  - CUDA events over 200 chained calls (what `chip_smoke.py` reports);
  - each launch of one call: its kernel, its device microseconds and the
    gap before it, and the device span of the call (first start to last
    end), twice: "queued", the call enqueued behind a sleeping kernel so
    that the host never starves the device (the device's own launch
    gaps), and "synced", a synchronise before and after the call (the
    gaps a lone call sees, the host's enqueue included). The figures are
    medians over 20 traced calls.

With `--route chain` or `--route mono` every K1 call is forced onto that
route (`kron_dd.forced_route`). Output: one block a case, then the card's
name and power limit.

    python3 tools/profile_kron_chain.py --phases

times the phases inside the two cooperative kernels, K3's `tri_kernel`
(LeNet5's ten factors) and K1's `kron_mono_kernel` (LeNet5's list and the
toy NMT list, forced onto the one launch): a copy of the port is made with
a probe added to each (block 0 stamps %globaltimer as each phase starts,
every block the kernel's end), built in its own process, and each gap
between stamps is printed in us (the median call of seven). The library
itself has no probe.

    python3 tools/profile_kron_chain.py --stream [TREE]

traces the streaming updates through `kron.update`, one layer a case: K6
at the reference NMT model's three (norm, scale) layers, K10 at its three
mirrored (scale, dense) layers (dX arrives transposed), K7 at
(512, 1,000,000) and K8 at (64, 3,000,017), with the host time of
`kron.update` and of the kernel call inside it (the tree's C entry: the
kernel part `ns_reductions`/`ds_reductions` where the tree has one, else
the whole update's `_ns_call`/`_ds_call`), CUDA events over chained calls,
and each launch queued and synced, as above. TREE is another checkout of
the repository (for example the parent commit, unpacked with `git
archive` into a directory `.gitignore` lists); its package is imported
instead of this one.

    python3 tools/profile_kron_chain.py --dense-steps

times the steps of K12's pass-1 chain at n = 1536, 3841 and 16384 in a copy
of the port with %globaltimer stamps added to `csrc/dense.cu` (built in its
own process, as `--phases` does): a step of the chain (D(p) taking D(p-1)'s
look-ahead word), D(p)'s look-ahead to b_p, its loads, and the R items'
path (b_p taken, their running sums put), medians over the panels of a
call and over five calls.

    python3 tools/profile_kron_chain.py --dense [TREE]

traces the dense family's update (K11 at n = 2, 400 and 1536, K12 at
n = 3841 and 16384: hello_psgd's, the tensor decomposition's, K11's cap,
the dense RNN's and K12's cap), update and update + apply each, through
`dense.update` / `dense.update_apply`, with the host time of the wrapper
(`dense_upd.launch`) inside it, CUDA events over chained calls, and each
launch queued and synced, memsets counted as launches. TREE as for
`--stream`.

    python3 tools/profile_kron_chain.py --splu [TREE]

traces the sparse-LU family's update the same way: K16 (`splu.update`) at
n = 2^20 with r = 10, 32, 33 and 64, at the reference NMT's n =
12,424,273 (r = 10) and at LeNet5's n (44,426, r = 10: K15 there), the
fused apply (`splu_upd.fused_update(g=...)`) and the one-launch kernel at
2^20, r = 10, K15's update and update + apply at (n, r) = (65,536, 10),
(400, 10) and (400, 64), then, on a
one-rank NCCL group, the sharded K16 at 2^20 with r = 10 and 64, update
and update + apply, beside K16 and its fused apply on the same state, and
K14 at 2^20, r = 10, beside K13. Each case gives the host us of the call
and of the wrapper inside it, the events, and every launch queued and
synced (memsets and torch's fills counted). TREE as for `--stream`.

    python3 tools/profile_kron_chain.py --apply-nd [TREE]

traces K17's (norm, dense) apply (`kron_sparse_big.fused_apply_nd`) the
same way at bench.py's (131072, 512) and at the reference NMT's five
(norm, dense) layers under the default formats, with the host us of the
entry and of its C call, CUDA events, and each launch queued and synced.
TREE as for `--stream`.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if not any(a in sys.argv for a in ("--phases-child", "--dense-steps-child")):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository root
if sys.argv[1:2] in (["--stream"], ["--dense"], ["--splu"], ["--apply-nd"]) and len(sys.argv) > 2:
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))  # the other tree's package first

LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
CALLS = 200
TRACED = 20
# --stream: K7's and K8's layers (bench.py's kron_ns_wide row, and past 2^21 lanes)
WIDE = [(512, 1_000_000), (64, 3_000_017)]
# --dense: hello_psgd's n, the tensor decomposition's, K11's cap, the dense RNN's, K12's cap
DENSE_N = [2, 400, 1536, 3841, 16384]
# --splu: (n, r) of K16's update: bench.py:616's n at the rank-32 chain's
# ranks and past it, the reference NMT's n, LeNet5's n
SPLU_N = [(1 << 20, 10), (1 << 20, 32), (1 << 20, 33), (1 << 20, 64), (12_424_273, 10),
          (44_426, 10)]
# --splu: K15's (n, r): bench.py:615's n, the tensor decomposition's, and past rank 32
K15_N = [(1 << 16, 10), (400, 10), (400, 64)]
# --apply-nd: bench.py:678-683's kron_nd row
APPLY_ND = (131072, 512)


def _kernels(trace_path, cats=("kernel",)):
    """[(name, start us, end us)] of the device kernels of a chrome trace
    (and its memsets, with cats=("kernel", "gpu_memset"))."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") in cats]
    return sorted(out, key=lambda k: k[1])


def _calls(kernels, per_call):
    """The kernels split into calls of `per_call` launches each."""
    return [kernels[i:i + per_call] for i in range(0, len(kernels) - per_call + 1, per_call)]


def _trace(torch, fn, queued, traced=TRACED, cats=("kernel",)):
    """Per-launch medians over `traced` calls of fn: [(kernel, us, gap us)],
    and the median device span of a call in us."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns a trace without the device's events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(traced):
                if queued:
                    torch.cuda._sleep(20_000_000)  # ~10 ms of a spinning kernel, not counted
                else:
                    torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            kernels = [k for k in _kernels(path, cats) if not k[0].startswith("at::cuda::")]
        if len(kernels) >= traced:
            break
    else:
        raise RuntimeError(f"profile_kron_chain: {len(kernels)} launches seen in {traced} calls")
    per_call = len(kernels) // traced
    calls = _calls(kernels, per_call)
    rows = []
    for i in range(per_call):
        us = statistics.median(c[i][2] - c[i][1] for c in calls)
        gap = statistics.median((c[i][1] - c[i - 1][2]) if i else 0.0 for c in calls)
        rows.append((calls[0][i][0], us, gap))
    span = statistics.median(c[-1][2] - c[0][1] for c in calls)
    return rows, span


def _host_us(torch, fn, calls=CALLS):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _event_ms(torch, fn, calls=CALLS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def _report(torch, label, fn, inners, calls, traced, summary, cats=("kernel",)):
    """One case's block: host us of fn and of each (name, call) of
    `inners` (the calls inside it), CUDA events, and the launches queued
    and synced."""
    host = _host_us(torch, fn, calls)
    inner_host = {name: _host_us(torch, call, calls) for name, call in inners}
    ev = _event_ms(torch, fn, calls)
    q_rows, q_span = _trace(torch, fn, True, traced, cats)
    s_rows, s_span = _trace(torch, fn, False, traced, cats)
    print(f"== {label}", flush=True)
    print(f"  host us a call: {host:.1f}" + (" (" + ", ".join(
        f"{name} alone {us:.1f}" for name, us in inner_host.items()) + ")" if inners else ""),
        flush=True)
    print(f"  CUDA events over {calls} chained calls: {ev * 1e3:.1f} us a call", flush=True)
    for name, rows, span in [("queued", q_rows, q_span), ("synced", s_rows, s_span)]:
        print(f"  {name}: {len(rows)} launches, device span {span:.1f} us; launches "
              f"(us, gap before us): " + "; ".join(
                  f"{r[0].split('(')[0][:48]} {r[1]:.1f} ({r[2]:.1f})" for r in rows),
              flush=True)
    summary[label] = dict(host_us=host, inner_host_us=inner_host, event_us=ev * 1e3,
                          queued_span_us=q_span, synced_span_us=s_span, launches=len(q_rows),
                          queued_launch_us=[[r[0].split('(')[0][:48], r[1]] for r in q_rows])


def _stream() -> int:
    """--stream: K6, K10, K7 and K8 through `kron.update`, a layer a case."""
    import torch
    from psgd_tf_tpu_torch import kron
    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build, kron_sparse_big as ksb

    if not torch.cuda.is_available():
        print("profile_kron_chain: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"package {Path(ksb.__file__).resolve().parents[3]}; torch {torch.__version__}",
          flush=True)
    _build.lib()
    g = torch.Generator(device=dev).manual_seed(0)
    ref = nmt.ref_config()
    cases = [(f, s) for f, s in zip(nmt.kron_formats(ref), nmt.layer_shapes(ref))
             if f in (("norm", "scale"), ("scale", "dense"))]
    cases += [(("norm", "scale"), s) for s in WIDE]
    summary = {}
    for fmt, shape in cases:
        st = kron.init(shape, fmt=fmt, init_scale=0.8, device=dev)
        with hopper.disabled():
            for _ in range(2):
                st = kron.update(st, torch.randn(shape, generator=g, device=dev),
                                 torch.randn(shape, generator=g, device=dev), 0.1)
        dX, dG = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
        kind, _, a, b, dx, dg = kron._oriented(st, dX, dG)
        if kind == "ns" and hasattr(ksb, "ns_reductions"):
            ql0, ql1 = a[0], a[1]
            w, al = ql1 / (ql0 * ql0[-1]), ql0[-1] * dg[-1] * b
            inner = lambda: ksb.ns_reductions(dx, dg, ql0, ql1, w, b, dg[-1], al)
            inner_name = "ns_reductions"
        elif kind == "ds" and hasattr(ksb, "ds_reductions"):
            inner, inner_name = (lambda: ksb.ds_reductions(a, b, dx, dg)), "ds_reductions"
        else:
            call = getattr(ksb, f"_{kind}_call")
            inner, inner_name = (lambda: call(a, b, dx, dg, 0.1)), f"_{kind}_call"
        wide = shape in WIDE
        label = f"{'K7/K8' if wide else 'K6' if kind == 'ns' else 'K10'} {fmt} {shape}"
        _report(torch, label, lambda: kron.update(st, dX, dG, 0.1), [(inner_name, inner)],
                10 if wide else CALLS, 5 if wide else TRACED, summary)
        del st, dX, dG, dx, dg, a, b
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


# --phases: the probe, edits made in a copy of the port (file, old, new)
_PROBE = """
__device__ unsigned long long g_stamps[64];
__device__ __forceinline__ void stamp(int k) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    if (threadIdx.x == 0 && (blockIdx.x == 0 || k < 0)) {
        if (k >= 0) g_stamps[k] = t; else atomicMax(&g_stamps[-k], t);
    }
}
#define PROBE_READ(name) \\
    extern "C" int name(unsigned long long* out, int zero) { \\
        unsigned long long z[64] = {}; \\
        return (int)(zero ? cudaMemcpyToSymbol(g_stamps, z, sizeof(z)) \\
                          : cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps))); }
"""
_EDITS = [
    ("csrc/psgd.cuh", "#pragma once\n", "#pragma once\n#include <cuda_runtime.h>\n" + _PROBE),
    ("csrc/tri.cu", """        if (ph > ph0) cooperative_groups::this_grid().sync();
        tri_phase(b, ph, tsm);
    }""", """        if (ph > ph0) cooperative_groups::this_grid().sync();
        stamp(ph);
        tri_phase(b, ph, tsm);
    }
    stamp(-ph1);"""),
    ("csrc/tri.cu", "void plan_tri_inv(TriBatch& b) {", "PROBE_READ(probe_tri)\nvoid plan_tri_inv(TriBatch& b) {"),
    ("csrc/kron_dd.cu", """        if (ph) cooperative_groups::this_grid().sync();""",
     """        if (ph) cooperative_groups::this_grid().sync();
        stamp(ph);"""),
    ("csrc/kron_dd.cu", """            __syncthreads();  // the next task reuses the shared memory
        }
    }
}""", """            __syncthreads();  // the next task reuses the shared memory
        }
    }
    stamp(-P.nphases);
}
PROBE_READ(probe_mono)"""),
]


def _phases_child() -> int:
    """In the probed copy: the phases of each cooperative kernel."""
    import ctypes

    import torch
    from psgd_tf_tpu_torch import kron
    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build, kron_dd, tri

    lib = _build.lib()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def phases(fn, read):
        runs = []
        fn()
        torch.cuda.synchronize()
        for _ in range(7):
            buf = (ctypes.c_ulonglong * 64)()
            read(buf, 1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            read(buf, 0)
            t = list(buf)
            last = max(i for i in range(64) if t[i])
            runs.append([(t[i + 1] - t[i]) / 1e3 for i in range(last)])
        runs.sort(key=sum)
        r = runs[len(runs) // 2]
        return " ".join(f"{x:.1f}" for x in r) + f" | total {sum(r):.1f} us"

    def probes(shapes):
        return ([torch.randn(s, generator=g, device=dev) for s in shapes],
                [torch.randn(s, generator=g, device=dev) for s in shapes])

    us = []
    for s in LENET5:
        for n in s:
            u = torch.triu(0.1 / n**0.5 * torch.randn(n, n, generator=g, device=dev), 1)
            us.append(u + torch.diag(0.5 + torch.rand(n, generator=g, device=dev)))
    print("K3 LeNet5's ten factors, tri_kernel phases (leaves, P1/P2 a level, the last "
          "zeroing):", phases(lambda: tri.inverse_upper(us), lib.probe_tri), flush=True)
    for label, fmts, shapes in [("LeNet5", [("dense", "dense")] * 5, LENET5),
                                ("toy NMT", nmt.kron_formats(nmt.Config()),
                                 nmt.layer_shapes(nmt.Config()))]:
        sts = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
        with hopper.disabled():
            for _ in range(2):
                sts = kron.update_multi(sts, *probes(shapes), step=0.1)
        dxs, dgs = probes(shapes)
        with kron_dd.forced_route("mono"):
            print(f"K1 {label}, kron_mono_kernel phases:", phases(
                lambda: kron.update_multi(sts, dxs, dgs, 0.1), lib.probe_mono), flush=True)
    return 0


# --dense-steps: stamps in K12's pass 1, edits made in a copy of the port.
# Item D(p) stamps its start, its loads done, the running sum and the
# look-ahead taken, b_p formed (rows 0-4); item R(p, 1) its start, its loads
# done, b_p taken, its words put (rows 5-8); row 9 holds nothing.
_DENSE_PROBE = """
__device__ unsigned long long g_dense_stamps[10 * 1024];
__device__ __forceinline__ void dstamp(int row, int p) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    if (threadIdx.x == 0 && p < 1024) g_dense_stamps[row * 1024 + p] = t;
}
extern "C" int probe_dense(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_dense_stamps, sizeof(g_dense_stamps));
}
#define DP 128 """
_DENSE_EDITS = [
    ("csrc/dense.cu", "#define DP 128 ", _DENSE_PROBE),
    ("csrc/dense.cu", """    const bool two = c1 < nb;
    const size_t row0""", """    const bool two = c1 < nb;
    if (k <= 1) dstamp(k ? 5 : 0, p);
    const size_t row0"""),
    ("csrc/dense.cu", """    d_wait_copies();
    __syncthreads();
    if (k) d_rowdots""", """    d_wait_copies();
    __syncthreads();
    if (k <= 1) dstamp(k ? 6 : 1, p);
    if (k) d_rowdots"""),
    ("csrc/dense.cu", """            if (p >= 1) acc += d_take(A.la + (size_t)(p - 1) * DP + j);""",
     """            dstamp(2, p);
            if (p >= 1) acc += d_take(A.la + (size_t)(p - 1) * DP + j);
            dstamp(3, p);"""),
    ("csrc/dense.cu", """        if (t < DP) {
            d_put(A.bw + (size_t)p * DP + t, sb[t]);""", """        dstamp(4, p);
        if (t < DP) {
            d_put(A.bw + (size_t)p * DP + t, sb[t]);"""),
    ("csrc/dense.cu", """        if (t < DP) sb[t] = d_take(A.bw + (size_t)p * DP + t);
        __syncthreads();""", """        if (t < DP) sb[t] = d_take(A.bw + (size_t)p * DP + t);
        if (k == 1) dstamp(7, p);
        __syncthreads();"""),
    ("csrc/dense.cu", """                d_put(A.cw + (size_t)p * n + cc, (p ? d_take(A.cw + (size_t)(p - 1) * n + cc) : 0.f) + cv);
        }""", """                d_put(A.cw + (size_t)p * n + cc, (p ? d_take(A.cw + (size_t)(p - 1) * n + cc) : 0.f) + cv);
        }
        if (k == 1) dstamp(8, p);"""),
]


def _dense_steps_child() -> int:
    """In the probed copy: the steps of K12's pass-1 chain."""
    import ctypes

    import numpy as np
    import torch
    from psgd_tf_tpu_torch.ops.hopper import _build, dense_big

    lib = _build.lib()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for n in (1536, 3841, 16384):
        q = torch.triu(0.02 / n**0.5 * torch.randn(n, n, generator=g, device=dev))
        q += 0.8 * torch.eye(n, device=dev)
        v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
        rows = []
        for _ in range(5):  # five calls, the medians over panels of each, then of the calls
            dense_big.fused_update_apply(q, v, h, gr, 0.1)
            torch.cuda.synchronize()
            buf = np.zeros(10 * 1024, dtype=np.uint64)
            lib.probe_dense(ctypes.c_void_p(buf.ctypes.data))
            nb = (n + 127) // 128
            t = buf.reshape(10, 1024)[:9, :nb].astype(np.int64) / 1e3
            m = lambda x: float(np.median(x))
            rows.append([m(np.diff(t[3, 1:])), m(t[4, 1:] - t[3, 1:]), m(t[1] - t[0]),
                         m(t[7, :nb - 2] - t[4, :nb - 2]), m(t[8, :nb - 2] - t[7, :nb - 2]),
                         m(t[3, 2:] - t[2, 2:])])
        r = np.median(np.array(rows), axis=0)
        print(f"K12 n={n}, pass 1, us (medians over panels, then over five calls): a step of "
              f"the chain (D(p) taking the look-ahead) {r[0]:.2f}; D(p) look-ahead taken to b_p "
              f"formed {r[1]:.2f}; D(p) start to loads done {r[2]:.2f}; D(p) b_p formed to "
              f"R(p, 1) taking it {r[3]:.2f}; R(p, 1) b_p taken to its words put {r[4]:.2f}; "
              f"D(p) running sum taken to look-ahead taken {r[5]:.2f}", flush=True)
        del q
        torch.cuda.empty_cache()
    return 0


def _probed(edits, child: str) -> int:
    """Run this script with `child` in a copy of the port with `edits`
    (file, old, new) made, built in its own process."""
    import shutil

    here = Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory() as tmp:
        dst = Path(tmp) / "psgd_tf_tpu_torch"
        shutil.copytree(here / "psgd_tf_tpu_torch", dst,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for rel, old, new in edits:
            f = dst / rel
            text = f.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"profile_kron_chain: {old[:40]!r} is not in {rel} once")
            f.write_text(text.replace(old, new))
        rc = subprocess.run([sys.executable, __file__, child], cwd=tmp,
                            env={**os.environ, "PYTHONPATH": tmp}).returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return rc


def _dense() -> int:
    """--dense: K11 and K12 through `dense.update(_apply)`, a size a case."""
    import torch
    from psgd_tf_tpu_torch import dense
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build, dense_upd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"package {Path(dense_upd.__file__).resolve().parents[3]}; torch {torch.__version__}",
          flush=True)
    _build.lib()
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}
    for n in DENSE_N:
        q = torch.triu(0.02 / n**0.5 * torch.randn(n, n, generator=g, device=dev))
        q += 0.8 * torch.eye(n, device=dev)
        with hopper.disabled():
            for _ in range(2):
                q = dense_upd.fused_update(q, *(torch.randn(n, generator=g, device=dev)
                                                for _ in range(2)), 0.1)
        v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
        st = dense.DenseState(Q=q)
        name = dense.route(n, dev)
        big = n > 8192
        for label, fn, inner in [
                ("update", lambda: dense.update(st, v, h, 0.1),
                 lambda: dense_upd.launch(name, n, q, v, h, None, 0.1)),
                ("update+apply", lambda: dense.update_apply(st, v, h, gr, 0.1),
                 lambda: dense_upd.launch(name, n, q, v, h, gr, 0.1))]:
            _report(torch, f"{name} n={n} {label}", fn, [("dense_upd.launch", inner)],
                    20 if big else CALLS, 5 if big else TRACED, summary,
                    ("kernel", "gpu_memset"))
        del q, st
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


def _splu() -> int:
    """--splu: K16, K15, the fused apply, mono, the sharded K16 and K14."""
    import socket

    import torch
    import torch.distributed as dist
    from psgd_tf_tpu_torch.groups import lra, splu
    from psgd_tf_tpu_torch.ops.hopper import _build, lra_upd, splu_upd
    from psgd_tf_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"package {Path(splu_upd.__file__).resolve().parents[3]}; torch {torch.__version__}",
          flush=True)
    _build.lib()
    g = torch.Generator(device=dev).manual_seed(0)
    cats = ("kernel", "gpu_memset")
    summary = {}

    def case(n, r):
        st = splu.walked_state(n, r, g, dev)
        return st, [torch.randn(n, generator=g, device=dev) for _ in range(3)]

    def fields(st):
        return st.Lt, st.l3, st.U12, st.u3

    def report(label, fn, inners, big):
        _report(torch, label, fn, inners, 10 if big else CALLS, 5 if big else TRACED, summary,
                cats)

    for n, r in SPLU_N:
        st, (v, h, gr) = case(n, r)
        name = splu.route(r, n, dev)
        big = n >= 1 << 20
        report(f"{name} n={n} r={r} update", lambda: splu.update(st, v, h, 0.05),
               [("splu_upd.launch", lambda: splu_upd.launch(name, *fields(st), v, h, 0.05))], big)
        if (n, r) == (1 << 20, 10):
            report(f"splu_upd_apply n={n} r={r} update+apply",
                   lambda: splu_upd.fused_update(*fields(st), v, h, 0.05, g=gr), [], big)
            report(f"splu_upd_mono n={n} r={r} update+apply",
                   lambda: splu_upd.fused_update_apply_mono(*fields(st), v, h, gr, 0.05), [], big)
        del st, v, h, gr
        torch.cuda.empty_cache()
    # K15's wrapper: the one launch where the tree has it, else the chain
    k15 = getattr(splu_upd, "launch_mono", splu_upd.launch)
    for n, r in K15_N:
        st, (v, h, gr) = case(n, r)
        report(f"splu_one n={n} r={r} update", lambda: splu.update(st, v, h, 0.05),
               [(k15.__name__, lambda: k15("splu_one", *fields(st), v, h, 0.05))], False)
        report(f"splu_one n={n} r={r} update+apply",
               lambda: splu.update_apply(st, v, h, gr, 0.05),
               [(k15.__name__, lambda: k15("splu_one", *fields(st), v, h, 0.05, gr))], False)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh(data=1, shard=1, device=dev)
        n = 1 << 20
        for r in (10, 64):
            st, (v, h, gr) = case(n, r)
            fs = fields(st)
            for what, gg in (("update", None), ("update+apply", gr)):
                report(f"splu_upd_sharded one NCCL rank n={n} r={r} {what}",
                       lambda: splu_upd.fused_update_sharded(*fs, v, h, 0.05, mesh, None, gg),
                       [("launch_sharded", lambda: splu_upd.launch_sharded(
                           *fs, v, h, 0.05, n - r, mesh, gg))], True)
                report(f"{'splu_upd' if gg is None else 'splu_upd_apply'} n={n} r={r} {what}",
                       lambda: splu_upd.fused_update(*fs, v, h, 0.05, g=gg), [], True)
            del st, fs, v, h, gr
            torch.cuda.empty_cache()
        st = lra.init(torch.Generator().manual_seed(n), n, rank=10, init_scale=0.8, device=dev)
        v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
        report(f"lra_upd_sharded (K14) one NCCL rank n={n} r=10 update+apply",
               lambda: lra_upd.fused_update_apply_sharded(st.UV, st.d, v, h, gr, 0.05,
                                                          (False, True), mesh), [], True)
        report(f"lra_upd (K13) n={n} r=10 update+apply",
               lambda: lra_upd.fused_update_apply(st.UV, st.d, v, h, gr, 0.05, (False, True)),
               [], True)
    finally:
        dist.destroy_process_group()
    print(json.dumps(summary))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


def _apply_nd() -> int:
    """--apply-nd: K17 (norm, dense) through `kron_sparse_big.fused_apply_nd`."""
    import torch
    from psgd_tf_tpu_torch import kron
    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.ops.hopper import _build, kron_sparse_big as ksb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"package {Path(ksb.__file__).resolve().parents[3]}; torch {torch.__version__}",
          flush=True)
    _build.lib()
    g = torch.Generator(device=dev).manual_seed(0)
    ref = nmt.layer_shapes(nmt.ref_config())
    shapes = [APPLY_ND] + [s for s in ref if kron.auto_format(s) == ("norm", "dense")]
    summary = {}
    for m, n in shapes:
        ql = torch.stack([0.8 + 0.2 * torch.rand(m, generator=g, device=dev),
                          0.05 * torch.randn(m, generator=g, device=dev)])
        qr = torch.triu(0.02 / n**0.5 * torch.randn(n, n, generator=g, device=dev))
        qr += 0.8 * torch.eye(n, device=dev)
        G = torch.randn(m, n, generator=g, device=dev)
        R = qr.T @ qr
        big = m * n > 10**7
        call = getattr(ksb, "_apply_nd_call", None)
        inner = (lambda: call(ql, R, G)) if call else \
            (lambda: ksb._apply("nd", ql, R, G, "kron_sparse_big_apply_nd"))
        _report(torch, f"K17 nd {(m, n)}", lambda: ksb.fused_apply_nd(ql, qr, G),
                [("C call", inner)], 20 if big else CALLS, 5 if big else TRACED, summary)
        del ql, qr, G, R
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_kron_chain: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--phases"]:
        return _probed(_EDITS, "--phases-child")
    if sys.argv[1:] == ["--phases-child"]:
        return _phases_child()
    if sys.argv[1:] == ["--dense-steps"]:
        return _probed(_DENSE_EDITS, "--dense-steps-child")
    if sys.argv[1:] == ["--dense-steps-child"]:
        return _dense_steps_child()
    if sys.argv[1:2] == ["--stream"]:
        return _stream()
    if sys.argv[1:2] == ["--dense"]:
        return _dense()
    if sys.argv[1:2] == ["--splu"]:
        return _splu()
    if sys.argv[1:2] == ["--apply-nd"]:
        return _apply_nd()
    route = None
    if sys.argv[1:2] == ["--route"]:
        route = sys.argv[2]
    from psgd_tf_tpu_torch import kron
    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build, kron_dd, kron_multi, tri

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc}; {smi}", flush=True)
    _build.lib()
    g = torch.Generator(device=dev).manual_seed(0)

    def probes(shapes):
        return ([torch.randn(s, generator=g, device=dev) for s in shapes],
                [torch.randn(s, generator=g, device=dev) for s in shapes])

    def walked(fmts, shapes):
        sts = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
        with hopper.disabled():
            for _ in range(2):
                sts = kron.update_multi(sts, *probes(shapes), step=0.1)
        return sts

    def triu_factor(n):
        u = torch.triu(0.1 / n**0.5 * torch.randn(n, n, generator=g, device=dev), 1)
        return u + torch.diag(0.5 + torch.rand(n, generator=g, device=dev))

    cases = []
    for label, fmts, shapes in [("K1 LeNet5", [("dense", "dense")] * 5, LENET5),
                                ("K1 toy NMT", nmt.kron_formats(nmt.Config()),
                                 nmt.layer_shapes(nmt.Config()))]:
        sts, (dxs, dgs) = walked(fmts, shapes), probes(shapes)
        ents = [kron._oriented(st, dx, dg) for st, dx, dg in zip(sts, dxs, dgs)]
        args = ([e[0] for e in ents], [e[2] for e in ents], [e[3] for e in ents],
                [e[4].contiguous() for e in ents], [e[5].contiguous() for e in ents])
        cases.append((label, lambda sts=sts, dxs=dxs, dgs=dgs: kron.update_multi(
            sts, dxs, dgs, 0.1), [
                ("kron_multi.fused_update_multi", lambda args=args: kron_multi.fused_update_multi(
                    *args, 0.1)),
                ("kron_dd.launch", lambda args=args: kron_dd.launch(*args, 0.1, "kron_multi"))]))
    us = [triu_factor(n) for s in LENET5 for n in s]
    cases.append(("K3 LeNet5's ten factors", lambda: tri.inverse_upper(us), []))

    ctx = kron_dd.forced_route(route) if route else contextlib.nullcontext()
    summary = {}
    with ctx:
        for label, fn, inners in cases:
            _report(torch, label + (f" (route forced: {route})" if route else ""), fn, inners,
                    CALLS, TRACED, summary)
    print(json.dumps(summary))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
