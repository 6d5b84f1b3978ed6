#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (psgd_tf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA card (an
H100: the kernels are built for sm_90a). It builds the Hopper kernels from
`psgd_tf_tpu_torch/csrc/` (into `psgd_tf_tpu_torch/_build/`), checks each
against its plain PyTorch version, then drives the port's main path:
LeNet5 with five (dense, dense) Kronecker preconditioners, exact Hvp,
batch 64, the `mnist_lenet5` hyperparameters, on procedural digits. It
exits non-zero, printing no result, when there is no CUDA device or any
phase fails. TF32 is off for matmuls and convolutions, so every comparison
is in full fp32.

Output: one line per phase; then a JSON line with each kernel of the main
path (launches in the main-path run, max abs error against the plain
version, ms per call at LeNet5 shapes with the kernel and the plain
version); then the card's name and power limit; then, last, the line
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

STEPS = 200
WARMUP = 20
LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
TOL_K3 = 1e-5    # max |X - X_plain| / max |X_plain|: both exact fp32 inverses
TOL_K1 = 1e-4    # one update: GEMM sums in other orders, explicit inverse vs trsm
TOL_TRAJ = 5e-4  # 20 chained updates: ROADMAP's trajectory bound


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _time_ab(torch, hopper, fn, reps):
    """ms per call of fn() with the kernels and under hopper.disabled(),
    from CUDA events, in turns plain, kernel, kernel, plain."""
    def once():
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

    ms = {"kernel": [], "plain": []}
    for mode in ("plain", "kernel", "kernel", "plain"):
        if mode == "plain":
            with hopper.disabled():
                ms[mode].append(once())
        else:
            ms[mode].append(once())
    return sum(ms["kernel"]) / 2, sum(ms["plain"]) / 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from psgd_tf_tpu_torch import PSGD, kron
    from psgd_tf_tpu_torch.data import mnist
    from psgd_tf_tpu_torch.models import lenet5
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build, kron_dd, kron_multi, tri

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            print(f"FAIL {what}", flush=True)

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    g = torch.Generator(device=dev).manual_seed(0)

    # 2. K3 at LeNet5's ten factor sides and at 1024
    def triu_factor(n):
        u = torch.triu(0.1 / n**0.5 * torch.randn(n, n, generator=g, device=dev), 1)
        return u + torch.diag(0.5 + torch.rand(n, generator=g, device=dev))

    lenet_us = [triu_factor(n) for s in LENET5 for n in s]
    us = lenet_us + [triu_factor(1024)]
    got = tri.inverse_upper(us)
    torch.cuda.synchronize()
    ref = tri.inverse_upper_plain(us)
    k3_rel = max(_rel(a, b) for a, b in zip(got, ref))
    k3_abs = max((a - b).abs().max().item() for a, b in zip(got, ref))
    print(f"k3: sides {[u.shape[0] for u in us]} max rel err {k3_rel:.3e} "
          f"(tol {TOL_K3:.0e}) max abs err {k3_abs:.3e}", flush=True)
    check(k3_rel < TOL_K3, "k3 vs plain")
    k3_ms, k3_plain_ms = _time_ab(torch, hopper, lambda: tri.inverse_upper(lenet_us), 200)
    print(f"k3 time, LeNet5's ten factors: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms",
          flush=True)

    # 3. K1 on LeNet5's five layers, K2 on one (1024, 1024) layer, and a
    #    20-step chained K1 trajectory against a plain replay
    def walked(shapes, steps=3):
        qls = [0.8 * torch.eye(m, device=dev) for m, _ in shapes]
        qrs = [0.8 * torch.eye(n, device=dev) for _, n in shapes]
        with hopper.disabled():
            for _ in range(steps):
                qls, qrs = kron_multi.fused_update_multi(
                    qls, qrs, *probes(shapes), 0.1)
        return qls, qrs

    def probes(shapes):
        return ([torch.randn(s, generator=g, device=dev) for s in shapes],
                [torch.randn(s, generator=g, device=dev) for s in shapes])

    qls, qrs = walked(LENET5)
    dxs, dgs = probes(LENET5)
    nql, nqr = kron_multi.fused_update_multi(qls, qrs, dxs, dgs, 0.1)
    torch.cuda.synchronize()
    with hopper.disabled():
        rql, rqr = kron_multi.fused_update_multi(qls, qrs, dxs, dgs, 0.1)
    k1_rel = max(_rel(a, b) for a, b in zip(nql + nqr, rql + rqr))
    k1_abs = max((a - b).abs().max().item() for a, b in zip(nql + nqr, rql + rqr))
    print(f"k1: LeNet5 layers max rel err {k1_rel:.3e} (tol {TOL_K1:.0e}) "
          f"max abs err {k1_abs:.3e}", flush=True)
    check(k1_rel < TOL_K1 and all(torch.isfinite(t).all() for t in nql + nqr), "k1 vs plain")
    k1_ms, k1_plain_ms = _time_ab(
        torch, hopper, lambda: kron_multi.fused_update_multi(qls, qrs, dxs, dgs, 0.1), 200)
    print(f"k1 time, LeNet5's five layers: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms",
          flush=True)

    (ql,), (qr,) = walked([(1024, 1024)], steps=2)
    (dx,), (dg,) = probes([(1024, 1024)])
    a, b = kron_dd.fused_update(ql, qr, dx, dg, 0.1)
    torch.cuda.synchronize()
    ra, rb = kron_dd.update_plain(ql, qr, dx, dg, 0.1)
    k2_rel = max(_rel(a, ra), _rel(b, rb))
    print(f"k2: (1024, 1024) layer max rel err {k2_rel:.3e} (tol {TOL_K1:.0e})", flush=True)
    check(k2_rel < TOL_K1, "k2 vs plain")

    tql = [0.8 * torch.eye(m, device=dev) for m, _ in LENET5]
    tqr = [0.8 * torch.eye(n, device=dev) for _, n in LENET5]
    pql, pqr = tql, tqr
    for _ in range(20):
        dxs, dgs = probes(LENET5)
        tql, tqr = kron_multi.fused_update_multi(tql, tqr, dxs, dgs, 0.1)
        with hopper.disabled():
            pql, pqr = kron_multi.fused_update_multi(pql, pqr, dxs, dgs, 0.1)
    traj_rel = max(_rel(a, b) for a, b in zip(tql + tqr, pql + pqr))
    print(f"k1 trajectory: 20 steps max rel err {traj_rel:.3e} (tol {TOL_TRAJ:.0e})", flush=True)
    check(traj_rel < TOL_TRAJ, "k1 20-step trajectory vs plain")

    # 4. the main path: PSGD on LeNet5, exact Hvp, batch 64
    params = lenet5.init(g)
    n_params = sum(p.numel() for p in params)
    opt = PSGD(preconditioner="kron", kron_formats=[("dense", "dense")] * 5,
               lr_params=0.1, lr_preconditioner=0.1,
               grad_clip_max_norm=0.1 * math.sqrt(n_params))
    state = opt.init(params)
    routes = [kron.route(st.fmt, (st.ql.shape[0], st.qr.shape[0]), dev) for st in state.precond]
    check(routes == ["kron_dd"] * 5, f"routes {routes}")
    batches = [mnist.synthetic_hard(g, 64) for _ in range(STEPS)]
    losses = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    hopper.reset_counts()
    for i, (x, y) in enumerate(batches):
        if i == WARMUP:
            ev0.record()
        params, state, aux = opt.step(lenet5.loss, params, state, g, x, y)
        losses.append(aux["loss"])
    ev1.record()
    ev1.synchronize()
    launches = dict(hopper.counts)
    steps_per_s = (STEPS - WARMUP) / (ev0.elapsed_time(ev1) / 1e3)
    losses = torch.stack(losses).cpu()
    first, last20 = losses[0].item(), losses[-20:].mean().item()
    print(f"main: {STEPS} steps, routes {routes}, launches {launches}, loss {first:.4f} -> "
          f"mean of last 20 {last20:.4f}, {steps_per_s:.1f} steps/s with kernels", flush=True)
    check(launches["kron_multi"] == STEPS, "K1 launched once per step")
    check(launches["tri"] == STEPS, "K3 launched once per step")
    check(bool(torch.isfinite(losses).all()), "finite losses")
    check(last20 < 0.5 * first, "loss falls below half its first value")

    with hopper.disabled():
        for i, (x, y) in enumerate(batches[: WARMUP + 100]):
            if i == WARMUP:
                ev0.record()
            params, state, aux = opt.step(lenet5.loss, params, state, g, x, y)
        ev1.record()
        ev1.synchronize()
    plain_steps_per_s = 100 / (ev0.elapsed_time(ev1) / 1e3)
    print(f"main: {plain_steps_per_s:.1f} steps/s under disabled() (plain versions)", flush=True)

    if failures:
        print(f"chip_smoke: {len(failures)} phase(s) failed: {failures}", file=sys.stderr)
        return 1
    kernels = [
        {"name": "kron_multi", "route": "cuda", "source": "psgd_tf_tpu_torch/csrc/kron_dd.cu",
         "replaces": "psgd_tf_tpu/ops/pallas/kron_multi.py:222",
         "launches": launches["kron_multi"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "tri", "route": "cuda", "source": "psgd_tf_tpu_torch/csrc/tri.cu",
         "replaces": "psgd_tf_tpu/ops/pallas/tri.py:94",
         "launches": launches["tri"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
