#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (psgd_tf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA card (an
H100: the kernels are built for sm_90a). It builds the Hopper kernels from
`psgd_tf_tpu_torch/csrc/` (into `psgd_tf_tpu_torch/_build/`), checks each
against its plain PyTorch version at the shapes its path gives it, then
drives the port's three paths, each with the launch counts set to 0 just
before it and read just after:

  - LeNet5 with five (dense, dense) Kronecker preconditioners, exact Hvp,
    batch 64, the `mnist_lenet5` hyperparameters, on procedural digits
    (K1 with kind dd, K3);
  - the NMT model at the reference widths (12,424,273 parameters) with
    its mixed formats, FD Hvp, random tokens as the JAX package's bench
    draws them (K10, K6, K2, K3);
  - the NMT workload at its toy widths, as `nmt_attention.run()` runs it:
    1000 steps to a held-out token accuracy above 0.75 (K1 with mixed
    kinds, K3).

It exits non-zero, printing no result, when there is no CUDA device or any
phase fails. TF32 is off for matmuls and convolutions, so every comparison
is in full fp32.

Output: one line per phase; then a JSON line with every ported kernel
(launches on the paths, max abs error against the plain version, ms per
call with the kernel and with the plain version); then the card's name and
power limit; then, last, the line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

LENET_STEPS = 200
WARMUP = 20
NMT_REF_STEPS = 30
NMT_REF_WARMUP = 5
LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
TOL_K3 = 1e-5    # max |X - X_plain| / max |X_plain|: both exact fp32 inverses
TOL_K1 = 1e-4    # one update: GEMM sums in other orders, explicit inverse vs trsm
TOL_TRAJ = 5e-4  # 20 chained updates: ROADMAP's trajectory bound


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _abs(a, b) -> float:
    return (a - b).abs().max().item()


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


def _state_errs(got, ref):
    """(max relative, max absolute) difference over a list of KronStates."""
    pairs = [(a.ql, b.ql) for a, b in zip(got, ref, strict=True)]
    pairs += [(a.qr, b.qr) for a, b in zip(got, ref, strict=True)]
    return max(_rel(a, b) for a, b in pairs), max(_abs(a, b) for a, b in pairs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from psgd_tf_tpu_torch import PSGD, kron
    from psgd_tf_tpu_torch.data import mnist, translation
    from psgd_tf_tpu_torch.models import lenet5, nmt
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import _build, kron_dd, kron_sparse, tri
    from psgd_tf_tpu_torch.workloads import nmt_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []
    launches = {name: 0 for name in hopper.counts}  # summed over the three paths

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            print(f"FAIL {what}", flush=True)

    def path_counts() -> None:
        for name, n in hopper.counts.items():
            launches[name] += n

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

    def probes(shapes):
        return ([torch.randn(s, generator=g, device=dev) for s in shapes],
                [torch.randn(s, generator=g, device=dev) for s in shapes])

    def walked_states(fmts, shapes, steps=3):
        """KronStates walked `steps` plain updates off 0.8 I."""
        states = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
        with hopper.disabled():
            for _ in range(steps):
                states = kron.update_multi(states, *probes(shapes), step=0.1)
        return states

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
    k3_abs = max(_abs(a, b) for a, b in zip(got, ref))
    print(f"k3: sides {[u.shape[0] for u in us]} max rel err {k3_rel:.3e} "
          f"(tol {TOL_K3:.0e}) max abs err {k3_abs:.3e}", flush=True)
    check(k3_rel < TOL_K3, "k3 vs plain")
    k3_ms, k3_plain_ms = _time_ab(torch, hopper, lambda: tri.inverse_upper(lenet_us), 200)
    print(f"k3 time, LeNet5's ten factors: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms",
          flush=True)

    # 3. K1 (kind dd) on LeNet5's five layers, K2 on one (1024, 1024) and
    #    one (1, 10) layer, and a 20-step chained K1 trajectory
    dd = [("dense", "dense")] * len(LENET5)
    states = walked_states(dd, LENET5)
    dxs, dgs = probes(LENET5)
    got = kron.update_multi(states, dxs, dgs, step=0.1)
    torch.cuda.synchronize()
    with hopper.disabled():
        ref = kron.update_multi(states, dxs, dgs, step=0.1)
    k1_rel, k1_abs = _state_errs(got, ref)
    print(f"k1: LeNet5 layers max rel err {k1_rel:.3e} (tol {TOL_K1:.0e}) "
          f"max abs err {k1_abs:.3e}", flush=True)
    check(k1_rel < TOL_K1 and all(torch.isfinite(s.ql).all() and torch.isfinite(s.qr).all()
                                  for s in got), "k1 vs plain")
    k1_lenet_ms, k1_lenet_plain_ms = _time_ab(
        torch, hopper, lambda: kron.update_multi(states, dxs, dgs, step=0.1), 200)
    print(f"k1 time, LeNet5's five layers: kernel {k1_lenet_ms:.4f} ms, "
          f"plain {k1_lenet_plain_ms:.4f} ms", flush=True)

    k2_rel = k2_abs = 0.0
    for shape in [(1024, 1024), (1, 10)]:
        (st,) = walked_states([("dense", "dense")], [shape], steps=2)
        (dx,), (dg,) = probes([shape])
        a, b = kron_dd.fused_update(st.ql, st.qr, dx, dg, 0.1)
        torch.cuda.synchronize()
        ra, rb = kron_dd.update_plain(st.ql, st.qr, dx, dg, 0.1)
        rel, err = max(_rel(a, ra), _rel(b, rb)), max(_abs(a, ra), _abs(b, rb))
        k2_rel, k2_abs = max(k2_rel, rel), max(k2_abs, err)
        print(f"k2: {shape} layer max rel err {rel:.3e} (tol {TOL_K1:.0e})", flush=True)
    k2_ms, k2_plain_ms = _time_ab(
        torch, hopper, lambda: kron_dd.fused_update(st.ql, st.qr, dx, dg, 0.1), 200)
    print(f"k2 time, (1, 10) layer: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms",
          flush=True)
    check(k2_rel < TOL_K1, "k2 vs plain")

    def trajectory(fmts, shapes):
        """20 chained K1 updates against a plain replay from 0.8 I."""
        kst = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
        pst = kst
        for _ in range(20):
            dxs, dgs = probes(shapes)
            kst = kron.update_multi(kst, dxs, dgs, step=0.1)
            with hopper.disabled():
                pst = kron.update_multi(pst, dxs, dgs, step=0.1)
        return _state_errs(kst, pst)[0]

    traj_rel = trajectory(dd, LENET5)
    print(f"k1 trajectory: LeNet5, 20 steps max rel err {traj_rel:.3e} (tol {TOL_TRAJ:.0e})",
          flush=True)
    check(traj_rel < TOL_TRAJ, "k1 20-step trajectory vs plain")

    # 4. K1 with mixed kinds on the toy NMT list: [ds, ns, ds, dd, ds, ns, ns]
    toy = nmt.Config()
    nmt_fmts, toy_shapes = nmt.kron_formats(toy), nmt.layer_shapes(toy)
    toy_routes = [kron.route(f, s, dev) for f, s in zip(nmt_fmts, toy_shapes)]
    check(toy_routes == ["kron_sparse:ds", "kron_sparse:ns", "kron_sparse:ds", "kron_dd",
                         "kron_sparse:ds", "kron_sparse:ns", "kron_sparse:ns"],
          f"toy NMT routes {toy_routes}")
    states = walked_states(nmt_fmts, toy_shapes)
    dxs, dgs = probes(toy_shapes)
    before = hopper.counts["kron_multi"]
    got = kron.update_multi(states, dxs, dgs, step=0.1)
    torch.cuda.synchronize()
    check(hopper.counts["kron_multi"] == before + 1, "toy NMT list takes one K1 call")
    with hopper.disabled():
        ref = kron.update_multi(states, dxs, dgs, step=0.1)
    mix_rel, mix_abs = _state_errs(got, ref)
    arrows_ok = all(q[1, -1].item() == 0.0 for s in got for q, f in zip((s.ql, s.qr), s.fmt)
                    if f == "norm")
    print(f"k1 mixed: toy NMT layers max rel err {mix_rel:.3e} (tol {TOL_K1:.0e}) "
          f"max abs err {mix_abs:.3e}, arrow ql[1][-1] == 0: {arrows_ok}", flush=True)
    check(mix_rel < TOL_K1 and arrows_ok, "k1 mixed kinds vs plain")
    k1_ms, k1_plain_ms = _time_ab(
        torch, hopper, lambda: kron.update_multi(states, dxs, dgs, step=0.1), 200)
    print(f"k1 time, toy NMT's seven layers: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms",
          flush=True)
    mix_traj = trajectory(nmt_fmts, toy_shapes)
    print(f"k1 mixed trajectory: toy NMT, 20 steps max rel err {mix_traj:.3e} "
          f"(tol {TOL_TRAJ:.0e})", flush=True)
    check(mix_traj < TOL_TRAJ, "k1 mixed 20-step trajectory vs plain")

    # 5. K5: one (norm, scale), (dense, scale) and (norm, dense) layer at (130, 65)
    k5_rel = k5_abs = 0.0
    k5_times = {}
    for kind, fmt in [("ns", ("norm", "scale")), ("ds", ("dense", "scale")),
                      ("nd", ("norm", "dense"))]:
        (st,) = walked_states([fmt], [(130, 65)])
        (dx,), (dg,) = probes([(130, 65)])
        fn = kron_sparse.FUSED_UPDATE[kind]
        before = hopper.counts["kron_sparse"]
        a, b = fn(st.ql, st.qr, dx, dg, 0.1)
        torch.cuda.synchronize()
        check(hopper.counts["kron_sparse"] == before + 1, f"k5 {kind} launched")
        ra, rb = kron_sparse.PLAIN[kind](st.ql, st.qr, dx, dg, 0.1)
        rel, err = max(_rel(a, ra), _rel(b, rb)), max(_abs(a, ra), _abs(b, rb))
        k5_rel, k5_abs = max(k5_rel, rel), max(k5_abs, err)
        arrow_ok = kind == "ds" or a[1, -1].item() == 0.0
        check(rel < TOL_K1 and arrow_ok, f"k5 {kind} vs plain")
        k5_times[kind] = _time_ab(torch, hopper, lambda: fn(st.ql, st.qr, dx, dg, 0.1), 200)
        print(f"k5 {kind}: (130, 65) max rel err {rel:.3e} (tol {TOL_K1:.0e}), arrow ok "
              f"{arrow_ok}, kernel {k5_times[kind][0]:.4f} ms, plain {k5_times[kind][1]:.4f} ms",
              flush=True)
    k5_ms = sum(t[0] for t in k5_times.values()) / 3
    k5_plain_ms = sum(t[1] for t in k5_times.values()) / 3

    # 6. K6 and K10 at the reference NMT layers, through kron.update (the
    #    (scale, dense) embeddings and attention are mirrored: K10 gets dX^T)
    ref_cfg = nmt.ref_config()
    ref_shapes = nmt.layer_shapes(ref_cfg)
    # per kernel: max abs error, and ms with the kernel and plain summed over
    # its three layers (one reference-width step's worth)
    big = {name: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
           for name in ("kron_sparse_big_ns", "kron_sparse_big_ds")}
    for fmt, shape in zip(nmt_fmts, ref_shapes):
        if fmt == ("dense", "dense"):
            continue
        name = "kron_sparse_big_ns" if fmt == ("norm", "scale") else "kron_sparse_big_ds"
        (st,) = walked_states([fmt], [shape], steps=2)
        (dx,), (dg,) = probes([shape])
        before = hopper.counts[name]
        got = kron.update(st, dx, dg, step=0.1)
        torch.cuda.synchronize()
        check(hopper.counts[name] == before + 1, f"{name} launched at {shape}")
        with hopper.disabled():
            ref = kron.update(st, dx, dg, step=0.1)
        rel, err = _state_errs([got], [ref])
        arrow_ok = fmt[0] != "norm" or got.ql[1, -1].item() == 0.0
        check(rel < TOL_K1 and arrow_ok, f"{name} vs plain at {shape}")
        ms, plain_ms = _time_ab(torch, hopper, lambda: kron.update(st, dx, dg, step=0.1), 50)
        acc = big[name]
        acc["err"] = max(acc["err"], err)
        acc["ms"] += ms
        acc["plain_ms"] += plain_ms
        print(f"{name}: {fmt} {shape} max rel err {rel:.3e} (tol {TOL_K1:.0e}) max abs err "
              f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)

    # 7. path: LeNet5, exact Hvp, batch 64
    params = lenet5.init(g)
    n_params = sum(p.numel() for p in params)
    opt = PSGD(preconditioner="kron", kron_formats=dd, lr_params=0.1, lr_preconditioner=0.1,
               grad_clip_max_norm=0.1 * math.sqrt(n_params))
    state = opt.init(params)
    routes = [kron.route(st.fmt, (st.ql.shape[0], st.qr.shape[0]), dev) for st in state.precond]
    check(routes == ["kron_dd"] * 5, f"LeNet5 routes {routes}")
    batches = [mnist.synthetic_hard(g, 64) for _ in range(LENET_STEPS)]
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
    counts = dict(hopper.counts)
    path_counts()
    steps_per_s = (LENET_STEPS - WARMUP) / (ev0.elapsed_time(ev1) / 1e3)
    losses = torch.stack(losses).cpu()
    first, last20 = losses[0].item(), losses[-20:].mean().item()
    print(f"lenet5: {LENET_STEPS} steps, routes {routes}, launches {counts}, loss {first:.4f} "
          f"-> mean of last 20 {last20:.4f}, {steps_per_s:.1f} steps/s with kernels", flush=True)
    check(counts["kron_multi"] == LENET_STEPS, "LeNet5: K1 launched once per step")
    check(counts["tri"] == LENET_STEPS, "LeNet5: K3 launched once per step")
    check(bool(torch.isfinite(losses).all()), "LeNet5: finite losses")
    check(last20 < 0.5 * first, "LeNet5: loss falls below half its first value")

    with hopper.disabled():
        for i, (x, y) in enumerate(batches[: WARMUP + 100]):
            if i == WARMUP:
                ev0.record()
            params, state, aux = opt.step(lenet5.loss, params, state, g, x, y)
        ev1.record()
        ev1.synchronize()
    plain_steps_per_s = 100 / (ev0.elapsed_time(ev1) / 1e3)
    print(f"lenet5: {plain_steps_per_s:.1f} steps/s under disabled() (plain versions)",
          flush=True)

    # 8. path: NMT at the reference widths, FD Hvp, lr 0.02, clip 1.0,
    #    random ids per vocabulary (batch 64, source 18, target 13)
    def nmt_ref_run():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = nmt.init(gen, ref_cfg)
        opt = PSGD(preconditioner="kron", kron_formats=nmt_fmts, lr_params=0.02,
                   lr_preconditioner=0.02, grad_clip_max_norm=1.0,
                   exact_hessian_vector_product=False)
        state = opt.init(params)
        routes = [kron.route(st.fmt, (st.ql.shape[-1], st.qr.shape[-1]), dev)
                  for st in state.precond]
        batches = [translation.random_tokens(gen, ref_cfg.vocab_src, ref_cfg.vocab_tgt)
                   for _ in range(NMT_REF_STEPS)]
        losses = []
        torch.cuda.synchronize()
        hopper.reset_counts()
        for i, (src, tgt) in enumerate(batches):
            if i == NMT_REF_WARMUP:
                ev0.record()
            params, state, aux = opt.step(nmt.loss, params, state, gen, src, tgt)
            losses.append(aux["loss"])
        ev1.record()
        ev1.synchronize()
        rate = (NMT_REF_STEPS - NMT_REF_WARMUP) / (ev0.elapsed_time(ev1) / 1e3)
        return routes, torch.stack(losses).cpu(), dict(hopper.counts), rate

    routes, losses, counts, ref_rate = nmt_ref_run()
    path_counts()
    want = ["kron_sparse_big:ds", "kron_sparse_big:ns", "kron_sparse_big:ds", "kron_dd",
            "kron_sparse_big:ds", "kron_sparse_big:ns", "kron_sparse_big:ns"]
    print(f"nmt ref: {NMT_REF_STEPS} steps, {sum(m * n for m, n in ref_shapes)} parameters, "
          f"routes {routes}, launches {counts}, loss {losses[0].item():.4f} -> "
          f"{losses[-1].item():.4f}, {ref_rate:.2f} steps/s with kernels", flush=True)
    check(routes == want, f"NMT reference routes {routes}")
    per_step = {"kron_sparse_big_ds": 3, "kron_sparse_big_ns": 3, "kron_dd": 1,
                "kron_multi": 0, "tri": 4}
    for name, n in per_step.items():
        check(counts[name] == n * NMT_REF_STEPS, f"NMT reference: {n} {name} launches per step")
    check(bool(torch.isfinite(losses).all()), "NMT reference: finite losses")
    with hopper.disabled():
        _, plain_losses, _, ref_plain_rate = nmt_ref_run()
    print(f"nmt ref: {ref_plain_rate:.2f} steps/s under disabled() (plain versions), loss "
          f"{plain_losses[0].item():.4f} -> {plain_losses[-1].item():.4f}", flush=True)

    # 9. path: the NMT workload at its toy widths, as nmt_attention.run() runs it
    torch.cuda.synchronize()
    hopper.reset_counts()
    t0 = time.perf_counter()
    out = nmt_attention.run(device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(hopper.counts)
    path_counts()
    print(f"nmt toy: {out['steps']} steps, launches {counts}, loss {out['first_loss']:.4f} -> "
          f"{out['loss']:.4f}, held-out token accuracy {out['token_accuracy']:.4f} (bar 0.75), "
          f"{out['steps'] / seconds:.1f} steps/s with kernels (host clock, init and eval "
          f"included)", flush=True)
    check(counts["kron_multi"] == out["steps"], "NMT toy: K1 launched once per step")
    check(math.isfinite(out["loss"]), "NMT toy: finite loss")
    check(out["token_accuracy"] > 0.75, "NMT toy: token accuracy above 0.75")

    for name in ("kron_multi", "kron_dd", "tri", "kron_sparse_big_ns", "kron_sparse_big_ds"):
        check(launches[name] > 0, f"{name} launched on the paths")
    if failures:
        print(f"chip_smoke: {len(failures)} phase(s) failed: {failures}", file=sys.stderr)
        return 1
    src = "psgd_tf_tpu_torch/csrc/"
    pallas = "psgd_tf_tpu/ops/pallas/"
    kernels = [
        {"name": "kron_multi", "route": "cuda", "source": src + "kron_dd.cu",
         "replaces": pallas + "kron_multi.py:222", "launches": launches["kron_multi"],
         "max_abs_err": max(k1_abs, mix_abs), "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "kron_dd", "route": "cuda", "source": src + "kron_dd.cu",
         "replaces": pallas + "kron_dd.py:181", "launches": launches["kron_dd"],
         "max_abs_err": k2_abs, "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "tri", "route": "cuda", "source": src + "tri.cu",
         "replaces": pallas + "tri.py:94", "launches": launches["tri"],
         "max_abs_err": k3_abs, "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "kron_sparse", "route": "cuda", "source": src + "kron_dd.cu",
         "replaces": pallas + "kron_sparse.py:293", "launches": launches["kron_sparse"],
         "max_abs_err": k5_abs, "ms": k5_ms, "plain_ms": k5_plain_ms},
    ]
    for name, line in [("kron_sparse_big_ns", 377), ("kron_sparse_big_ds", 711)]:
        acc = big[name]
        kernels.append({"name": name, "route": "cuda", "source": src + "kron_sparse_big.cu",
                        "replaces": f"{pallas}kron_sparse_big.py:{line}",
                        "launches": launches[name], "max_abs_err": acc["err"], "ms": acc["ms"],
                        "plain_ms": acc["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
