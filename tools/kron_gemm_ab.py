#!/usr/bin/env python3
"""Time every chain that shares the grouped fp32 GEMM of `csrc/kron_dd.cu`,
in two checkouts of the port on one card, or probe this tree's tuning.

    python3 tools/kron_gemm_ab.py OTHER_TREE
    python3 tools/kron_gemm_ab.py --sweep
    python3 tools/kron_gemm_ab.py --generic
    python3 tools/kron_gemm_ab.py --gram
    python3 tools/kron_gemm_ab.py --gemm
    python3 tools/kron_gemm_ab.py --route
    python3 tools/kron_gemm_ab.py --tri
    python3 tools/kron_gemm_ab.py --k4

Run from the root of the repository on a machine with one CUDA card.
OTHER_TREE is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a directory `.gitignore` lists).
Each tree runs in its own process, in the order other, this, this, other,
so a drift of the card or the host shows as a spread between the two runs
of one tree. Each process builds its tree's kernels and times (CUDA events
over chained calls, TF32 off), at the shapes of the paths:

  - K9, (norm, dense) through `kron.update` and its kernel part alone
    (`kron_sparse_big.nd_reductions`): bench.py's kron_nd row
    (131072, 512), the reference NMT model's widest such layer
    (2305, 1024), and the five layers PSGD's default formats give that
    model (K9's launches on its path), summed;
  - K10, (dense, scale): the reference NMT model's three such layers
    (mirrored (scale, dense): K10 reads dX^T), summed and one by one,
    through `kron.update` (and its kernel part alone, `ds_reductions`,
    where the tree has one);
  - K6, (norm, scale): the reference NMT model's three such layers, summed
    and one by one, through `kron.update`; K7 at (512, 1,000,000) and K8 at
    (64, 3,000,017), through `kron.update`;
  - the reference NMT model's PSGD step under its hand formats (K10 x3, K6
    x3, K2 a step), the same step from the same state each call (its
    probes reseeded), FD Hvp, as `chip_smoke.py` drives it: 1000 / ms is
    its steps/s;
  - K17 nd, `kron_sparse_big.fused_apply_nd` at (131072, 512);
  - K1, `kron.update_multi` on LeNet5's five (dense, dense) layers and on
    the toy NMT model's seven layers of mixed kinds;
  - K4, `kron.update_batched` on the buckets of `chip_smoke.py`'s phase
    3c (the K4 path's: the NMT model at embed 16, units 32, four (dense,
    dense) layers in one (128, 128) stack; the ragged one; B = 6 and 24 of
    (200, 256); B = 4 of (1000, 1000); B = 48 of (768, 768)), each beside
    K1 on the same layers unbatched (`kron.update_multi`);
  - K20, `kron_dd.fused_update_multi` on 18 layers (two chains);
  - K2, `kron_dd.fused_update` at (1, 10) and (1024, 1024); K5, the three
    `kron_sparse` kinds at (130, 65);
  - K13, `lra_upd.fused_update_apply`, and K16, `splu_upd.fused_update`, at
    n = 2^20 and r = 10 and 64 (they share no GEMM: they guard the rank
    repair; a tree with the rank-32 cap reports that it raises);
  - K3, `tri.inverse_upper` on LeNet5's ten factors, and the other chains
    that run it: K11 (`dense_upd.fused_update_apply`, n = 1536), K12
    (`dense_big.fused_update_apply`, n = 16384); and K19,
    `tri.solve_triangular` at (2048, 512), which shares K3's old tile code.

Each chain prints its ms (the median of five windows, and the least), its
device ms ("queued": calls enqueued behind a spinning kernel, so the
host's enqueue never starves the card), its host ms a call (the host clock
around chained calls, no synchronise: the enqueue) and its max relative
difference from the plain version on the same inputs, and, after the four
runs,
whether this tree's output equals the other tree's bit for bit (or up to
the sign of zeros).
This tree also times the GEMM alone through its test entry
(`kron_dd.gemm`) at K9's shapes, as TFLOP/s.

`--sweep` times K9's kernel part at (131072, 512) and (2305, 1024) for
each cap on the Gram's row panels: one copy of this tree a cap, with
`ND_MAX_SPLITS` edited in its source, each built and run in its own
process. `--generic` times K13 and K16 at n = 2^20, r = 10 on this tree
and on a copy whose host takes the rank-generic chain at every rank.
`--gram` times K13 and K16 past rank 32, and their Grams inside the chain
(torch.profiler, by kernel), beside the same Grams made by the grouped
GEMM's test entry, one launch a block, with the tile and band count
forced, on rows staged by torch.
`--gemm` times the GEMM alone, beside cuBLAS's fp32 product of the same
shape. `--route` times the lists of K1's chain on both of its routes
(`kron_dd.forced_route`: the chain of launches and the one cooperative
launch), queued and chained, with the route `kron_dd.route` picks and
whether the two routes' outputs are bit-equal: the paths' lists and a
sweep of single (dense, dense) layers and dd lists by size, the sweep
that sets `KRON_MONO_MAX_MFLOP`. `--tri` times K3 and chains that run it
on this tree and on a copy that launches K3 a phase at a time instead of
in one cooperative launch. `--k4` times K4 at its buckets for each rule of
its GEMM stages' tiles: this tree, then one copy of it a rule with
`K4_BIG_TILES` edited in `csrc/kron_batched.cu`, each built and run in
its own process. Then the card's name and power limit.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

K9_SHAPES = [(131072, 512), (2305, 1024)]
WIDE_NS = [(512, 1_000_000), (64, 3_000_017)]  # K7's and K8's bench shapes
K17_SHAPE = (131072, 512)
LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
MULTI_18 = LENET5 * 3 + [(1, 10), (300, 7), (64, 64)]
K4_NMT = dict(vocab_src=1100, vocab_tgt=1030, embed=16, units=32)
# chip_smoke.py's phase 3c buckets beside the K4 path's
K4_BUCKETS = [("ragged", [(26, 6), (121, 84), (85, 10), (100, 128)]),
              ("B=6 (200, 256)", [(200, 256)] * 6), ("B=24 (200, 256)", [(200, 256)] * 24),
              ("B=4 (1000, 1000)", [(1000, 1000)] * 4), ("B=48 (768, 768)", [(768, 768)] * 48)]
# --k4's rules: K4_BIG_TILES, the 128 x 128 tiles an SM a stage's launch
# needs to take that tile (csrc/kron_batched.cu)
K4_RULES = [4, 2, 1]
FLAT = [(1 << 20, 10), (1 << 20, 64)]
GRAM = (1 << 20, (64, 128))   # --gram's n and ranks
GRAM_KERNELS = ("gemm_kernel", "gram_sum_kernel", "rows_kernel")  # the Grams' kernels past r = 32
SPLITS = [8, 32, 64, 128]
HERE = Path(__file__).resolve().parents[1]


def _time(torch, fn, reps, windows=5):
    """ms per call of fn(): the median and the least of `windows` windows,
    each from CUDA events over `reps` chained calls (the small chains are
    set by the host's enqueue, which drifts between windows)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    out.sort()
    return out[len(out) // 2], out[0]


def _time_queued(torch, fn, reps, windows=5):
    """Device ms per call of fn(): the median of `windows` windows of
    `reps` calls enqueued behind a spinning kernel (~20 ms), the events
    recorded after it, so the card runs the calls back to back whatever
    the host's enqueue costs."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    out.sort()
    return out[len(out) // 2]


def _host_ms(torch, fn, reps):
    """Host ms a call: the host clock around `reps` chained calls with no
    synchronise between them (the enqueue the caller waits for)."""
    import time

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _flat(out):
    """The tensors of a chain's output, flattened in order."""
    import torch

    if torch.is_tensor(out):
        return [out]
    if hasattr(out, "ql"):
        return [out.ql, out.qr]
    return [t for x in out for t in _flat(x)]


def _setup(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from psgd_tf_tpu_torch.ops.hopper import _build

    if not torch.cuda.is_available():
        raise SystemExit("kron_gemm_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    return torch


def _chains(torch, dev, only=()):
    """(name, call, reps) of every chain (of those named in `only`); each
    group's inputs made here from a seed of its own, so both trees, and a
    run of a few chains, see the same ones."""
    from psgd_tf_tpu_torch import kron, lra, splu
    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import (dense_big, dense_upd, kron_dd, kron_sparse,
                                              kron_sparse_big, lra_upd, splu_upd, tri)

    g = torch.Generator(device=dev)

    def want(seed, *prefixes):
        """Whether a group of chains is asked for; reseeds its inputs."""
        g.manual_seed(seed)
        return not only or any(o.startswith(p) for o in only for p in prefixes)

    def probes(shapes):
        return ([torch.randn(s, generator=g, device=dev) for s in shapes],
                [torch.randn(s, generator=g, device=dev) for s in shapes])

    def walked(fmts, shapes, steps=2):
        sts = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
        with hopper.disabled():
            for _ in range(steps):
                sts = kron.update_multi(sts, *probes(shapes), step=0.1)
        return sts

    out = []
    ND, DD = ("norm", "dense"), ("dense", "dense")
    ref = nmt.ref_config()
    fmts, shapes = nmt.kron_formats(ref), nmt.layer_shapes(ref)
    nd_shapes = [s for s in shapes if kron.auto_format(s) == ND]
    ds = [(f, s) for f, s in zip(fmts, shapes) if f in (("scale", "dense"), ("dense", "scale"))]
    for k, shape in enumerate(K9_SHAPES):
        if not want(k, f"K9 update {shape}", f"K9 kernel part {shape}"):
            continue
        (st,), ((dx,), (dg,)) = walked([ND], [shape]), probes([shape])
        w = st.ql[1] / (st.ql[0] * st.ql[0][-1])
        u = dg[-1] @ st.qr.T
        reps = 10 if shape[0] > 10**5 else 50
        out.append((f"K9 update {shape}", lambda st=st, dx=dx, dg=dg: kron.update(st, dx, dg, 0.1),
                    reps))
        out.append((f"K9 kernel part {shape}",
                    lambda st=st, dx=dx, dg=dg, w=w, u=u: kron_sparse_big.nd_reductions(
                        dx, dg, st.ql, w, st.qr, u), reps))
    nd_name = f"{len(nd_shapes)} ref NMT auto layers"
    if want(10, f"K9 {nd_name}", f"K9 kernel part {nd_name}"):
        nd_states = walked([ND] * len(nd_shapes), nd_shapes)
        nd_dx, nd_dg = probes(nd_shapes)
        nd_kern = [(dx, dg, st.ql, st.ql[1] / (st.ql[0] * st.ql[0][-1]), st.qr, dg[-1] @ st.qr.T)
                   for st, dx, dg in zip(nd_states, nd_dx, nd_dg)]
        out.append((f"K9 {nd_name}", lambda: [kron.update(st, dx, dg, 0.1) for st, dx, dg in
                                              zip(nd_states, nd_dx, nd_dg)], 20))
        out.append((f"K9 kernel part {nd_name}",
                    lambda: [kron_sparse_big.nd_reductions(*o) for o in nd_kern], 20))
    if want(11, "K10"):
        ds_states = [walked([f], [s])[0] for f, s in ds]
        ds_probes = [probes([s]) for _, s in ds]
        out.append((f"K10 {len(ds)} ref NMT layers",
                    lambda: [kron.update(st, dx, dg, 0.1) for st, ((dx,), (dg,)) in
                             zip(ds_states, ds_probes)], 20))
        for (_, shape), st, ((dx,), (dg,)) in zip(ds, ds_states, ds_probes):
            out.append((f"K10 {shape}", lambda st=st, dx=dx, dg=dg: kron.update(st, dx, dg, 0.1),
                        50))
        # K10's kernel part alone on each layer's canonical (dense m, scale n)
        # pair, its probes the transposed views a mirrored layer hands it
        k10 = []
        for f, (rows, cols) in ds:
            m, n = (cols, rows) if f == ("scale", "dense") else (rows, cols)
            q = torch.triu(0.1 / m**0.5 * torch.randn(m, m, generator=g, device=dev), 1)
            q = q + torch.diag(0.5 + torch.rand(m, generator=g, device=dev))
            s_ = 0.5 + torch.rand(n, generator=g, device=dev)
            dx, dg = (torch.randn(n, m, generator=g, device=dev).T for _ in range(2))
            k10.append((q, s_, dx, dg))
        if hasattr(kron_sparse_big, "ds_reductions"):
            out.append((f"K10 kernel part {len(ds)} ref NMT layers",
                        lambda: [kron_sparse_big.ds_reductions(*o) for o in k10], 50))
    ns = [(f, s) for f, s in zip(fmts, shapes) if f == ("norm", "scale")]
    if want(40, "K6"):
        ns_states = [walked([f], [s])[0] for f, s in ns]
        ns_probes = [probes([s]) for _, s in ns]
        out.append((f"K6 {len(ns)} ref NMT layers",
                    lambda: [kron.update(st, dx, dg, 0.1) for st, ((dx,), (dg,)) in
                             zip(ns_states, ns_probes)], 20))
        for (_, shape), st, ((dx,), (dg,)) in zip(ns, ns_states, ns_probes):
            out.append((f"K6 {shape}", lambda st=st, dx=dx, dg=dg: kron.update(st, dx, dg, 0.1),
                        50))
    for k, shape in enumerate(WIDE_NS):
        name = f"{'K7' if k == 0 else 'K8'} {shape}"
        if want(41 + k, name):
            (st,), ((dx,), (dg,)) = walked([("norm", "scale")], [shape]), probes([shape])
            out.append((name, lambda st=st, dx=dx, dg=dg: kron.update(st, dx, dg, 0.1), 5))
    if want(43, "NMT ref step"):
        out.append(("NMT ref step (hand formats)", _nmt_step(torch, dev), 3))
    if want(12, "K17"):
        (ast,) = walked([ND], [K17_SHAPE])
        G = torch.randn(K17_SHAPE, generator=g, device=dev)
        out.append((f"K17 nd {K17_SHAPE}",
                    lambda: kron_sparse_big.fused_apply_nd(ast.ql, ast.qr, G), 10))
    for k, (label, fl, sh) in enumerate([("LeNet5", [DD] * 5, LENET5),
                                         ("toy NMT", nmt.kron_formats(nmt.Config()),
                                          nmt.layer_shapes(nmt.Config()))]):
        if want(13 + k, f"K1 {label}"):
            sts, (dxs, dgs) = walked(fl, sh), probes(sh)
            out.append((f"K1 {label}", lambda sts=sts, dxs=dxs, dgs=dgs: kron.update_multi(
                sts, dxs, dgs, 0.1), 100))
    k4_path = [s for s in nmt.layer_shapes(nmt.Config(**K4_NMT)) if kron.auto_format(s) == DD]
    for k, (label, shapes) in enumerate([("path bucket", k4_path)] + K4_BUCKETS):
        if not want(15 if k == 0 else 50 + k, f"K4 {label}", f"K1 unbatched {label}"):
            continue
        bst = kron.init_batched(shapes, init_scale=0.8, device=dev)
        with hopper.disabled():
            for _ in range(2):
                bst = kron.update_batched(bst, *probes(shapes), step=0.1)
        bdx, bdg = probes(shapes)
        reps = 5 if max(max(s) for s in shapes) > 512 else 100
        out.append((f"K4 {label}", lambda bst=bst, bdx=bdx, bdg=bdg: kron.update_batched(
            bst, bdx, bdg, 0.1), reps))
        singles = kron.unbatch(bst)
        out.append((f"K1 unbatched {label}", lambda singles=singles, bdx=bdx, bdg=bdg:
                    kron.update_multi(singles, bdx, bdg, 0.1), reps))
    if want(16, "K20"):
        sts20, (dxs20, dgs20) = walked([DD] * len(MULTI_18), MULTI_18), probes(MULTI_18)
        out.append(("K20 18 layers", lambda: kron_dd.fused_update_multi(
            [s.ql for s in sts20], [s.qr for s in sts20], dxs20, dgs20, 0.1), 50))
    for k, shape in enumerate([(1, 10), (1024, 1024)]):
        if want(17 + k, f"K2 {shape}"):
            (st,), ((dx,), (dg,)) = walked([DD], [shape]), probes([shape])
            out.append((f"K2 {shape}", lambda st=st, dx=dx, dg=dg: kron_dd.fused_update(
                st.ql, st.qr, dx, dg, 0.1), 100))
    for k, (kind, fmt) in enumerate([("ns", ("norm", "scale")), ("ds", ("dense", "scale")),
                                     ("nd", ND)]):
        if want(19 + k, f"K5 {kind}"):
            (st,), ((dx,), (dg,)) = walked([fmt], [(130, 65)]), probes([(130, 65)])
            fn = kron_sparse.FUSED_UPDATE[kind]
            out.append((f"K5 {kind} (130, 65)", lambda st=st, dx=dx, dg=dg, fn=fn: fn(
                st.ql, st.qr, dx, dg, 0.1), 100))
    if want(30, "K3"):
        us = [_triu(torch, g, dev, n) for s in LENET5 for n in s]
        out.append(("K3 LeNet5's ten factors", lambda: tri.inverse_upper(us), 200))
    for k, (n, name, mod) in enumerate([(1536, "K11", dense_upd), (16384, "K12", dense_big)]):
        if want(31 + k, name):
            q = torch.triu(0.02 / n**0.5 * torch.randn(n, n, generator=g, device=dev))
            q += 0.8 * torch.eye(n, device=dev)
            v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
            out.append((f"{name} n={n}", lambda q=q, v=v, h=h, gr=gr, mod=mod:
                        mod.fused_update_apply(q, v, h, gr, 0.1), 5 if n > 8192 else 50))
    if want(33, "K19"):
        q19 = _triu(torch, g, dev, 2048)
        b19 = torch.randn(2048, 512, generator=g, device=dev)
        out.append(("K19 (2048, 512)", lambda: tri.solve_triangular(q19, b19), 50))
    for k, (n, r) in enumerate(FLAT):
        if not want(22 + k, f"K13 n={n} r={r}", f"K16 n={n} r={r}"):
            continue
        lst = lra.init(torch.Generator().manual_seed(n), n, rank=r, init_scale=0.8, device=dev)
        v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
        out.append((f"K13 n={n} r={r}", lambda lst=lst, v=v, h=h, gr=gr: lra_upd.fused_update_apply(
            lst.UV, lst.d, v, h, gr, 0.05, (True, False)), 20))
        sst = splu.walked_state(n, r, g, dev)
        out.append((f"K16 n={n} r={r}", lambda sst=sst, v=v, h=h: splu_upd.fused_update(
            sst.Lt, sst.l3, sst.U12, sst.u3, v, h, 0.05), 20))
    return out


def _nmt_step(torch, dev):
    """One PSGD step of the NMT model at the reference widths under its
    hand formats, as chip_smoke.py's phase 10 drives it (FD Hvp, lr 0.02,
    clip 1.0, random tokens), from the same state and probes each call:
    returns the loss."""
    from psgd_tf_tpu_torch import PSGD
    from psgd_tf_tpu_torch.data import translation
    from psgd_tf_tpu_torch.models import nmt

    cfg = nmt.ref_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = nmt.init(gen, cfg)
    opt = PSGD(preconditioner="kron", lr_params=0.02, lr_preconditioner=0.02,
               grad_clip_max_norm=1.0, exact_hessian_vector_product=False,
               kron_formats=nmt.kron_formats(cfg))
    state = opt.init(params)
    src, tgt = translation.random_tokens(gen, cfg.vocab_src, cfg.vocab_tgt)

    def step():
        gen.manual_seed(1)
        return opt.step(nmt.loss, params, state, gen, src, tgt)[2]["loss"]

    return step


def _triu(torch, g, dev, n):
    """An upper-triangular factor as the walked Kronecker factors are."""
    u = torch.triu(0.1 / n**0.5 * torch.randn(n, n, generator=g, device=dev), 1)
    return u + torch.diag(0.5 + torch.rand(n, generator=g, device=dev))


def _gemm_rates(torch, dev):
    """This tree's GEMM alone at K9's (131072, 512): TFLOP/s of the dense
    product (2 m n^2), of the two triangular products K9 runs (m n^2 each,
    the K band cut) and of its split triu Gram difference (2 m n^2 kept)."""
    from psgd_tf_tpu_torch.ops.hopper import kron_dd

    if not hasattr(kron_dd, "gemm"):
        return "the GEMM has no test entry in this tree"
    m, n = 131072, 512
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(m, n, generator=g, device=dev)
    a2 = torch.randn(m, n, generator=g, device=dev)
    q = torch.triu(torch.randn(n, n, generator=g, device=dev))
    cases = [("dense product", 2 * m * n * n, lambda: kron_dd.gemm(m, n, n, a, 0, q, 0)),
             ("cuBLAS's dense product (torch.matmul, TF32 off)", 2 * m * n * n,
              lambda: torch.matmul(a, q)),
             ("triangular product (b_lower)", m * n * n,
              lambda: kron_dd.gemm(m, n, n, a, 0, q, 1, cut=("b_lower",))),
             ("triu Gram difference, 64 splits", 2 * m * n * n,
              lambda: kron_dd.gemm(n, n, m, a, 1, a, 0, a2, a2, epi="triu", splits=64))]
    out = []
    for name, flops, fn in cases:
        ms, _ = _time(torch, fn, 10)
        out.append(f"{name} {ms:.4f} ms {flops / ms / 1e9:.2f} TFLOP/s")
    return " | ".join(out)


def run_tree(tree: str, label: str, dump: str, only=()) -> None:
    """Time every chain (or those named in `only`) with the port of `tree`;
    save its outputs to `dump`."""
    torch = _setup(tree)
    from psgd_tf_tpu_torch.ops import hopper

    dev = torch.device("cuda")
    lines, saved = [], {}
    for name, call, reps in _chains(torch, dev, only):
        if only and name not in only:
            continue
        try:
            got = _flat(call())
        except ValueError as e:  # a tree with the rank-32 cap
            lines.append(f"{name}: raises ({str(e)[:60]})")
            continue
        with hopper.disabled():
            ref = _flat(call())
        rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                  for a, b in zip(got, ref))
        ms, least = _time(torch, call, reps)
        queued = _time_queued(torch, call, min(reps, 40))
        host = _host_ms(torch, call, reps)
        saved[name] = [t.cpu() for t in got]
        lines.append(f"{name}: {ms:.4f} ms (least {least:.4f}, queued {queued:.4f}, host "
                     f"{host:.4f}), max rel diff from plain {rel:.2e}")
        torch.cuda.empty_cache()
    torch.save(saved, dump)
    print(f"== {label} ({Path(tree).resolve()})", flush=True)
    for line in lines:
        print("  " + line, flush=True)
    if label == "this" and not only:
        print("  GEMM alone at (131072, 512): " + _gemm_rates(torch, dev), flush=True)


def _copy_tree(dst: Path, edits) -> Path:
    """This tree's port and tools copied to `dst`, each (file, old, new)
    edit made in the copy's source; the copy builds its own kernels."""
    for d in ("psgd_tf_tpu_torch", "tools"):
        shutil.copytree(HERE / d, dst / d, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in edits:
        f = dst / rel
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"kron_gemm_ab: {old!r} is not in {rel} once")
        f.write_text(text.replace(old, new))
    return dst


def _run_copies(runs, only) -> None:
    """Each (label, edits): a copy of this tree with the edits, its chains
    `only` timed in a process of its own."""
    with tempfile.TemporaryDirectory() as tmp:
        for k, (label, edits) in enumerate(runs):
            tree = _copy_tree(Path(tmp) / str(k), edits) if edits else HERE
            subprocess.run([sys.executable, __file__, "--tree", str(tree), label,
                            str(Path(tmp) / f"{k}.pt"), *only], check=True)
            if edits:
                shutil.rmtree(tree)


def sweep() -> None:
    """K9's kernel part for each cap on the Gram's row panels."""
    src = ("psgd_tf_tpu_torch/csrc/kron_sparse_big.cu", "#define ND_MAX_SPLITS 64 ")
    _run_copies([(f"ND_MAX_SPLITS {c}", [(*src, f"#define ND_MAX_SPLITS {c} ")]) for c in SPLITS],
                [f"K9 kernel part {shape}" for shape in K9_SHAPES])


def k4_rules() -> None:
    """K4 at its buckets under each rule of its stages' tiles."""
    src = "psgd_tf_tpu_torch/csrc/kron_batched.cu"
    runs = [(f"K4_BIG_TILES {t}", [(src, "#define K4_BIG_TILES 4 ", f"#define K4_BIG_TILES {t} ")]
             if t != 4 else None) for t in K4_RULES]
    _run_copies(runs, [f"K4 {label}" for label, _ in K4_BUCKETS])


def generic() -> None:
    """K13 and K16 at n = 2^20, r = 10: the rank-32 chain (this tree) and
    the rank-generic one (a copy that takes it at every rank)."""
    edits = [("psgd_tf_tpu_torch/csrc/lra.cu", "static bool lra_generic(int r) { return r > LRA_MAX_RANK; }",
              "static bool lra_generic(int) { return true; }"),
             ("psgd_tf_tpu_torch/csrc/splu.cu", "static bool splu_generic(int r) { return r > SPLU_MAX_RANK; }",
              "static bool splu_generic(int) { return true; }")]
    n, r = FLAT[0]
    only = [f"K13 n={n} r={r}", f"K16 n={n} r={r}"]
    _run_copies([("rank-32 chain", None), ("generic chain", edits), ("generic chain", edits),
                 ("rank-32 chain", None)], only)


def _kernel_ms(torch, fn, calls=5):
    """{kernel name: device ms a call of fn()} from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / calls
    return out


def gram() -> None:
    """K13's and K16's Grams past rank 32: in the chain, and through the
    grouped GEMM on the rows staged in memory (staging and the sum of the
    K split's partials included)."""
    torch = _setup(str(HERE))
    from psgd_tf_tpu_torch import lra, splu
    from psgd_tf_tpu_torch.ops.hopper import kron_dd, lra_upd, splu_upd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, ranks = GRAM

    def mm(M, N, K, a, b, epi, tile, splits):
        return kron_dd.gemm(M, N, K, a, 0, b, 1, epi=epi, tile=tile, splits=splits)[0].sum(0)

    for r in ranks:
        lst = lra.init(torch.Generator().manual_seed(n), n, rank=r, init_scale=0.8, device=dev)
        sst = splu.walked_state(n, r, g, dev)
        v, h, gr = (torch.randn(n, generator=g, device=dev) for _ in range(3))
        uv, d = lst.UV, lst.d
        nt = n - r
        # the tail columns, copied contiguous (the test entry's operands are)
        lt, u12 = sst.Lt[:, r:].contiguous(), sst.U12[:, r:].contiguous()
        lu = sst.l3 * sst.u3

        def lra_rows():
            return torch.stack([d * h, v / d])

        def splu_rows():
            return u12 / lu, torch.stack([v[r:] / lu, h[r:], lu * h[r:]])

        def lra_gemm(tile, splits):
            e = lra_rows()
            return (mm(2 * r, 2 * r, n, uv, uv, "triu", tile, splits),
                    mm(2 * r, 2, n, uv, e, "store", tile, splits),
                    mm(2, 2, n, e, e, "triu", tile, splits))

        def splu_gemm(tile, splits):
            w, e = splu_rows()
            return [mm(r, r, nt, lt, lt, "triu", tile, splits),
                    mm(r, r, nt, lt, w, "store", tile, splits),
                    mm(r, r, nt, w, w, "triu", tile, splits)] + [
                mm(r, 3, nt, x, e, "store", tile, splits) for x in (lt, w, u12)]

        # the GEMM's stage-1 Gram against float64, once
        z = torch.cat([uv, lra_rows()]).double()
        ref = z @ z.T
        a, b, c = lra_gemm("auto", 128)
        got = torch.zeros_like(ref)
        got[:2 * r, :2 * r], got[:2 * r, 2 * r:], got[2 * r:, 2 * r:] = a, b, c
        rel = ((torch.triu(got) - torch.triu(ref)).abs().max() / ref.abs().max()).item()
        print(f"r = {r}: lra's Gram through the GEMM, max rel diff from float64 {rel:.2e}",
              flush=True)
        del z, ref, got
        for name, chain, grams, stage, per_call in [
                ("K13 update+apply", lambda: lra_upd.fused_update_apply(
                    uv, d, v, h, gr, 0.05, (True, False)), lra_gemm, lra_rows,
                 "the chain makes two Grams of these shapes a call"),
                ("K16 update", lambda: splu_upd.fused_update(
                    sst.Lt, sst.l3, sst.U12, sst.u3, v, h, 0.05), splu_gemm, splu_rows,
                 "the chain makes one, its stage 1's")]:
            ms, _ = _time(torch, chain, 5)
            kern = _kernel_ms(torch, chain)
            gk = sum(t for k, t in kern.items() if any(w in k for w in GRAM_KERNELS))
            top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
            print(f"r = {r}: {name} {ms:.4f} ms a call; its Grams (the staged rows, the GEMM's "
                  f"bands and their sums) {gk:.4f} ms of it; by kernel: "
                  + "; ".join(f"{k.split('(')[0][:60]} {t:.4f}" for k, t in top), flush=True)
            st_ms, _ = _time(torch, stage, 10)
            rows = []
            for tile, splits in [("64", 128), ("64", 256), ("128", 256), ("128", 512)]:
                gm, _ = _time(torch, lambda: grams(tile, splits), 5)
                rows.append(f"tile {tile} splits {splits}: {gm:.4f}")
            print(f"r = {r}: {name}'s stage-1 Gram through the GEMM, staging + products + "
                  f"partial sums, ms ({per_call}; the staging alone {st_ms:.4f}): "
                  + ", ".join(rows), flush=True)
        del lst, sst
        torch.cuda.empty_cache()


ROUTE_SIDES = [16, 64, 128, 256, 384, 512, 768, 1024]  # --route's single (dense, dense) layers
ROUTE_LISTS = [(4, 128), (4, 256), (4, 512), (16, 128), (16, 256)]  # its dd lists: (layers, side)
ROUTE_ARROW = [(256, 128), (256, 256), (512, 256), (512, 512)]  # its arrow layers (K5's cap)


def route_sweep() -> None:
    """Every list of K1's chain on both routes, forced: queued (device) and
    chained ms, bit-equality, the route picked and the chain's MFLOP."""
    torch = _setup(str(HERE))
    from psgd_tf_tpu_torch import PSGD, kron
    from psgd_tf_tpu_torch.models import nmt, tensor_decomp
    from psgd_tf_tpu_torch.ops import hopper
    from psgd_tf_tpu_torch.ops.hopper import kron_dd, kron_sparse

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    DD = ("dense", "dense")

    def probes(shapes):
        return ([torch.randn(s, generator=g, device=dev) for s in shapes],
                [torch.randn(s, generator=g, device=dev) for s in shapes])

    def walked(fmts, shapes):
        sts = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
        with hopper.disabled():
            for _ in range(2):
                sts = kron.update_multi(sts, *probes(shapes), step=0.1)
        return sts

    def multi(fmts, shapes):
        sts, (dxs, dgs) = walked(fmts, shapes), probes(shapes)
        return lambda: kron.update_multi(sts, dxs, dgs, 0.1)

    def single(fmt, shape):
        (st,), ((dx,), (dg,)) = walked([fmt], [shape]), probes([shape])
        if fmt == DD:
            return lambda: kron_dd.fused_update(st.ql, st.qr, dx, dg, 0.1)
        kind = kron._canon(fmt)[0]
        return lambda: kron_sparse.FUSED_UPDATE[kind](st.ql, st.qr, dx, dg, 0.1)

    pre = PSGD(preconditioner="kron").init(tensor_decomp.init(g)).precond
    toy = nmt.Config()
    cases = [("K1 LeNet5", multi([DD] * 5, LENET5)),
             ("K1 toy NMT", multi(nmt.kron_formats(toy), nmt.layer_shapes(toy))),
             ("K1 decomposition", multi([st.fmt for st in pre],
                                        [(st.ql.shape[-1], st.qr.shape[-1]) for st in pre])),
             ("K20 16 layers", multi([DD] * 16, MULTI_18[:16])),
             ("K2 (1, 10)", single(DD, (1, 10)))]
    cases += [(f"K5 {kind} (130, 65)", single(fmt, (130, 65))) for kind, fmt in
              [("ns", ("norm", "scale")), ("ds", ("dense", "scale")), ("nd", ("norm", "dense"))]]
    cases += [(f"K5 nd {s}", single(("norm", "dense"), s)) for s in ROUTE_ARROW]
    cases += [(f"K5 ns {s}", single(("norm", "scale"), s)) for s in ROUTE_ARROW]
    cases += [(f"K2 ({d}, {d})", single(DD, (d, d))) for d in ROUTE_SIDES]
    cases += [(f"K1 {L} x ({d}, {d})", multi([DD] * L, [(d, d)] * L)) for L, d in ROUTE_LISTS]
    for name, fn in cases:
        row, outs = [], {}
        for route in ("chain", "mono"):
            with kron_dd.forced_route(route):
                try:
                    outs[route] = _flat(fn())
                except RuntimeError as e:  # a list whose products take the 128 x 128 tiles
                    row.append(f"{route} refused ({str(e)[:40]})")
                    continue
                reps = 20 if "1024" in name or "768" in name else 100
                q = _time_queued(torch, fn, min(reps, 40))
                c, _ = _time(torch, fn, reps)
                row.append(f"{route} queued {q:.4f} chained {c:.4f}")
        before = hopper.counts["kron_mono"]
        fn()
        picked = "mono" if hopper.counts["kron_mono"] > before else "chain"
        same = _same(outs["chain"], outs["mono"]) if len(outs) == 2 else "-"
        print(f"{name}: {'; '.join(row)}; picks {picked}; routes {same}", flush=True)
        torch.cuda.empty_cache()


TRI_LAUNCH = ("psgd_tf_tpu_torch/csrc/tri.cu",
              """    void* args[] = {&b, &ph0, &ph1};
    cudaLaunchCooperativeKernel((const void*)tri_kernel, dim3(std::min(most, std::max(ctas, 1))),
                                dim3(TRI_THREADS), args, TRI_SMEM, stream);""",
              """    for (int ph = 0; ph < ph1; ++ph)
        tri_kernel<<<tri_phase_tasks(b, ph), TRI_THREADS, TRI_SMEM, stream>>>(b, ph, ph + 1);""")


def tri_variants() -> None:
    """K3 (and the chains that run it) on this tree, its phases in one
    cooperative launch, and on a copy with a launch a phase."""
    _run_copies([("this tree", None), ("a launch a phase", [TRI_LAUNCH]),
                 ("a launch a phase", [TRI_LAUNCH]), ("this tree", None)],
                ["K3 LeNet5's ten factors", "K1 LeNet5", "K1 toy NMT",
                 "K9 kernel part (131072, 512)", "K11 n=1536"])


def _same(a, b) -> str:
    import torch

    if all(torch.equal(x, y) for x, y in zip(a, b)):
        return "bit-equal"
    if all(bool(((x == y) | (x.isnan() & y.isnan())).all()) for x, y in zip(a, b)):
        return "equal up to the sign of zeros"
    return "differs, max abs {:.2e}".format(max((x - y).abs().max().item() for x, y in zip(a, b)))


def main() -> int:
    if len(sys.argv) >= 5 and sys.argv[1] == "--tree":
        run_tree(sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5:])
        return 0
    if sys.argv[1:] == ["--sweep"]:
        sweep()
    elif sys.argv[1:] == ["--generic"]:
        generic()
    elif sys.argv[1:] == ["--gram"]:
        gram()
    elif sys.argv[1:] == ["--route"]:
        route_sweep()
    elif sys.argv[1:] == ["--tri"]:
        tri_variants()
    elif sys.argv[1:] == ["--k4"]:
        k4_rules()
    elif sys.argv[1:] == ["--gemm"]:
        torch = _setup(str(HERE))
        print("GEMM alone at (131072, 512): " + _gemm_rates(torch, torch.device("cuda")), flush=True)
    elif len(sys.argv) == 2:
        here = str(HERE)
        with tempfile.TemporaryDirectory() as tmp:
            dumps = []
            for k, (tree, label) in enumerate([(sys.argv[1], "other"), (here, "this"),
                                               (here, "this"), (sys.argv[1], "other")]):
                dumps.append(str(Path(tmp) / f"{k}.pt"))
                subprocess.run([sys.executable, __file__, "--tree", tree, label, dumps[-1]],
                               check=True)
            import torch

            other, this = torch.load(dumps[0]), torch.load(dumps[1])
            print("== this tree's outputs against the other tree's", flush=True)
            for name, got in this.items():
                same = _same(got, other[name]) if name in other else "the other tree raises"
                print(f"  {name}: {same}", flush=True)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
