"""The port's import hygiene on the CPU, and its Hopper kernels against
their plain versions on a CUDA card (those tests skip without one; the
card runs them with `python -m pytest tests/test_torch_hopper.py`)."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import (dense_big, dense_upd, kron_dd, kron_multi, kron_sparse,
                                          kron_sparse_big, lra_upd, splu_one, splu_upd, tri)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "psgd_tf_tpu_torch"
LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
# the NMT model's seven layers (psgd_tf_tpu_torch.models.nmt) at the
# workload's toy widths and at the reference widths, with their formats
NMT_FMTS = [("scale", "dense"), ("norm", "scale"), ("scale", "dense"), ("dense", "dense"),
            ("scale", "dense"), ("norm", "scale"), ("norm", "scale")]
NMT_TOY = [(32, 64), (193, 128), (256, 10), (1, 10), (32, 64), (321, 128), (129, 32)]
NMT_REF = [(9414, 256), (1281, 1024), (2048, 10), (1, 10), (4935, 256), (2305, 1024),
           (1025, 4935)]


def test_import_leaves_jax_out():
    code = (
        "import sys, psgd_tf_tpu_torch, psgd_tf_tpu_torch.workloads.mnist_lenet5, "
        "psgd_tf_tpu_torch.workloads.nmt_attention, psgd_tf_tpu_torch.interop, "
        "psgd_tf_tpu_torch.workloads.hello_psgd, psgd_tf_tpu_torch.workloads.rnn_xor_lra, "
        "psgd_tf_tpu_torch.workloads.all_preconditioners, psgd_tf_tpu_torch.workloads.lstm_xor, "
        "psgd_tf_tpu_torch.ops.hopper.kron_sparse_big, psgd_tf_tpu_torch.parallel\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'psgd_tf_tpu.'))"
        " or m == 'psgd_tf_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_no_jax_import_in_package_source():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "psgd_tf_tpu", "flax"):
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert not offenders, offenders


def test_kernel_sources_are_present():
    assert {p.name for p in (PKG / "csrc").glob("*.cu")} == {
        "kron_dd.cu", "kron_sparse_big.cu", "tri.cu", "dense.cu", "lra.cu", "splu.cu"}
    for src in (PKG / "csrc").glob("*.cu"):
        text = src.read_text()
        assert "psgd_tf_tpu/ops/pallas/" in text  # names the kernel it replaces
    # the streaming file names every Pallas kernel of kron_sparse_big.py it ports
    text = (PKG / "csrc" / "kron_sparse_big.cu").read_text()
    for kernel in ["_kernel_ns_big", "_kernel_ns_wide2", "_kernel_ns_wide", "_kernel_nd_big",
                   "_kernel_ds_big", "_kernel_apply_norm", "_kernel_apply_ns_wide"]:
        assert f"`{kernel}`" in text, kernel
    assert "`_solve_kernel`" in (PKG / "csrc" / "tri.cu").read_text()
    # and splu.cu every Pallas kernel of splu_upd.py, the one-launch schedule's too
    text = (PKG / "csrc" / "splu.cu").read_text()
    for kernel in ["_stage1_kernel", "_stage2_kernel", "_stage3_kernel", "_stage3_apply_kernel",
                   "_stage4_apply_kernel", "_mono_kernel"]:
        assert f"`{kernel}`" in text, kernel


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _triu_factor(g, n, dev):
    u = torch.triu(0.1 / n**0.5 * torch.randn(n, n, generator=g, device=dev), 1)
    return u + torch.diag(0.5 + torch.rand(n, generator=g, device=dev))


def _walked(g, shapes, dev, steps=3):
    """Factors walked `steps` plain updates off the identity, and probes."""
    qls = [0.8 * torch.eye(m, device=dev) for m, _ in shapes]
    qrs = [0.8 * torch.eye(n, device=dev) for _, n in shapes]
    kinds = ["dd"] * len(shapes)
    with hopper.disabled():
        for _ in range(steps):
            dxs = [torch.randn(s, generator=g, device=dev) for s in shapes]
            dgs = [torch.randn(s, generator=g, device=dev) for s in shapes]
            qls, qrs = map(list, zip(*kron_multi.fused_update_multi(kinds, qls, qrs, dxs, dgs, 0.1)))
    dxs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    dgs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    return qls, qrs, dxs, dgs


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_k3_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    us = [_triu_factor(g, n, cuda) for s in LENET5 for n in s] + [_triu_factor(g, 1024, cuda)]
    before = hopper.counts["tri"]
    got = tri.inverse_upper(us)
    torch.cuda.synchronize()
    assert hopper.counts["tri"] == before + 1
    for x, r in zip(got, tri.inverse_upper_plain(us)):
        assert _rel(x, r) < 1e-5


@pytest.mark.parametrize("sides", [[1], [31], [33], [255], [257], [513], [1025],
                                   [1, 31, 33, 255, 257, 513, 1025]], ids=str)
def test_k3_ragged_sides(cuda, sides):
    """K3's levels at sides past, at and short of its 32-row leaves, alone
    and in one batch: within 1e-5 of plain, the strictly lower part zero."""
    g = torch.Generator(device=cuda).manual_seed(sum(sides))
    us = [_triu_factor(g, n, cuda) for n in sides]
    got = tri.inverse_upper(us)
    torch.cuda.synchronize()
    for x, r in zip(got, tri.inverse_upper_plain(us)):
        assert _rel(x, r) < 1e-5
        assert torch.count_nonzero(torch.tril(x, -1)).item() == 0


def _route_moves(counter, chunks, dense=True):
    """The counts one call of `counter` moves, its chains `chunks` of
    (kinds, ms, ns) each on the route `kron_dd.route` picks."""
    monos = sum(kron_dd.route(*c) == "mono" for c in chunks)
    moved = {counter: len(chunks), "kron_mono": monos, "tri": (len(chunks) - monos) * dense}
    return {k: v for k, v in moved.items() if v}


def test_k1_and_k2_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    qls, qrs, dxs, dgs = _walked(g, LENET5, cuda)
    before = dict(hopper.counts)
    kinds = ["dd"] * len(LENET5)
    got = kron_multi.fused_update_multi(kinds, qls, qrs, dxs, dgs, 0.1)
    torch.cuda.synchronize()
    assert hopper.counts["kron_multi"] == before["kron_multi"] + 1
    with hopper.disabled():
        ref = kron_multi.fused_update_multi(kinds, qls, qrs, dxs, dgs, 0.1)
    for pair, rpair in zip(got, ref):
        for a, b in zip(pair, rpair):
            assert _rel(a, b) < 1e-4

    (ql,), (qr,), (dx,), (dg,) = _walked(g, [(1024, 1024)], cuda, steps=2)
    a, b = kron_dd.fused_update(ql, qr, dx, dg, 0.1)
    torch.cuda.synchronize()
    assert hopper.counts["kron_dd"] == before["kron_dd"] + 1
    ra, rb = kron_dd.update_plain(ql, qr, dx, dg, 0.1)
    assert _rel(a, ra) < 1e-4 and _rel(b, rb) < 1e-4


def test_zero_probe_and_bad_operands_on_card(cuda):
    ql, qr = torch.eye(26, device=cuda), torch.eye(6, device=cuda)
    z = torch.zeros(26, 6, device=cuda)
    a, b = kron_dd.fused_update(ql, qr, z, z, 0.1)
    assert torch.equal(a, ql) and torch.equal(b, qr)
    with pytest.raises(ValueError, match="float32"):
        kron_dd.fused_update(ql.double(), qr.double(), z.double(), z.double(), 0.1)
    with pytest.raises(ValueError, match="shapes"):
        kron_dd.fused_update(ql, qr, z.T.contiguous(), z, 0.1)


def test_lenet5_steps_route_through_k1(cuda):
    from psgd_tf_tpu_torch import PSGD, kron
    from psgd_tf_tpu_torch.data import mnist
    from psgd_tf_tpu_torch.models import lenet5

    g = torch.Generator(device=cuda).manual_seed(0)
    params = lenet5.init(g)
    opt = PSGD(preconditioner="kron", kron_formats=[("dense", "dense")] * 5, lr_params=0.1,
               lr_preconditioner=0.1,
               grad_clip_max_norm=0.1 * sum(p.numel() for p in params) ** 0.5)
    state = opt.init(params)
    assert [kron.route(st.fmt, st.ql.shape[:1] + st.qr.shape[:1], cuda) for st in state.precond] == ["kron_dd"] * 5
    before = hopper.counts["kron_multi"]
    for _ in range(3):
        params, state, aux = opt.step(lenet5.loss, params, state, g, *mnist.synthetic_hard(g, 64))
    assert np.isfinite(aux["loss"].item())
    assert hopper.counts["kron_multi"] == before + 3


def _walked_states(g, fmts, shapes, dev, steps=3):
    """KronStates walked `steps` plain updates off 0.8 I, and fresh probes."""
    from psgd_tf_tpu_torch import kron

    states = [kron.init(s, fmt=f, init_scale=0.8, device=dev) for f, s in zip(fmts, shapes)]
    with hopper.disabled():
        for _ in range(steps):
            dxs = [torch.randn(s, generator=g, device=dev) for s in shapes]
            dgs = [torch.randn(s, generator=g, device=dev) for s in shapes]
            states = kron.update_multi(states, dxs, dgs, step=0.1)
    dxs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    dgs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    return states, dxs, dgs


def _chain_list(fmts, shapes):
    """(kinds, ms, ns) of a layer list as K1's chain takes it: mirrors
    transposed into their sibling."""
    from psgd_tf_tpu_torch import kron

    canon = [kron._canon(f) for f in fmts]
    return ([k for k, _ in canon], [n if mir else m for (_, mir), (m, n) in zip(canon, shapes)],
            [m if mir else n for (_, mir), (m, n) in zip(canon, shapes)])


def _states_rel(got, ref):
    return max(max(_rel(a.ql, b.ql), _rel(a.qr, b.qr)) for a, b in zip(got, ref, strict=True))


def test_k1_mixed_kinds_match_plain(cuda):
    """The toy NMT list, kinds [ds, ns, ds, dd, ds, ns, ns], in one K1 call."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(2)
    states, dxs, dgs = _walked_states(g, NMT_FMTS, NMT_TOY, cuda)
    assert [kron.route(f, s, cuda) for f, s in zip(NMT_FMTS, NMT_TOY)] == [
        "kron_sparse:ds", "kron_sparse:ns", "kron_sparse:ds", "kron_dd",
        "kron_sparse:ds", "kron_sparse:ns", "kron_sparse:ns"]
    before = dict(hopper.counts)
    got = kron.update_multi(states, dxs, dgs, step=0.1)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    assert moved == _route_moves("kron_multi", [_chain_list(NMT_FMTS, NMT_TOY)])
    with hopper.disabled():
        ref = kron.update_multi(states, dxs, dgs, step=0.1)
    assert _states_rel(got, ref) < 1e-4
    for st in got:
        for q, f in zip((st.ql, st.qr), st.fmt):
            if f == "norm":
                assert q[1, -1].item() == 0.0


@pytest.mark.parametrize("kind", ["ns", "ds", "nd"])
def test_k5_matches_plain(cuda, kind):
    g = torch.Generator(device=cuda).manual_seed(3)
    fmt = {"ns": ("norm", "scale"), "ds": ("dense", "scale"), "nd": ("norm", "dense")}[kind]
    (st,), (dx,), (dg,) = _walked_states(g, [fmt], [(130, 65)], cuda)
    before = hopper.counts["kron_sparse"]
    a, b = kron_sparse.FUSED_UPDATE[kind](st.ql, st.qr, dx, dg, 0.1)
    torch.cuda.synchronize()
    assert hopper.counts["kron_sparse"] == before + 1
    ra, rb = kron_sparse.PLAIN[kind](st.ql, st.qr, dx, dg, 0.1)
    assert _rel(a, ra) < 1e-4 and _rel(b, rb) < 1e-4
    if kind != "ds":
        assert a[1, -1].item() == 0.0


# the kernels of K6's and K7/K8's one C call, and of K10's
NS_KERNELS = ("ns_pass_kernel", "ns_wide_vecs_kernel", "ns_wide_kernel", "ns_cols_kernel",
              "ns_btdot", "ns_rows_kernel", "ns_finish_kernel")
DS_KERNELS = ("tri_kernel", "gemm_kernel", "ds_sums_kernel", "ds_finish_kernel")


def _one_call_update(fmt, st, dx, dg):
    """One `kron.update` of a K6 or K10 layer on the card: (result, the
    counters it moved). Every launch is the C call's own: one count of
    the kernel (and K3's for K10), no other counter."""
    from psgd_tf_tpu_torch import kron

    kind = "ns" if "norm" in fmt else "ds"
    name = "kron_sparse_big_ns" if kind == "ns" else "kron_sparse_big_ds"
    before = dict(hopper.counts)
    got = kron.update(st, dx, dg, step=0.1)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    assert moved == ({name: 1} if kind == "ns" else {name: 1, "tri": 1})
    return got


def _check_one_call(fmt, got, ref):
    """The one-call update against the plain one: 1e-4 of max-abs plain,
    the arrow's q1[-1] and a dense factor's lower triangle exactly 0."""
    assert _states_rel([got], [ref]) < 1e-4
    for q, f in zip((got.ql, got.qr), fmt):
        assert bool(torch.isfinite(q).all())
        if f == "norm":
            assert q[1, -1].item() == 0.0
        if f == "dense":
            assert torch.equal(q, torch.triu(q))


@pytest.mark.parametrize("fmt,shape", [
    (f, s) for f, s in zip(NMT_FMTS, NMT_REF) if f != ("dense", "dense")], ids=str)
def test_k6_k10_match_plain_at_reference_shapes(cuda, fmt, shape):
    """K6 ((norm, scale)) and K10 (mirrored (scale, dense), so dX arrives
    transposed) through `kron.update` at the reference NMT layers: one C
    call (one count, K3's for K10, nothing else), against the plain update,
    two calls equal bit for bit."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(4)
    assert kron.route(fmt, shape, cuda) == ("kron_sparse_big:ns" if fmt[0] == "norm"
                                            else "kron_sparse_big:ds")
    (st,), (dx,), (dg,) = _walked_states(g, [fmt], [shape], cuda, steps=2)
    got = _one_call_update(fmt, st, dx, dg)
    with hopper.disabled():
        ref = kron.update(st, dx, dg, step=0.1)
    _check_one_call(fmt, got, ref)
    again = kron.update(st, dx, dg, step=0.1)
    assert torch.equal(again.ql, got.ql) and torch.equal(again.qr, got.qr)


@pytest.mark.parametrize("fmt,shape", [
    (("scale", "norm"), (1024, 1284)),   # mirrored: K6 reads dX.T in place
    (("scale", "norm"), (4935, 1029)),   # mirrored, ragged rows of the (n, m) memory
    (("norm", "scale"), (700, 1029)),    # n % 4 = 1: the strided loads
    (("norm", "scale"), (2, 5000)),      # an arrow of two rows
    (("norm", "scale"), (10000, 130)),   # two panels a group
    (("dense", "scale"), (2, 5000)),
    (("dense", "scale"), (130, 4097)),   # ragged tiles and bands
    (("dense", "scale"), (1024, 3000)),  # the dense side's cap
    (("dense", "scale"), (300, 2000)),
], ids=str)
def test_k6_k10_one_call_at_edge_shapes(cuda, fmt, shape):
    """K6 and K10's one C call at shapes beside the NMT layers', through
    their wrappers (these shapes may route elsewhere in `kron.update`):
    mirrored, ragged, two rows; against the plain update, bit-repeatable."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(15)
    (st,), (dx,), (dg,) = _walked_states(g, [fmt], [shape], cuda, steps=2)
    kind, mirrored, a, b, x, y = kron._oriented(st, dx, dg)
    fn = kron_sparse_big.fused_update_ns if kind == "ns" else kron_sparse_big.fused_update_ds
    before = dict(hopper.counts)
    na, nb = fn(a, b, x, y, 0.1)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    assert moved == ({"kron_sparse_big_ns": 1} if kind == "ns"
                     else {"kron_sparse_big_ds": 1, "tri": 1})
    with hopper.disabled():
        ra, rb = fn(a, b, x, y, 0.1)
    got = st.replace(ql=nb, qr=na) if mirrored else st.replace(ql=na, qr=nb)
    ref = st.replace(ql=rb, qr=ra) if mirrored else st.replace(ql=ra, qr=rb)
    _check_one_call(fmt, got, ref)
    again = fn(a, b, x, y, 0.1)
    assert torch.equal(again[0], na) and torch.equal(again[1], nb)


@pytest.mark.parametrize("fmt,shape", [(("norm", "scale"), (2305, 1024)),
                                       (("scale", "dense"), (9414, 256)),
                                       (("norm", "scale"), (64, 140_001))], ids=str)
def test_k6_k10_zero_probes_give_the_balanced_factors(cuda, fmt, shape):
    """A zero probe gives a zero gradient: the step scales saturate, and the
    update returns the balanced factors, finite (the Pallas kernels' own
    normalizer gives NaN there)."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(16)
    (st,), _, _ = _walked_states(g, [fmt], [shape], cuda, steps=2)
    z = torch.zeros(shape, device=cuda)
    got = kron.update(st, z, z, step=0.1)
    with hopper.disabled():
        ref = kron.update(st, z, z, step=0.1)
    for q, r in zip((got.ql, got.qr), (ref.ql, ref.qr)):
        assert bool(torch.isfinite(q).all()) and _rel(q, r) < 1e-6


def test_k6_k10_run_only_their_own_kernels(cuda):
    """torch.profiler over one `kron.update` of each kind: every kernel on
    the card is the C call's own, no torch elementwise or reduction
    kernel (the tail runs on the device, in the chain)."""
    from torch.profiler import ProfilerActivity, profile

    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(17)
    for fmt, shape, names in [(("norm", "scale"), (2305, 1024), NS_KERNELS),
                              (("scale", "dense"), (9414, 256), DS_KERNELS),
                              (("norm", "scale"), (64, 140_001), NS_KERNELS)]:
        (st,), (dx,), (dg,) = _walked_states(g, [fmt], [shape], cuda, steps=1)
        kron.update(st, dx, dg, step=0.1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kron.update(st, dx, dg, step=0.1)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "emset" not in e.name]
        assert kernels, "the profiler saw no kernel"
        assert all(any(k in name for k in names) for name in kernels), (shape, kernels)


@pytest.mark.parametrize("fmt,shape", [
    (("norm", "dense"), (600, 64)), (("norm", "dense"), (1000, 10)),
    (("norm", "dense"), (2, 700)), (("norm", "dense"), (1281, 1024)),
    (("dense", "norm"), (70, 1500)),
], ids=str)
def test_k9_matches_plain(cuda, fmt, shape):
    """K9 through `kron.update` at ragged dense sides (10: one partial
    tile), two rows, the reference NMT's (1281, 1024) and a mirrored layer
    (its probes as dX.T views), against the plain update."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(13)
    assert kron.route(fmt, shape, cuda) == "kron_sparse_big:nd"
    (st,), (dx,), (dg,) = _walked_states(g, [fmt], [shape], cuda, steps=2)
    before = dict(hopper.counts)
    got = kron.update(st, dx, dg, step=0.1)
    torch.cuda.synchronize()
    assert hopper.counts["kron_sparse_big_nd"] == before["kron_sparse_big_nd"] + 1
    assert hopper.counts["tri"] == before["tri"] + 1
    with hopper.disabled():
        ref = kron.update(st, dx, dg, step=0.1)
    assert _states_rel([got], [ref]) < 1e-4
    arrow, dense = (got.qr, got.ql) if fmt[0] == "dense" else (got.ql, got.qr)
    assert arrow[1, -1].item() == 0.0 and torch.equal(dense, torch.triu(dense))
    # the chain repeats itself bit for bit (no float atomics)
    again = kron.update(st, dx, dg, step=0.1)
    assert torch.equal(again.ql, got.ql) and torch.equal(again.qr, got.qr)


@pytest.mark.parametrize("fmt,shape,counter", [
    (("norm", "scale"), (33, 140_001), "kron_sparse_big_ns_wide2"),
    (("norm", "scale"), (2, 131_073), "kron_sparse_big_ns_wide2"),
    (("scale", "norm"), (140_001, 70), "kron_sparse_big_ns_wide2"),
    (("norm", "scale"), (3, (2 << 20) + 129), "kron_sparse_big_ns_wide_xla"),
    (("norm", "scale"), (512, 1_000_000), "kron_sparse_big_ns_wide2"),
    (("norm", "scale"), (64, 3_000_017), "kron_sparse_big_ns_wide_xla"),
], ids=str)
def test_k7_k8_match_plain(cuda, fmt, shape, counter):
    """The wide (norm, scale) pass and K6's device tail, one C call, through
    `kron.update`: ragged strips, two rows, a mirrored layer (dX.T views),
    one width past K7's cap and the two bench shapes, against the plain
    update; the launch counts under the JAX route, bit-repeatable."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(14)
    assert kron.route(fmt, shape, cuda) == "kron_sparse_big:ns_wide"
    (st,), (dx,), (dg,) = _walked_states(g, [fmt], [shape], cuda, steps=2)
    before = dict(hopper.counts)
    got = kron.update(st, dx, dg, step=0.1)
    torch.cuda.synchronize()
    moved = {k for k in hopper.counts if hopper.counts[k] != before[k]}
    assert moved == {counter} and hopper.counts[counter] == before[counter] + 1
    with hopper.disabled():
        ref = kron.update(st, dx, dg, step=0.1)
    assert _states_rel([got], [ref]) < 1e-4
    arrow = got.qr if fmt[0] == "scale" else got.ql
    assert arrow[1, -1].item() == 0.0
    again = kron.update(st, dx, dg, step=0.1)
    assert torch.equal(again.ql, got.ql) and torch.equal(again.qr, got.qr)


@pytest.mark.parametrize("entry,fmt,shape", [
    ("fused_apply_ns", ("norm", "scale"), (1030, 257)),
    ("fused_apply_ns", ("norm", "scale"), (1, 70)),
    ("fused_apply_ns", ("norm", "scale"), (4000, 5)),
    ("fused_apply_ns_wide", ("norm", "scale"), (70, 140_000)),
    ("fused_apply_nd", ("norm", "dense"), (900, 70)),
    ("fused_apply_nd", ("norm", "dense"), (1500, 200)),
    ("fused_apply_nd", ("norm", "dense"), (3, 65)),
    # K17 nd's GEMM: bench.py's (131072, 512) (128 x 128 tiles), the
    # reference NMT's five (norm, dense) layers under auto, m = 1 and 2 (row
    # m - 1 both an ordinary row and the arrow's), n odd, m past a tile
    ("fused_apply_nd", ("norm", "dense"), (131072, 512)),
    ("fused_apply_nd", ("norm", "dense"), (9414, 256)),
    ("fused_apply_nd", ("norm", "dense"), (1281, 1024)),
    ("fused_apply_nd", ("norm", "dense"), (2048, 10)),
    ("fused_apply_nd", ("norm", "dense"), (4935, 256)),
    ("fused_apply_nd", ("norm", "dense"), (2305, 1024)),
    ("fused_apply_nd", ("norm", "dense"), (1, 7)),
    ("fused_apply_nd", ("norm", "dense"), (2, 65)),
    ("fused_apply_nd", ("norm", "dense"), (130, 67)),
    ("fused_apply_nd", ("norm", "dense"), (1000, 333)),
], ids=str)
def test_k17_k18_match_plain(cuda, entry, fmt, shape):
    """The streamed arrow applies at ragged shapes (partial strips and row
    chunks, one row, many chunks) against their plain chains and
    `kron.apply`; a second call repeats the first bit for bit."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(15)
    (st,), _, _ = _walked_states(g, [fmt], [shape], cuda)
    G = torch.randn(shape, generator=g, device=cuda)
    fn = getattr(kron_sparse_big, entry)
    counter = {"fused_apply_ns": "kron_sparse_big_apply_ns",
               "fused_apply_ns_wide": "kron_sparse_big_apply_ns_wide",
               "fused_apply_nd": "kron_sparse_big_apply_nd"}[entry]
    before = dict(hopper.counts)
    got = fn(st.ql, st.qr, G)
    torch.cuda.synchronize()
    moved = {k for k in hopper.counts if hopper.counts[k] != before[k]}
    assert moved == {counter} and hopper.counts[counter] == before[counter] + 1
    with hopper.disabled():
        ref = fn(st.ql, st.qr, G)
    assert _rel(got, ref) < 1e-4
    assert _rel(got, kron.apply(st, G)) < 1e-4
    assert torch.equal(fn(st.ql, st.qr, G), got)


@pytest.mark.parametrize("n,nrhs", [(1, 1), (257, 0), (300, 64), (1000, 33), (2048, 17)])
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("trans", [False, True])
def test_k19_matches_plain(cuda, n, nrhs, lower, trans):
    """The blocked triangular solve in all four orientations, at ragged n
    (a partial last tile) and nrhs (a partial panel), a 1-D b (nrhs 0) and
    past the JAX kernel's cap, against `torch.linalg.solve_triangular`."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q = _triu_factor(g, n, cuda)
    if lower:
        q = q.T.contiguous()
    b = torch.randn((n, nrhs) if nrhs else (n,), generator=g, device=cuda)
    before = dict(hopper.counts)
    got = tri.solve_triangular(q, b, lower=lower, trans=trans)
    torch.cuda.synchronize()
    moved = {k for k in hopper.counts if hopper.counts[k] != before[k]}
    assert moved == {"tri_solve"} and hopper.counts["tri_solve"] == before["tri_solve"] + 1
    ref = tri.solve_triangular_plain(q, b, lower=lower, trans=trans)
    assert got.shape == b.shape and _rel(got, ref) < 1e-5


@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("trans", [False, True])
def test_k19_blocked_at_the_bench_width(cuda, n, lower, trans):
    """The blocked schedule at nrhs = 512 (at n = 2048: the diagonal
    blocks' inverses, 8 leaf and 7 update GEMMs) in all four orientations,
    against the plain solve and the schedule's torch executor, repeating
    bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(19)
    q = _triu_factor(g, n, cuda)
    if lower:
        q = q.T.contiguous()
    b = torch.randn(n, 512, generator=g, device=cuda)
    got = tri.solve_triangular(q, b, lower=lower, trans=trans)
    ref = tri.solve_triangular_plain(q, b, lower=lower, trans=trans)
    blocked = tri.solve_triangular_blocked_plain(q, b, lower=lower, trans=trans)
    assert _rel(got, ref) < 1e-5 and _rel(got, blocked) < 1e-5
    assert torch.equal(tri.solve_triangular(q, b, lower=lower, trans=trans), got)


@pytest.mark.parametrize("nb", [32, 128, 256])
@pytest.mark.parametrize("n,nrhs", [(33, 1), (129, 0), (257, 120), (700, 65)])
@pytest.mark.parametrize("lower,trans", [(False, False), (False, True), (True, False),
                                         (True, True)], ids=str)
def test_k19_blocked_small_and_ragged(cuda, monkeypatch, nb, n, nrhs, lower, trans):
    """The blocked schedule forced below its size threshold: ragged last
    leaves and tiles, a 1-D b, leaves of 32 to 256 rows."""
    monkeypatch.setattr(tri, "NB", nb)
    monkeypatch.setattr(tri, "SUBST_MAX_N", 0)
    g = torch.Generator(device=cuda).manual_seed(n + nb)
    q = _triu_factor(g, n, cuda)
    if lower:
        q = q.T.contiguous()
    b = torch.randn((n, nrhs) if nrhs else (n,), generator=g, device=cuda)
    got = tri.solve_triangular(q, b, lower=lower, trans=trans)
    ref = tri.solve_triangular_plain(q, b, lower=lower, trans=trans)
    assert got.shape == b.shape and _rel(got, ref) < 1e-5


def test_k20_is_k1_with_kind_dd(cuda):
    """18 layers (two chains) through `kron_dd.fused_update_multi`: bit for
    bit K1's result with every kind dd, and within 1e-4 of the per-layer
    plain update."""
    g = torch.Generator(device=cuda).manual_seed(17)
    shapes = (LENET5 + [(1, 10), (300, 7), (33, 1)]) * 2 + [(64, 64)] * 2
    qls, qrs, dxs, dgs = _walked(g, shapes, cuda, steps=2)
    before = dict(hopper.counts)
    got_qls, got_qrs = kron_dd.fused_update_multi(qls, qrs, dxs, dgs, 0.1)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    chunks = [(["dd"] * len(c), [m for m, _ in c], [n for _, n in c]) for c in
              (shapes[:kron_dd.MAX_LAYERS], shapes[kron_dd.MAX_LAYERS:])]
    assert moved == _route_moves("kron_dd_multi", chunks)
    k1 = kron_multi.fused_update_multi(["dd"] * len(shapes), qls, qrs, dxs, dgs, 0.1)
    with hopper.disabled():
        ref_qls, ref_qrs = kron_dd.fused_update_multi(qls, qrs, dxs, dgs, 0.1)
    for a, b, (c, d), ra, rb in zip(got_qls, got_qrs, k1, ref_qls, ref_qrs, strict=True):
        assert torch.equal(a, c) and torch.equal(b, d)
        assert _rel(a, ra) < 1e-4 and _rel(b, rb) < 1e-4


def _route_case(case, g, dev):
    """(call, counter, chunks, dense) of one entry point of K1's chain."""
    from psgd_tf_tpu_torch import kron

    DD = ("dense", "dense")
    if case in ("k1 lenet5", "k1 toy nmt"):
        fmts, shapes = ([DD] * 5, LENET5) if case == "k1 lenet5" else (NMT_FMTS, NMT_TOY)
        states, dxs, dgs = _walked_states(g, fmts, shapes, dev, steps=2)
        return (lambda: kron.update_multi(states, dxs, dgs, step=0.1), "kron_multi",
                [_chain_list(fmts, shapes)], True)
    if case.startswith("k2"):
        side = (1, 10) if case == "k2 (1, 10)" else (256, 256)
        (ql,), (qr,), (dx,), (dg,) = _walked(g, [side], dev, steps=2)
        return (lambda: kron_dd.fused_update(ql, qr, dx, dg, 0.1), "kron_dd",
                [(["dd"], [side[0]], [side[1]])], True)
    if case == "k4 ragged":
        shapes = K4_BUCKETS["ragged"]
        bst, dx, dg = _walked_batched(g, shapes, dev)
        ms, ns = [m for m, _ in shapes], [n for _, n in shapes]
        return (lambda: kron_dd.fused_update_batched(bst.ql, bst.qr, dx, dg, ms, ns, 0.1),
                "kron_dd_batched", [(["dd"] * 4, ms, ns)], True)
    if case == "k20 16 layers":
        shapes = (LENET5 * 4)[:16]
        qls, qrs, dxs, dgs = _walked(g, shapes, dev, steps=2)
        return (lambda: kron_dd.fused_update_multi(qls, qrs, dxs, dgs, 0.1), "kron_dd_multi",
                [(["dd"] * 16, [m for m, _ in shapes], [n for _, n in shapes])], True)
    kind = case.split()[1]
    fmt = {"ns": ("norm", "scale"), "ds": ("dense", "scale"), "nd": ("norm", "dense")}[kind]
    (st,), (dx,), (dg,) = _walked_states(g, [fmt], [(130, 65)], dev, steps=2)
    return (lambda: kron_sparse.FUSED_UPDATE[kind](st.ql, st.qr, dx, dg, 0.1), "kron_sparse",
            [([kind], [130], [65])], kind != "ns")


def _tensors(out):
    if hasattr(out, "ql"):
        return [out.ql, out.qr]
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _tensors(x)]
    return [out]


ROUTE_CASES = ["k1 lenet5", "k1 toy nmt", "k2 (1, 10)", "k2 (256, 256)", "k4 ragged",
               "k20 16 layers", "k5 ns", "k5 ds", "k5 nd"]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_one_launch_is_bit_equal_to_the_chain(cuda, case):
    """Every entry point of K1's chain forced onto each route: the one
    cooperative launch equals the chain of launches bit for bit, both
    within 1e-4 of plain; each route counts as it launches ('kron_mono'
    for the one launch, 'tri' for the chain's own K3); unforced, the call
    takes the route `kron_dd.route` picks."""
    g = torch.Generator(device=cuda).manual_seed(21)
    call, counter, chunks, dense = _route_case(case, g, cuda)
    outs, moves = {}, {}
    for route in ("chain", "mono"):
        with kron_dd.forced_route(route):
            before = dict(hopper.counts)
            outs[route] = _tensors(call())
            torch.cuda.synchronize()
            moves[route] = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    assert moves["chain"] == {k: v for k, v in {counter: 1, "tri": int(dense)}.items() if v}
    assert moves["mono"] == {counter: 1, "kron_mono": 1}
    for a, b in zip(outs["chain"], outs["mono"], strict=True):
        assert torch.equal(a, b)
    with hopper.disabled():
        ref = _tensors(call())
    for a, b in zip(outs["mono"], ref, strict=True):
        assert _rel(a, b) < 1e-4
    before = dict(hopper.counts)
    call()
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    assert moved == _route_moves(counter, chunks, dense)


def test_forced_one_launch_on_a_list_it_does_not_take_raises(cuda):
    """A (2176, 2176) layer's products take the chain's 128 x 128 tiles,
    whose bits the one launch cannot give: forced onto it, the call raises
    and launches nothing."""
    ql, qr = torch.eye(2176, device=cuda), torch.eye(2176, device=cuda)
    x = torch.randn(2176, 2176, device=cuda)
    assert kron_dd.route(["dd"], [2176], [2176]) == "chain"
    before = dict(hopper.counts)
    with kron_dd.forced_route("mono"), pytest.raises(RuntimeError, match="CUDA error"):
        kron_dd.fused_update(ql, qr, x, x, 0.1)
    assert hopper.counts == before


def test_unrouted_entries_reject_and_count(cuda):
    """A CUDA operand of another dtype raises (no quiet fallback); CPU
    tensors take the plain versions and count no launch."""
    ql = torch.stack([torch.ones(40), torch.zeros(40)])
    qr, Qr, G = torch.ones(30), torch.eye(30), torch.randn(40, 30)
    q, b = torch.eye(30), torch.randn(30, 4)
    calls = [lambda d, t: kron_sparse_big.fused_apply_ns(ql.to(d, t), qr.to(d, t), G.to(d, t)),
             lambda d, t: kron_sparse_big.fused_apply_ns_wide(ql.to(d, t), qr.to(d, t),
                                                              G.to(d, t)),
             lambda d, t: kron_sparse_big.fused_apply_nd(ql.to(d, t), Qr.to(d, t), G.to(d, t)),
             lambda d, t: tri.solve_triangular(q.to(d, t), b.to(d, t)),
             lambda d, t: kron_dd.fused_update_multi([q.to(d, t)], [Qr.to(d, t)],
                                                     [G[:30].to(d, t)], [G[:30].to(d, t)], 0.1)]
    for call in calls:
        with pytest.raises(ValueError, match="float32"):
            call(cuda, torch.float64)
    before = dict(hopper.counts)
    for call in calls:
        call("cpu", torch.float32)
    assert hopper.counts == before


def test_auto_format_reference_nmt_step_launches_k9(cuda):
    """PSGD's default formats on the NMT model at the reference widths: five
    layers take K9 (each with its K3), the fc K6, the (1, 10) row K2 (on
    the route `kron_dd.route` picks)."""
    from psgd_tf_tpu_torch import PSGD, kron
    from psgd_tf_tpu_torch.data import translation
    from psgd_tf_tpu_torch.models import nmt

    cfg = nmt.ref_config()
    g = torch.Generator(device=cuda).manual_seed(15)
    params = nmt.init(g, cfg)
    opt = PSGD(preconditioner="kron", lr_params=0.02, lr_preconditioner=0.02,
               grad_clip_max_norm=1.0, exact_hessian_vector_product=False)
    state = opt.init(params)
    nd, ns = "kron_sparse_big:nd", "kron_sparse_big:ns"
    routes = [kron.route(st.fmt, (st.ql.shape[-1], st.qr.shape[-1]), cuda) for st in state.precond]
    assert routes == [nd, nd, nd, "kron_dd", nd, nd, ns]
    before = dict(hopper.counts)
    params, state, aux = opt.step(nmt.loss, params, state, g,
                                  *translation.random_tokens(g, cfg.vocab_src, cfg.vocab_tgt))
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    k2 = _route_moves("kron_dd", [(["dd"], [1], [10])])  # the row: one launch, or with its K3
    assert moved == {"kron_sparse_big_nd": 5, "kron_sparse_big_ns": 1, **k2,
                     "tri": k2.get("tri", 0) + 5}
    assert np.isfinite(aux["loss"].item())


# ------------------------------------------------ the batched (dense, dense) path (K4)

# the ragged bucket of tests/test_kron_batched.py, and the JAX package's
# crossover stack at B = 24 (two chains of at most 16 layers)
K4_BUCKETS = {"ragged": [(26, 6), (121, 84), (85, 10), (100, 128)], "b24": [(200, 256)] * 24}


def _walked_batched(g, shapes, dev, steps=3):
    """A stacked state walked `steps` plain updates off 0.8 I, and fresh
    stacked probes."""
    from psgd_tf_tpu_torch import kron

    bst = kron.init_batched(shapes, init_scale=0.8, device=dev)
    S, T = bst.ql.shape[1], bst.qr.shape[1]

    def stacked():
        return kron.stack_padded([torch.randn(s, generator=g, device=dev) for s in shapes], S, T)

    with hopper.disabled():
        for _ in range(steps):
            bst = kron.update_batched(bst, *(
                [torch.randn(s, generator=g, device=dev) for s in shapes] for _ in range(2)), step=0.1)
    return bst, stacked(), stacked()


def _identity_padded(q, sides):
    """True when every slot of the stack q is identity beyond its corner."""
    for i, d in enumerate(sides):
        want = torch.eye(q.shape[1], device=q.device)
        want[:d, :d] = q[i, :d, :d]
        if not torch.equal(q[i], want):
            return False
    return True


@pytest.mark.parametrize("bucket", list(K4_BUCKETS))
def test_k4_matches_plain(cuda, bucket):
    shapes = K4_BUCKETS[bucket]
    g = torch.Generator(device=cuda).manual_seed(16)
    bst, dx, dg = _walked_batched(g, shapes, cuda)
    ms, ns = [m for m, _ in shapes], [n for _, n in shapes]
    ql0, qr0 = bst.ql.clone(), bst.qr.clone()
    before = dict(hopper.counts)
    a, b = kron_dd.fused_update_batched(bst.ql, bst.qr, dx, dg, ms, ns, 0.1)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    chunks = [(["dd"] * len(c), [m for m, _ in c], [n for _, n in c]) for c in
              (shapes[i:i + kron_dd.MAX_LAYERS] for i in range(0, len(shapes), kron_dd.MAX_LAYERS))]
    assert moved == _route_moves("kron_dd_batched", chunks)
    ra, rb = kron_dd.update_batched_plain(bst.ql, bst.qr, dx, dg, ms, ns, 0.1)
    assert _rel(a, ra) < 1e-4 and _rel(b, rb) < 1e-4
    assert _identity_padded(a, ms) and _identity_padded(b, ns)
    assert torch.equal(bst.ql, ql0) and torch.equal(bst.qr, qr0)  # the inputs are not written
    again = kron_dd.fused_update_batched(bst.ql, bst.qr, dx, dg, ms, ns, 0.1)
    assert torch.equal(again[0], a) and torch.equal(again[1], b)  # no float atomics
    with pytest.raises(ValueError, match="host ints"):
        kron_dd.fused_update_batched(bst.ql, bst.qr, dx, dg, torch.tensor(ms, device=cuda), ns, 0.1)


def test_nmt_default_formats_step_launches_k4(cuda):
    """PSGD's defaults on the NMT model at embed 16 / units 32: its four
    (dense, dense) layers share a (128, 128) bucket and take K4 (one chain,
    its K3), the embeddings K9, the fc K10."""
    from psgd_tf_tpu_torch import PSGD
    from psgd_tf_tpu_torch.models import nmt
    from psgd_tf_tpu_torch.optim.psgd import KronPrecond

    cfg = nmt.Config(vocab_src=1100, vocab_tgt=1030, embed=16, units=32)
    g = torch.Generator(device=cuda).manual_seed(17)
    params = nmt.init(g, cfg)
    opt = PSGD(preconditioner="kron", lr_params=0.05, lr_preconditioner=0.05, grad_clip_max_norm=1.0)
    state = opt.init(params)
    assert isinstance(state.precond, KronPrecond)
    assert state.precond.batched_idx == ((1, 2, 3, 5),) and state.precond.single_idx == (0, 4, 6)
    src = torch.randint(3, cfg.vocab_src, (64, 18), generator=g, device=cuda)
    tgt = torch.randint(3, cfg.vocab_tgt, (64, 13), generator=g, device=cuda)
    before = dict(hopper.counts)
    params, state, aux = opt.step(nmt.loss, params, state, g, src, tgt)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    bucket = [nmt.layer_shapes(cfg)[i] for i in (1, 2, 3, 5)]
    k4 = _route_moves("kron_dd_batched", [(["dd"] * 4, [m for m, _ in bucket],
                                           [n for _, n in bucket])])
    assert moved == {"kron_sparse_big_nd": 2, "kron_sparse_big_ds": 1, **k4,
                     "tri": k4.get("tri", 0) + 3}
    assert np.isfinite(aux["loss"].item())


def test_bf16_kron_states_take_the_plain_path(cuda):
    """A bf16 Kronecker state never reaches a kernel: `update` and
    `update_multi` on the card take the plain updates and launch nothing."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(18)
    shapes = NMT_TOY
    states = [kron.init(s, fmt=f, init_scale=0.8, dtype=torch.bfloat16, device=cuda)
              for f, s in zip(NMT_FMTS, shapes)]
    assert all(kron.route(f, s, cuda, torch.bfloat16) == "plain" for f, s in zip(NMT_FMTS, shapes))
    dxs = [torch.randn(s, generator=g, device=cuda).bfloat16() for s in shapes]
    dgs = [torch.randn(s, generator=g, device=cuda).bfloat16() for s in shapes]
    before = dict(hopper.counts)
    multi = kron.update_multi(states, dxs, dgs, step=0.1)
    single = [kron.update(st, x, h, step=0.1) for st, x, h in zip(states, dxs, dgs)]
    torch.cuda.synchronize()
    assert hopper.counts == before
    for st in multi + single:
        assert st.ql.dtype == st.qr.dtype == torch.bfloat16
        assert torch.isfinite(st.ql.float()).all() and torch.isfinite(st.qr.float()).all()


# ------------------------------------------------ the flat families (K11-K13)

COINS = [(False, False), (False, True), (True, False), (True, True)]


def _lra_case(g, n, r, dev):
    """A packed (2r, n) state walked off its init by three plain updates,
    with U scaled up so a rebalance moves it, and fresh probes."""
    from psgd_tf_tpu_torch.groups import lra

    st = lra.init(torch.Generator().manual_seed(n), n, rank=r, init_scale=0.8, device=dev)
    st = lra.pack(3.0 * st.U, st.V, st.d)
    with hopper.disabled():
        for k in range(3):
            v, h = (torch.randn(n, generator=g, device=dev) for _ in range(2))
            st = lra.update(st, v, h, 0.05, COINS[k])
    v, h, grad = (torch.randn(n, generator=g, device=dev) for _ in range(3))
    return st, v, h, grad


@pytest.mark.parametrize("n", [1021, 1 << 20])
@pytest.mark.parametrize("coins", COINS, ids=str)
def test_k13_matches_plain(cuda, n, coins):
    g = torch.Generator(device=cuda).manual_seed(5)
    st, v, h, grad = _lra_case(g, n, 10, cuda)
    before = hopper.counts["lra_upd"]
    uv, d = lra_upd.fused_update(st.UV, st.d, v, h, 0.05, coins)
    uv2, d2, pre = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
    torch.cuda.synchronize()
    assert hopper.counts["lra_upd"] == before + 2
    with hopper.disabled():
        ruv, rd, rpre = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
    duv, dd = lra_upd.update_plain(st.UV, st.d, v, h, 0.05, coins)
    for a, b in [(uv, ruv), (d, rd), (uv2, ruv), (d2, rd), (pre, rpre), (uv, duv), (d, dd)]:
        assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("n", [400, 1021, 1 << 20])
@pytest.mark.parametrize("apply", [False, True])
def test_k13_is_one_call_and_repeats(cuda, n, apply):
    """K13 is one C entry a call: the `lra_upd` count moves by one and no
    other, and two calls on the same inputs agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(12)
    st, v, h, grad = _lra_case(g, n, 10, cuda)
    if apply:
        call = lambda: lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, (True, False))
    else:
        call = lambda: lra_upd.fused_update(st.UV, st.d, v, h, 0.05, (True, False))
    before = dict(hopper.counts)
    first = call()
    torch.cuda.synchronize()
    moved = {k: hopper.counts[k] - before[k] for k in before if hopper.counts[k] != before[k]}
    assert moved == {"lra_upd": 1}
    for a, b in zip(call(), first, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("coins", COINS, ids=str)
def test_lra_corners_match_plain(cuda, coins):
    """Corner A and corner B's kernels (through K14's entries) against
    `corner_a_plain` and `corner_b_plain` on the same reduced Grams."""
    g = torch.Generator(device=cuda).manual_seed(11)
    st, v, h, grad = _lra_case(g, 1021, 10, cuda)
    gram, maxs = lra_upd.stage1_plain(st.UV, st.d, h, v)
    k = lra_upd._Kernels(st.UV, st.d, v, h, grad)
    coef, scal = k.corner_a(gram, maxs, 0.05, coins)
    rcoef, rscal = lra_upd.corner_a_plain(gram, maxs, 0.05, coins)
    assert _rel(coef, rcoef) < 1e-4 and _rel(scal, rscal) < 1e-6
    _, nd, gram2 = lra_upd.stage3_plain(st.UV, st.d, h, v, rcoef, rscal, grad)
    ndmax = nd.abs().amax()
    mu, coef4 = k.corner_b(ndmax, 0.05, gram2)
    rmu, rcoef4 = lra_upd.corner_b_plain(ndmax, 0.05, gram2)
    assert mu.item() == rmu.item() and _rel(coef4, rcoef4) < 1e-4
    mu, none = k.corner_b(ndmax, 0.05)
    assert none is None and mu.item() == rmu.item()


@pytest.mark.parametrize("coins", COINS, ids=str)
def test_lra_corner_a_pivots_on_card(cuda, coins):
    """A state whose I + V U^T has a vanishing leading pivot (V U^T =
    IPG - I, U with orthonormal rows): the kernel's LU with partial
    pivoting against `corner_a_plain` (torch.linalg.solve_ex)."""
    rng = np.random.default_rng(4)
    n = 64
    ipg = np.array([[0.0, 1.0, 0.2], [1.0, 0.5, 0.0], [0.3, 0.0, 2.0]])
    u = np.linalg.qr(rng.standard_normal((n, 3)))[0].T
    uv = torch.tensor(np.concatenate([u, (ipg - np.eye(3)) @ u]), dtype=torch.float32, device=cuda)
    d, v, h = (torch.tensor(x, dtype=torch.float32, device=cuda)
               for x in (0.5 + rng.random(n), rng.standard_normal(n), rng.standard_normal(n)))
    gram, maxs = lra_upd.stage1_plain(uv, d, h, v)
    assert (1.0 + gram[3, 0]).abs() < 1e-5
    coef, scal = lra_upd._Kernels(uv, d, v, h, None).corner_a(gram, maxs, 0.05, coins)
    rcoef, rscal = lra_upd.corner_a_plain(gram, maxs, 0.05, coins)
    assert torch.isfinite(coef).all() and _rel(coef, rcoef) < 1e-4 and _rel(scal, rscal) < 1e-6


@pytest.mark.parametrize("n", [1, 2, 128, 129, 400, 1021, 1536, 3841, 4096, 16384])
def test_k11_k12_match_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.triu(0.02 * torch.randn(n, n, generator=g, device=cuda)) + 0.8 * torch.eye(n, device=cuda)
    with hopper.disabled():
        for _ in range(2):
            q = dense_upd.fused_update(q, *(torch.randn(n, generator=g, device=cuda) for _ in range(2)), 0.1)
    v, h, grad = (torch.randn(n, generator=g, device=cuda) for _ in range(3))
    mod, name = (dense_upd, "dense_upd") if n <= dense_upd.MAX_N else (dense_big, "dense_big")
    before = hopper.counts[name]
    got = mod.fused_update(q, v, h, 0.1)
    got_q, got_pre = mod.fused_update_apply(q, v, h, grad, 0.1)
    torch.cuda.synchronize()
    assert hopper.counts[name] == before + 2
    ref_q, ref_pre = dense_upd.update_apply_plain(q, v, h, grad, 0.1)
    assert _rel(got, ref_q) < 1e-4 and _rel(got_q, ref_q) < 1e-4 and _rel(got_pre, ref_pre) < 1e-4
    assert torch.equal(got, got_q)
    assert torch.count_nonzero(torch.tril(got, -1)).item() == 0


def test_k11_identity_extension_is_untouched(cuda):
    """Q padded to a multiple of 128 with an identity block and zero probes
    (the TPU kernel's layout): the extension comes back exactly."""
    g = torch.Generator(device=cuda).manual_seed(7)
    n, m = 1021, 1024
    q = torch.triu(0.02 * torch.randn(n, n, generator=g, device=cuda)) + 0.8 * torch.eye(n, device=cuda)
    v, h = (torch.randn(n, generator=g, device=cuda) for _ in range(2))
    qp = torch.eye(m, device=cuda)
    qp[:n, :n] = q
    pad = lambda x: torch.cat([x, x.new_zeros(m - n)])
    got = dense_upd.fused_update(qp, pad(v), pad(h), 0.1)
    assert torch.equal(got[n:, n:], torch.eye(m - n, device=cuda))
    assert torch.count_nonzero(got[:n, n:]).item() == 0
    assert _rel(got[:n, :n], dense_upd.fused_update(q, v, h, 0.1)) < 1e-5


def test_flat_paths_route_through_their_kernels(cuda):
    from psgd_tf_tpu_torch import PSGD, UVd, dense
    from psgd_tf_tpu_torch.data import xor
    from psgd_tf_tpu_torch.models import rnn

    assert [dense.route(n, cuda) for n in (2, 1536, 1537, 16384, 16385)] == [
        "dense_upd", "dense_upd", "dense_big", "dense_big", "xla"]
    g = torch.Generator(device=cuda).manual_seed(8)
    params = rnn.init(g, hidden=8)
    for fam, name in [("lra", "lra_upd"), ("dense", "dense_upd")]:
        opt = PSGD(preconditioner=fam, grad_clip_max_norm=1.0)
        state = opt.init(params)
        before = hopper.counts[name]
        p = params
        for _ in range(3):
            p, state, aux = opt.step(rnn.loss, p, state, g, *xor.batch(g, 16, 8))
        assert np.isfinite(aux["loss"].item()) and hopper.counts[name] == before + 3
    uvd = UVd(params, grad_clip_max_norm=1.0, generator=g)
    before = hopper.counts["lra_upd"]
    for _ in range(2):
        loss = uvd.step(rnn.loss, *xor.batch(g, 16, 8))
    assert np.isfinite(loss.item()) and hopper.counts["lra_upd"] == before + 2


@pytest.mark.parametrize("n,r", [(1, 1), (5, 3), (255, 32), (4097, 2), (8193, 10)])
def test_k13_edge_shapes(cuda, n, r):
    """Ragged last tiles, a single lane, the largest rank, several Gram
    blocks summed in order."""
    g = torch.Generator(device=cuda).manual_seed(10)
    st, v, h, grad = _lra_case(g, n, r, cuda)
    for coins in COINS:
        got = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
        with hopper.disabled():
            ref = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
        for a, b in zip(got, ref, strict=True):
            assert _rel(a, b) < 1e-4
    with pytest.raises(ValueError, match="2r"):  # an odd row count is no packed (2r, n) UV
        lra_upd.fused_update(torch.zeros(2 * r + 1, n, device=cuda), st.d, v, h, 0.05, (False, True))


RANKS_PAST_32 = [33, 64, 128, 256]


@pytest.mark.parametrize("n", [1021, 100_003])
@pytest.mark.parametrize("r", RANKS_PAST_32)
def test_k13_past_rank_32_matches_plain(cuda, n, r):
    """K13's rank-generic chain (Gram tiles, the block-wide corners): update
    and update + apply under the four coin pairs against the plain chain
    and the direct form, one `lra_upd` count a call, bit-repeatable."""
    g = torch.Generator(device=cuda).manual_seed(16)
    st, v, h, grad = _lra_case(g, n, r, cuda)
    for coins in COINS:
        before = dict(hopper.counts)
        uv, d = lra_upd.fused_update(st.UV, st.d, v, h, 0.05, coins)
        got = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
        torch.cuda.synchronize()
        assert {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]} == {
            "lra_upd": 2}
        with hopper.disabled():
            ref = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
        duv, dd = lra_upd.update_plain(st.UV, st.d, v, h, 0.05, coins)
        for a, b in [(uv, ref[0]), (d, ref[1]), *zip(got, ref, strict=True), (uv, duv), (d, dd)]:
            assert _rel(a, b) < 1e-4
        again = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("n", [1, 127, 128, 129, 200, 1537, 2000, 3841, 4097])
def test_k11_k12_edge_shapes(cuda, n):
    """A single row, ragged panels and chunks, one past K11's cap, the
    dense RNN's n (a one-row last panel), and 33 panels."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.triu(0.05 * torch.randn(n, n, generator=g, device=cuda)) + 0.8 * torch.eye(n, device=cuda)
    v, h, grad = (torch.randn(n, generator=g, device=cuda) for _ in range(3))
    mod = dense_upd if n <= dense_upd.MAX_N else dense_big
    before_tri = hopper.counts["tri"]
    got_q, got_pre = mod.fused_update_apply(q, v, h, grad, 0.1)
    # K3 runs inside K11's one launch, and as K12's first launch
    assert hopper.counts["tri"] == before_tri + (0 if mod is dense_upd else 1)
    ref_q, ref_pre = dense_upd.update_apply_plain(q, v, h, grad, 0.1)
    assert _rel(got_q, ref_q) < 1e-4 and _rel(got_pre, ref_pre) < 1e-4
    assert torch.count_nonzero(torch.tril(got_q, -1)).item() == 0
    z = torch.zeros(n, device=cuda)
    assert torch.equal(mod.fused_update(q, z, z, 0.1), q)  # a zero probe: a zero update


def _dense_case(g, n, dev):
    q = torch.triu(0.02 / n**0.5 * torch.randn(n, n, generator=g, device=dev)) + 0.8 * torch.eye(n, device=dev)
    return q, [torch.randn(n, generator=g, device=dev) for _ in range(3)]


@pytest.mark.parametrize("mod,n", [(dense_upd, 2), (dense_upd, 400), (dense_upd, 1536),
                                   (dense_big, 400), (dense_big, 3841), (dense_big, 16384)],
                         ids=lambda x: getattr(x, "__name__", str(x)).split(".")[-1])
def test_k11_k12_one_count_bit_repeat_zero_probes(cuda, mod, n):
    """One count a call (K12's first launch is K3's and counts one `tri`),
    two calls bit-equal (no float atomics in any sum), and zero probes:
    the step scale saturates, Q' is Q exactly and P' g is Q^T Q g."""
    g = torch.Generator(device=cuda).manual_seed(21)
    q, (v, h, grad) = _dense_case(g, n, cuda)
    before = dict(hopper.counts)
    got = mod.fused_update_apply(q, v, h, grad, 0.1)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    name = "dense_upd" if mod is dense_upd else "dense_big"
    assert moved == ({name: 1} if mod is dense_upd else {name: 1, "tri": 1})
    again = mod.fused_update_apply(q, v, h, grad, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(mod.fused_update(q, v, h, 0.1), got[0])
    z = torch.zeros(n, device=cuda)
    zq, zpre = mod.fused_update_apply(q, z, z, grad, 0.1)
    assert torch.equal(zq, q)
    assert _rel(zpre, q.T @ (q @ grad)) < 1e-4


def test_k11_is_one_launch_and_k12_launches_do_not_grow(cuda):
    """torch.profiler over single calls: a K11 call is one kernel launch
    (no memset either) at n = 2, 400 and 1536, and a K12 call launches as
    many kernels at n = 3841 as at 16384."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(22)

    def launches(mod, n):
        q, (v, h, grad) = _dense_case(g, n, cuda)
        mod.fused_update_apply(q, v, h, grad, 0.1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mod.fused_update_apply(q, v, h, grad, 0.1)
            torch.cuda.synchronize()
        return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    for n in (2, 400, 1536):
        kernels = launches(dense_upd, n)
        assert len(kernels) == 1 and "dense_mono_kernel" in kernels[0], (n, kernels)
    small, big = launches(dense_big, 3841), launches(dense_big, 16384)
    assert len(small) == len(big) <= 10 and all("dense_" in k for k in small + big), (small, big)


# ------------------------------------------------ the sparse-LU family (K15, K16)

def _splu_case(g, n, r, dev):
    """A walked state (`splu.walked_state`) and fresh v, h, g."""
    from psgd_tf_tpu_torch.groups import splu

    st = splu.walked_state(n, r, g, dev)
    return st, [torch.randn(n, generator=g, device=dev) for _ in range(3)]


@pytest.mark.parametrize("n,r", [(2, 1), (11, 10), (400, 10), (65_537, 1), (65_536, 10),
                                 (100_003, 10), (3_000, 32), (200_000, 32)])
def test_k15_k16_match_plain(cuda, n, r):
    """A single tail lane (nt = 1), r = 1 and r = 32, ragged last tiles, the
    bench's n = 65,536 and past the cap: the chain against its plain stages
    and the direct form, update and update + apply."""
    from psgd_tf_tpu_torch.groups import splu

    g = torch.Generator(device=cuda).manual_seed(12)
    st, (v, h, grad) = _splu_case(g, n, r, cuda)
    fields = (st.Lt, st.l3, st.U12, st.u3)
    name = splu.route(r, n, cuda)
    assert name == ("splu_one" if splu_one.fits(r, n) else "splu_upd")
    before = dict(hopper.counts)
    got = splu_upd.fused_update(*fields, v, h, 0.05)
    got_k15 = splu_one.fused_update_apply(*fields, v, h, grad, 0.05)
    new, pre = splu.update_apply(st, v, h, grad, 0.05)
    torch.cuda.synchronize()
    assert hopper.counts["splu_upd"] == before["splu_upd"] + 1 + (name == "splu_upd")
    assert hopper.counts["splu_one"] == before["splu_one"] + 1 + (name == "splu_one")
    with hopper.disabled():
        ref = splu_one.fused_update_apply(*fields, v, h, grad, 0.05)
    direct = splu.update_plain(st, v, h, 0.05)
    for a, b in zip(got, ref[:4]):
        assert _rel(a, b) < 1e-4
    for a, b in zip(got_k15, ref):
        assert _rel(a, b) < 1e-4
    for a, b in zip((new.Lt, new.l3, new.U12, new.u3, pre), ref):
        assert _rel(a, b) < 1e-4
    for a, b in zip(got, (direct.Lt, direct.l3, direct.U12, direct.u3)):
        assert _rel(a, b) < 1e-4
    L1, U1 = got_k15[0][:, :r].T, got_k15[2][:, :r]
    assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))
    # the chain repeats itself bit for bit (no float atomics)
    again = splu_one.fused_update_apply(*fields, v, h, grad, 0.05)
    assert all(torch.equal(a, b) for a, b in zip(again, got_k15))


# ragged n (odd: each row of Lt and U12 starts at each 16-byte alignment in
# turn; n - r = 1 to 3 mod 4) on both sides of the rank-32 kernels
SPLU_RAGGED = [(100_001, 1), (100_001, 3), (100_003, 10), (131_071, 32), (100_002, 33),
               (100_001, 64)]


@pytest.mark.parametrize("n,r", SPLU_RAGGED)
def test_k16_ragged_match_plain_bit_repeat_zero_probes(cuda, n, r):
    """K16's staged passes and Gram tiles (past rank 32 the streamed Gram):
    update and update + apply within 1e-4 of the plain chain, one count
    each, the update equal to the fused apply's first four outputs and to
    itself again bit for bit; zero probes on a balanced state (L = U = 0.7 I)
    leave it exact."""
    from psgd_tf_tpu_torch.groups import splu

    g = torch.Generator(device=cuda).manual_seed(19)
    st, (v, h, grad) = _splu_case(g, n, r, cuda)
    fields = (st.Lt, st.l3, st.U12, st.u3)
    before = dict(hopper.counts)
    got = splu_upd.fused_update(*fields, v, h, 0.05)
    fused = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    torch.cuda.synchronize()
    assert {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]} == {
        "splu_upd": 1, "splu_upd_apply": 1}
    with hopper.disabled():
        plain = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    for a, b in zip(got, plain[:4]):
        assert _rel(a, b) < 1e-4
    for a, b in zip(fused, plain, strict=True):
        assert _rel(a, b) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, fused[:4]))
    assert all(torch.equal(a, b) for a, b in zip(got, splu_upd.fused_update(*fields, v, h, 0.05)))
    zst, z = splu.init(n, rank=r, init_scale=0.7, device=cuda), torch.zeros(n, device=cuda)
    zf = (zst.Lt, zst.l3, zst.U12, zst.u3)
    assert all(torch.equal(a, b) for a, b in zip(splu_upd.fused_update(*zf, z, z, 0.05), zf))


def test_splu_kernels_reject_what_they_do_not_take(cuda):
    from psgd_tf_tpu_torch.groups import splu

    z = torch.zeros(100, device=cuda)
    st = splu.init(100, rank=10, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        splu_one.fused_update(st.Lt.double(), st.l3, st.U12, st.u3, z, z, 0.1)
    st = splu.init(100, rank=100, device=cuda)  # n - r = 0: no tail
    with pytest.raises(ValueError, match="n - r"):
        splu_upd.fused_update(st.Lt, st.l3, st.U12, st.u3, z, z, 0.1)


@pytest.mark.parametrize("n", [400, 100_003])
@pytest.mark.parametrize("r", RANKS_PAST_32)
def test_k15_k16_past_rank_32_match_plain(cuda, n, r):
    """The splu chain's rank-generic kernels, K15's regime (n = 400, the
    route's `splu_one` while it fits) and K16's (100,003): update, update +
    apply and the fused apply entry against the plain chain and the direct
    form, the corner triangles exact, bit-repeatable."""
    from psgd_tf_tpu_torch.groups import splu

    g = torch.Generator(device=cuda).manual_seed(17)
    st, (v, h, grad) = _splu_case(g, n, r, cuda)
    fields = (st.Lt, st.l3, st.U12, st.u3)
    name = splu.route(r, n, cuda)
    assert name == ("splu_one" if splu_one.fits(r, n) else "splu_upd")
    before = dict(hopper.counts)
    got = splu_upd.fused_update(*fields, v, h, 0.05)
    new, pre = splu.update_apply(st, v, h, grad, 0.05)
    fused = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]}
    assert moved == ({"splu_upd": 2, "splu_upd_apply": 1} if name == "splu_upd" else
                     {"splu_upd": 1, "splu_one": 1, "splu_upd_apply": 1})
    with hopper.disabled():
        ref = splu_one.fused_update_apply(*fields, v, h, grad, 0.05)
    direct = splu.update_plain(st, v, h, 0.05)
    for a, b in zip(got, ref[:4]):
        assert _rel(a, b) < 1e-4
    for a, b in zip(fused, ref, strict=True):
        assert _rel(a, b) < 1e-4
    for a, b in zip((new.Lt, new.l3, new.U12, new.u3, pre), ref):
        assert _rel(a, b) < 1e-4
    for a, b in zip(got, (direct.Lt, direct.l3, direct.U12, direct.u3)):
        assert _rel(a, b) < 1e-4
    L1, U1 = fused[0][:, :r].T, fused[2][:, :r]
    assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))
    again = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    assert all(torch.equal(a, b) for a, b in zip(again, fused))


@pytest.mark.parametrize("n,r", [(400, 10), (100_003, 1), (100_003, 32), (1 << 20, 10),
                                 (100_001, 3)])
def test_fused_apply_and_mono_match_plain(cuda, n, r):
    """The fused apply entry (the chain with g) and the one-launch kernel:
    mono equal to the chain bit for bit, both within 1e-4 of the plain
    chain and of the direct form followed by `splu.apply`, each repeating
    itself bit for bit, one count each a call."""
    from psgd_tf_tpu_torch.groups import splu

    g = torch.Generator(device=cuda).manual_seed(14)
    st, (v, h, grad) = _splu_case(g, n, r, cuda)
    fields = (st.Lt, st.l3, st.U12, st.u3)
    before = dict(hopper.counts)
    fused = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    mono = splu_upd.fused_update_apply_mono(*fields, v, h, grad, 0.05)
    torch.cuda.synchronize()
    assert {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]} == {
        "splu_upd_apply": 1, "splu_upd_mono": 1}
    assert all(torch.equal(a, b) for a, b in zip(mono, fused, strict=True))
    with hopper.disabled():
        plain = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    direct = splu.update_plain(st, v, h, 0.05)
    direct = (direct.Lt, direct.l3, direct.U12, direct.u3, splu.apply(direct, grad))
    for got in (fused, mono):
        for a, b, c in zip(got, plain, direct, strict=True):
            assert _rel(a, b) < 1e-4 and _rel(a, c) < 1e-4
        L1, U1 = got[0][:, :r].T, got[2][:, :r]
        assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))
    again = (splu_upd.fused_update(*fields, v, h, 0.05, g=grad),
             splu_upd.fused_update_apply_mono(*fields, v, h, grad, 0.05))
    for got, rep in zip((fused, mono), again):
        assert all(torch.equal(a, b) for a, b in zip(got, rep))
    grid = splu_upd.mono_grid(n, r)
    assert 1 <= grid["grid"] <= min(1024, -(-(n - r) // 256), grid["per_sm"] * grid["sms"])


@pytest.mark.parametrize("n,r", [(65_536, 10), (200_000, 32)])
def test_chain_update_unchanged_by_the_shared_bodies(cuda, n, r):
    """The chain's update (`splu_upd`, no g), whose stage and corner bodies
    the one-launch kernel shares: within 1e-4 of the plain chain, equal to
    the fused apply's first four outputs bit for bit, and repeating itself
    bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(15)
    st, (v, h, grad) = _splu_case(g, n, r, cuda)
    fields = (st.Lt, st.l3, st.U12, st.u3)
    before = hopper.counts["splu_upd"]
    got = splu_upd.fused_update(*fields, v, h, 0.05)
    torch.cuda.synchronize()
    assert hopper.counts["splu_upd"] == before + 1
    with hopper.disabled():
        plain = splu_upd.fused_update(*fields, v, h, 0.05)
    for a, b in zip(got, plain, strict=True):
        assert _rel(a, b) < 1e-4
    fused = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    assert all(torch.equal(a, b) for a, b in zip(got, fused[:4]))
    assert all(torch.equal(a, b) for a, b in zip(got, splu_upd.fused_update(*fields, v, h, 0.05)))


def test_fused_apply_and_mono_reject_what_they_do_not_take(cuda):
    from psgd_tf_tpu_torch.groups import splu

    entries = [lambda *f: splu_upd.fused_update(*f[:6], 0.1, g=f[6]),
               lambda *f: splu_upd.fused_update_apply_mono(*f, 0.1)]
    # r = 33, past the rank-32 kernels: the one-launch kernel takes it (as
    # JAX's takes any rank), bit-equal to the fused apply entry
    g = torch.Generator(device=cuda).manual_seed(16)
    st, (v, h, grad) = _splu_case(g, 100, 33, cuda)
    fused, mono = (entry(st.Lt, st.l3, st.U12, st.u3, v, h, grad) for entry in entries)
    assert all(torch.equal(a, b) for a, b in zip(mono, fused, strict=True))
    with hopper.disabled():
        plain = entries[1](st.Lt, st.l3, st.U12, st.u3, v, h, grad)
    assert all(_rel(a, b) < 1e-4 for a, b in zip(mono, plain, strict=True))
    z = torch.zeros(100, device=cuda)
    st = splu.init(10, rank=10, device=cuda)  # n - r = 0: no tail
    z10 = torch.zeros(10, device=cuda)
    for entry in entries:
        with pytest.raises(ValueError, match="n - r"):
            entry(st.Lt, st.l3, st.U12, st.u3, z10, z10, z10)
    st = splu.init(100, rank=10, device=cuda)
    bad = [(st.Lt.double(), st.l3, st.U12, st.u3, z, z, z),
           (st.Lt, st.l3, st.U12, st.u3, z, z.cpu(), z),
           (st.Lt, st.l3, st.U12, st.u3, z, z, torch.zeros(200, device=cuda)[::2])]
    for entry in entries:
        for args in bad:
            before = dict(hopper.counts)
            with pytest.raises(ValueError, match="float32"):
                entry(*args)
            assert dict(hopper.counts) == before


@pytest.mark.parametrize("n,r", [(20_000, 33), (20_003, 40), (100_003, 64), (30_001, 128),
                                 (6_000, 256)])
def test_mono_past_rank_32_bit_equal_to_the_fused_apply(cuda, n, r):
    """The one-launch kernel past the rank-32 kernels (its rank-generic
    bodies, the GEMM's Gram tiles in a body of its own past rank 128 and
    for the apply): bit-equal to the fused apply entry (the chain with g)
    under every schedule, within 1e-4 of the plain chain, one count a call,
    repeating itself bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(23)
    st, (v, h, grad) = _splu_case(g, n, r, cuda)
    fields = (st.Lt, st.l3, st.U12, st.u3)
    fused = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    before = dict(hopper.counts)
    mono = splu_upd.fused_update_apply_mono(*fields, v, h, grad, 0.05)
    torch.cuda.synchronize()
    assert {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]} == {
        "splu_upd_mono": 1}
    assert all(torch.equal(a, b) for a, b in zip(mono, fused, strict=True))
    with hopper.disabled():
        plain = splu_upd.fused_update(*fields, v, h, 0.05, g=grad)
    assert all(_rel(a, b) < 1e-4 for a, b in zip(mono, plain, strict=True))
    for schedule in ("grid", "cluster"):
        again = splu_upd.launch_mono("splu_upd_mono", *fields, v, h, 0.05, grad,
                                     schedule=schedule)
        assert all(torch.equal(a, b) for a, b in zip(again, fused, strict=True)), schedule


def _k15_sizes():
    """(n, r) of K15's card test: r = 1, 10, 32, 33 and 64, from n = r + 1
    to the largest n where `splu_one.fits(r, n)` holds, and one between."""
    out = []
    for r in (1, 10, 32, 33, 64):
        hi = r + 1
        while splu_one.fits(r, 2 * hi):
            hi *= 2
        step = hi
        while step > 1:  # the largest n that fits, by bisection
            step //= 2
            if splu_one.fits(r, hi + step):
                hi += step
        out += [(r + 1, r), ((r + 1 + hi) // 2 | 1, r), (hi, r)]
    return out


@pytest.mark.parametrize("n,r", _k15_sizes())
def test_k15_one_launch_matches_plain(cuda, n, r):
    """K15 (`splu_one.fused_update`, `fused_update_apply`) is one launch a
    call, with and without g, one count each: within 1e-4 of the plain
    chain and of the direct form, the update alone equal to the first four
    outputs with g, both equal bit for bit to the chain (K16's kernels,
    `splu_upd.launch`), the corner triangles exact, repeating bit for bit,
    the same bits under every schedule; torch.profiler sees one kernel."""
    from torch.profiler import ProfilerActivity, profile

    from psgd_tf_tpu_torch.groups import splu

    assert splu_one.fits(r, n) and splu.route(r, n, cuda) == "splu_one"
    g = torch.Generator(device=cuda).manual_seed(24)
    st, (v, h, grad) = _splu_case(g, n, r, cuda)
    fields = (st.Lt, st.l3, st.U12, st.u3)
    before = dict(hopper.counts)
    upd = splu_one.fused_update(*fields, v, h, 0.05)
    both = splu_one.fused_update_apply(*fields, v, h, grad, 0.05)
    torch.cuda.synchronize()
    assert {k: c - before[k] for k, c in hopper.counts.items() if c != before[k]} == {
        "splu_one": 2}
    with hopper.disabled():
        plain = splu_one.fused_update_apply(*fields, v, h, grad, 0.05)
    direct = splu.update_plain(st, v, h, 0.05)
    assert all(_rel(a, b) < 1e-4 for a, b in zip(both, plain, strict=True))
    assert all(_rel(a, b) < 1e-4 for a, b in zip(upd, (direct.Lt, direct.l3, direct.U12,
                                                       direct.u3)))
    assert all(torch.equal(a, b) for a, b in zip(upd, both[:4]))
    chain = splu_upd.launch("splu_upd", *fields, v, h, 0.05, grad)
    assert all(torch.equal(a, b) for a, b in zip(both, chain, strict=True))
    L1, U1 = both[0][:, :r].T, both[2][:, :r]
    assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))
    again = splu_one.fused_update_apply(*fields, v, h, grad, 0.05)
    assert all(torch.equal(a, b) for a, b in zip(again, both, strict=True))
    for schedule in ("grid", "cluster"):
        other = splu_upd.launch_mono("splu_one", *fields, v, h, 0.05, grad, schedule=schedule)
        assert all(torch.equal(a, b) for a, b in zip(other, both, strict=True)), schedule
    for call in (lambda: splu_one.fused_update(*fields, v, h, 0.05),
                 lambda: splu_one.fused_update_apply(*fields, v, h, grad, 0.05)):
        for _ in range(3):  # the profiler now and then returns a trace without the device's events
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if kernels:
                break
        assert len(kernels) == 1 and "splu_mono" in kernels[0], kernels


def test_all_preconditioners_routes_through_the_kernels(cuda):
    from psgd_tf_tpu_torch.workloads import all_preconditioners

    for fam, name in [("splu", "splu_one"), ("dense", "dense_upd"), ("lra", "lra_upd"),
                      ("kron", "kron_multi"), ("xmat", None)]:
        before = dict(hopper.counts)
        out = all_preconditioners.run(fam, steps=5, device=cuda)
        assert np.isfinite(out["loss"])
        launched = {k for k in hopper.counts if hopper.counts[k] != before[k]}
        if name is None:
            assert not launched
        else:
            assert hopper.counts[name] == before[name] + 5


# --------------------------------------------------------------- K14, the sharded K16

@pytest.fixture
def one_rank(cuda, tmp_path):
    """A one-rank gloo job on the card: the sharded wrappers' entry points
    with every reduction over one rank."""
    import torch.distributed as dist

    from psgd_tf_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield make_mesh(data=1, shard=1, device=cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [1021, 1 << 20])
@pytest.mark.parametrize("coins", COINS, ids=str)
@pytest.mark.parametrize("pipelined", [False, True])
def test_k14_one_rank_matches_k13(one_rank, n, coins, pipelined):
    """K14's update + apply (stage 1 in four lane chunks when pipelined,
    the kernels reading rows at their stride) against its own plain chain
    with the same reductions and against K13."""
    g = torch.Generator(device=one_rank.device).manual_seed(6)
    st, v, h, grad = _lra_case(g, n, 10, one_rank.device)
    call = lambda: lra_upd.fused_update_apply_sharded(st.UV, st.d, v, h, grad, 0.05, coins,
                                                      one_rank, pipelined=pipelined)
    before = hopper.counts["lra_upd_sharded"]
    got = call()
    torch.cuda.synchronize()
    assert hopper.counts["lra_upd_sharded"] == before + 1
    with hopper.disabled():
        plain = call()
    ref = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
    for a, b, c in zip(got, plain, ref):
        assert _rel(a, b) < 1e-4
        assert _rel(a, c) < 1e-4


@pytest.mark.parametrize("n,r", [(11, 10), (400, 10), (100_003, 10), (3_000, 32), (100_001, 3),
                                 (100_002, 33)])
def test_sharded_k16_one_rank_matches_k16(one_rank, n, r):
    """The sharded K16's four entry points against its own plain chain
    with the same reductions and against K16's one entry, update + apply;
    then the same state with three tail lanes of 1-padding (l3 = u3 = 1,
    zero columns and probes) and `tail_valid` = the real lanes: the
    padding leaves the real lanes' result and the balance alone."""
    g = torch.Generator(device=one_rank.device).manual_seed(13)
    st, (v, h, grad) = _splu_case(g, n, r, one_rank.device)
    st = type(st)(st.Lt, 0.5 * st.l3, st.U12, st.u3)  # tail maxima below the padding's 1
    fields = (st.Lt, st.l3, st.U12, st.u3)
    before = hopper.counts["splu_upd_sharded"]
    got = splu_upd.fused_update_sharded(*fields, v, h, 0.05, one_rank, None, grad)
    torch.cuda.synchronize()
    assert hopper.counts["splu_upd_sharded"] == before + 1
    with hopper.disabled():
        plain = splu_upd.fused_update_sharded(*fields, v, h, 0.05, one_rank, None, grad)
    ref = splu_upd.launch("splu_upd", *fields, v, h, 0.05, grad)
    for a, b, c in zip(got, plain, ref):
        assert _rel(a, b) < 1e-4
        assert _rel(a, c) < 1e-4
    pad = lambda x, fill: torch.cat([x, x.new_full(x.shape[:-1] + (3,), fill)], -1)
    padded = (pad(st.Lt, 0.0), pad(st.l3, 1.0), pad(st.U12, 0.0), pad(st.u3, 1.0), pad(v, 0.0),
              pad(h, 0.0), 0.05, one_rank, n - r, pad(grad, 0.0))
    got_p = splu_upd.fused_update_sharded(*padded)
    with hopper.disabled():
        plain_p = splu_upd.fused_update_sharded(*padded)
    for a, b, c in zip(got_p, plain_p, ref):
        assert _rel(a, b) < 1e-4
        assert _rel(a[..., :c.shape[-1]], c) < 1e-4


@pytest.fixture
def one_nccl_rank(cuda):
    """A one-rank NCCL job on the card."""
    import socket

    import torch.distributed as dist

    from psgd_tf_tpu_torch.parallel import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield make_mesh(data=1, shard=1, device=cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("coins", COINS, ids=str)
def test_k14_and_sharded_k16_past_rank_32_on_one_nccl_rank(one_nccl_rank, coins):
    """K14 and the sharded K16 at r = 64 (the rank-generic entries) on one
    NCCL rank: against their plain chains with the same reductions and the
    one-process kernels."""
    dev = one_nccl_rank.device
    g = torch.Generator(device=dev).manual_seed(18)
    st, v, h, grad = _lra_case(g, 100_003, 64, dev)
    call = lambda: lra_upd.fused_update_apply_sharded(st.UV, st.d, v, h, grad, 0.05, coins,
                                                      one_nccl_rank)
    before = hopper.counts["lra_upd_sharded"]
    got = call()
    torch.cuda.synchronize()
    assert hopper.counts["lra_upd_sharded"] == before + 1
    with hopper.disabled():
        plain = call()
    ref = lra_upd.fused_update_apply(st.UV, st.d, v, h, grad, 0.05, coins)
    for a, b, c in zip(got, plain, ref, strict=True):
        assert _rel(a, b) < 1e-4 and _rel(a, c) < 1e-4
    if coins != COINS[0]:
        return
    sst, (v, h, grad) = _splu_case(g, 100_003, 64, dev)
    fields = (sst.Lt, sst.l3, sst.U12, sst.u3)
    before = hopper.counts["splu_upd_sharded"]
    got = splu_upd.fused_update_sharded(*fields, v, h, 0.05, one_nccl_rank, None, grad)
    torch.cuda.synchronize()
    assert hopper.counts["splu_upd_sharded"] == before + 1
    with hopper.disabled():
        plain = splu_upd.fused_update_sharded(*fields, v, h, 0.05, one_nccl_rank, None, grad)
    ref = splu_upd.launch("splu_upd", *fields, v, h, 0.05, grad)
    for a, b, c in zip(got, plain, ref, strict=True):
        assert _rel(a, b) < 1e-4 and _rel(a, c) < 1e-4


# --------------------------------------------------------------- the grouped GEMM

def _operand(g, rows, cols, t, pad, dev, tri=None):
    """A (rows, cols) operand stored as kron_dd.gemm reads it: transposed
    when t, each stored row `pad` floats longer than it needs (the ld);
    tri = 'upper' / 'lower' zeroes the other triangle of op(x) exactly."""
    x = torch.randn(rows, cols, generator=g, device=dev)
    if tri == "upper":
        x = torch.triu(x)
    elif tri == "lower":
        x = torch.tril(x)
    stored = x.T if t else x
    full = torch.zeros(stored.shape[0], stored.shape[1] + pad, device=dev)
    full[:, :stored.shape[1]] = stored
    return full


@pytest.mark.parametrize("tile", ["64", "128"])
@pytest.mark.parametrize("ta,tb", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("M,N,K", [(1, 1, 1), (67, 130, 45), (200, 129, 257), (300, 260, 700)])
@pytest.mark.parametrize("pad", [0, 3, 4])
def test_gemm_matches_float64(cuda, tile, ta, tb, M, N, K, pad):
    """The grouped GEMM's two instantiations against a float64 product:
    ragged M, N, K, both orientations of each operand, row strides that
    keep (0, 4) and break (3) its 16-byte copies; with the two-pass
    difference."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K + pad)
    a, b = _operand(g, M, K, ta, pad, cuda), _operand(g, K, N, tb, pad, cuda)
    a2, b2 = _operand(g, M, K, ta, pad, cuda), _operand(g, K, N, tb, pad, cuda)
    d = lambda x: x.double()
    for args in [(a, b), (a, b, a2, b2)]:
        got, _ = kron_dd.gemm(M, N, K, args[0], ta, args[1], tb, *args[2:], tile=tile)
        want, _ = kron_dd.gemm_plain(M, N, K, d(args[0]), ta, d(args[1]), tb,
                                     *[d(x) for x in args[2:]])
        assert _rel(got.double(), want) < 1e-5


@pytest.mark.parametrize("tile", ["64", "128"])
@pytest.mark.parametrize("cut", ["a_upper", "a_lower", "b_upper", "b_lower"])
@pytest.mark.parametrize("ta,tb", [(0, 0), (1, 1)])
def test_gemm_cuts_match_float64(cuda, tile, cut, ta, tb):
    """Each K-band cut on a triangular operand with exact zeros (the cut
    skips them) against the float64 product, ragged sides."""
    M, N = 190, 133
    g = torch.Generator(device=cuda).manual_seed(7)
    K = M if cut.startswith("a") else N
    tri = "upper" if cut.endswith("upper") else "lower"
    a = _operand(g, M, K, ta, 1, cuda, tri if cut.startswith("a") else None)
    b = _operand(g, K, N, tb, 1, cuda, tri if cut.startswith("b") else None)
    got, _ = kron_dd.gemm(M, N, K, a, ta, b, tb, cut=(cut,), tile=tile)
    want, _ = kron_dd.gemm_plain(M, N, K, a.double(), ta, b.double(), tb)
    assert _rel(got.double(), want) < 1e-5


@pytest.mark.parametrize("tile", ["64", "128"])
@pytest.mark.parametrize("epi", ["triu_max", "triu", "update", "colmul", "coldiv", "arrow",
                                 "rowdiv"])
def test_gemm_epilogues_match_float64(cuda, tile, epi):
    """Every epilogue of the grouped GEMM: the triu ones (tiles below the
    diagonal skipped, max|C| by atomicMax), the factor update with max|grad|
    read on the card, the column and row scales, the arrow rows."""
    M, N, K = 257, 257, 300
    g = torch.Generator(device=cuda).manual_seed(9)
    a, b = _operand(g, M, K, 1, 0, cuda), _operand(g, K, N, 0, 0, cuda)
    a2, b2 = _operand(g, M, K, 1, 0, cuda), _operand(g, K, N, 0, 0, cuda)
    q = torch.randn(M, N, generator=g, device=cuda)
    v = 0.5 + torch.rand(N, generator=g, device=cuda)
    r = 0.5 + torch.rand(2 * M, generator=g, device=cuda)
    extra = dict(q=q, v=v, r=r, mx=3.0, step=0.1)
    got, gmx = kron_dd.gemm(M, N, K, a, 1, b, 0, a2, b2, epi=epi, tile=tile, **extra)
    d = {k: (x.double() if torch.is_tensor(x) else x) for k, x in extra.items()}
    want, wmx = kron_dd.gemm_plain(M, N, K, a.double(), 1, b.double(), 0, a2.double(),
                                   b2.double(), epi=epi, **d)
    assert _rel(got.double(), want) < 1e-5
    if epi.startswith("triu"):
        assert torch.count_nonzero(torch.tril(got, -1)).item() == 0
    if epi == "triu_max":
        assert abs(gmx.item() - wmx.item()) <= 1e-5 * wmx.item()


@pytest.mark.parametrize("splits", [2, 5])
def test_gemm_k_splits_sum_to_the_product(cuda, splits):
    """K cut into bands over the GEMM's grid (K9's and K10's Grams): the
    partials, summed in band order, against the float64 product; each
    band bit-equal to the same band run alone."""
    M, N, K = 129, 129, 1000
    g = torch.Generator(device=cuda).manual_seed(10)
    a, b = _operand(g, M, K, 1, 0, cuda), _operand(g, K, N, 0, 0, cuda)
    part, _ = kron_dd.gemm(M, N, K, a, 1, b, 0, epi="triu", splits=splits)
    assert part.shape == (splits, M, N)
    want, _ = kron_dd.gemm_plain(M, N, K, a.double(), 1, b.double(), 0, epi="triu")
    assert _rel(part.sum(0).double(), want) < 1e-5
    kc = -(-(-(-K // splits)) // 16) * 16  # a band: K / splits rounded up to the K step
    kb = min(kc, K - kc)
    band, _ = kron_dd.gemm(M, N, kb, a[kc:kc + kb].contiguous(), 1, b[kc:kc + kb].contiguous(), 0,
                           epi="triu")
    assert torch.equal(part[1], band)
