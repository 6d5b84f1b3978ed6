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
from psgd_tf_tpu_torch.ops.hopper import kron_dd, kron_multi, kron_sparse, tri

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
        "psgd_tf_tpu_torch.workloads.nmt_attention, psgd_tf_tpu_torch.interop\n"
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
        "kron_dd.cu", "kron_sparse_big.cu", "tri.cu"}
    for src in (PKG / "csrc").glob("*.cu"):
        text = src.read_text()
        assert "psgd_tf_tpu/ops/pallas/" in text  # names the kernel it replaces


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
    opt = PSGD(kron_formats=[("dense", "dense")] * 5, lr_params=0.1, lr_preconditioner=0.1,
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
    assert hopper.counts["kron_multi"] == before["kron_multi"] + 1
    assert hopper.counts["tri"] == before["tri"] + 1
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


@pytest.mark.parametrize("fmt,shape", [
    (f, s) for f, s in zip(NMT_FMTS, NMT_REF) if f != ("dense", "dense")], ids=str)
def test_k6_k10_match_plain_at_reference_shapes(cuda, fmt, shape):
    """K6 ((norm, scale)) and K10 (mirrored (scale, dense), so dX arrives
    transposed) through `kron.update`, against the plain update."""
    from psgd_tf_tpu_torch import kron

    g = torch.Generator(device=cuda).manual_seed(4)
    name = "kron_sparse_big_ns" if fmt == ("norm", "scale") else "kron_sparse_big_ds"
    assert kron.route(fmt, shape, cuda) == ("kron_sparse_big:ns" if fmt[0] == "norm"
                                            else "kron_sparse_big:ds")
    (st,), (dx,), (dg,) = _walked_states(g, [fmt], [shape], cuda, steps=2)
    before = hopper.counts[name]
    got = kron.update(st, dx, dg, step=0.1)
    torch.cuda.synchronize()
    assert hopper.counts[name] == before + 1
    with hopper.disabled():
        ref = kron.update(st, dx, dg, step=0.1)
    assert _states_rel([got], [ref]) < 1e-4
    if fmt[0] == "norm":
        assert got.ql[1, -1].item() == 0.0


def test_unported_routes_raise_on_card(cuda):
    from psgd_tf_tpu_torch import kron

    for fmt, shape, name in [(("norm", "dense"), (4096, 512), "K9"),
                             (("norm", "scale"), (128, 200_000), "K7/K8")]:
        st = kron.init(shape, fmt=fmt, device=cuda)
        z = torch.zeros(shape, device=cuda)
        with pytest.raises(NotImplementedError, match=name):
            kron.update(st, z, z, step=0.1)
