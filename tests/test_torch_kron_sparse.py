"""Port parity: the sparse Kronecker pairs of psgd_tf_tpu_torch on the CPU
(the plain versions of K1's sparse kinds, K5, K6, K7/K8, K9 and K10)
against the JAX package's XLA path and its Pallas kernels in interpret
mode."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import kron as jkron
from psgd_tf_tpu.models import nmt as jnmt
from psgd_tf_tpu.ops import pallas as pallas_ops
from psgd_tf_tpu.ops.pallas import kron_sparse as jks
from psgd_tf_tpu.ops.pallas import kron_sparse_big as jksb
from psgd_tf_tpu_torch import interop
from psgd_tf_tpu_torch.groups import kron
from psgd_tf_tpu_torch.ops.hopper import kron_multi, kron_sparse, kron_sparse_big

torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny * np.finfo(np.float32).eps)
SPARSE = [("norm", "dense"), ("dense", "norm"), ("dense", "scale"),
          ("scale", "dense"), ("norm", "scale"), ("scale", "norm")]
ALL = [("dense", "dense")] + SPARSE


def _probes(rng, shapes):
    return (
        [rng.standard_normal(s).astype(np.float32) for s in shapes],
        [rng.standard_normal(s).astype(np.float32) for s in shapes],
    )


def _walked(rng, fmts, shapes, steps=3, init_scale=0.8):
    """JAX KronStates walked `steps` XLA updates off the identity."""
    states = [jkron.init(s, fmt=f, init_scale=init_scale) for f, s in zip(fmts, shapes)]
    for _ in range(steps):
        dxs, dgs = _probes(rng, shapes)
        states = [jkron.update(st, jnp.asarray(x), jnp.asarray(g), step=0.05)
                  for st, x, g in zip(states, dxs, dgs)]
    return states


def _to_port(jstates):
    return interop.kron_states([(np.asarray(s.ql), np.asarray(s.qr), s.fmt) for s in jstates],
                               device="cpu")


def _close(got, ref, rtol, atol):
    for g, r in zip(got, ref, strict=True):
        assert g.fmt == tuple(r.fmt)
        np.testing.assert_allclose(g.ql.numpy(), np.asarray(r.ql), rtol=rtol, atol=atol)
        np.testing.assert_allclose(g.qr.numpy(), np.asarray(r.qr), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fmt", SPARSE, ids=str)
@pytest.mark.parametrize("shape", [(12, 8), (130, 65), (321, 128)])
def test_update_matches_jax_xla(fmt, shape):
    rng = np.random.default_rng(sum(shape))
    (jst,) = _walked(rng, [fmt], [shape])
    (dx,), (dg,) = _probes(rng, [shape])
    ref = jkron.update(jst, jnp.asarray(dx), jnp.asarray(dg), step=0.05)
    (st,) = _to_port([jst])
    got = kron.update(st, torch.from_numpy(dx), torch.from_numpy(dg), step=0.05)
    # the JAX suite's own bound for kron_sparse against its XLA path
    _close([got], [ref], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kind", ["ns", "ds", "nd"])
def test_k5_plain_matches_jax_pallas_interpret(kind):
    fmt = {"ns": ("norm", "scale"), "ds": ("dense", "scale"), "nd": ("norm", "dense")}[kind]
    shape = (130, 65)
    rng = np.random.default_rng(7)
    (jst,) = _walked(rng, [fmt], [shape])
    (dx,), (dg,) = _probes(rng, [shape])
    jfn = {"ns": jks.fused_update_ns, "ds": jks.fused_update_ds, "nd": jks.fused_update_nd}[kind]
    rl, rr = jfn(jst.ql, jst.qr, jnp.asarray(dx), jnp.asarray(dg), 0.05, TINY, interpret=True)
    ql, qr = interop.tensors([np.asarray(jst.ql), np.asarray(jst.qr)], device="cpu")
    gl, gr = kron_sparse.FUSED_UPDATE[kind](ql, qr, torch.from_numpy(dx), torch.from_numpy(dg), 0.05)
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(gr.numpy(), np.asarray(rr), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("fmt,shape", [
    (("norm", "scale"), (700, 130)),
    (("norm", "scale"), (1030, 257)),
    (("dense", "scale"), (130, 900)),
    (("dense", "scale"), (260, 1500)),
], ids=str)
def test_streaming_k6_k10_match_jax(fmt, shape):
    """K6/K10's plain kernel part plus the shared tail, against the JAX
    streaming kernels in interpret mode and the XLA path."""
    kind = "ns" if fmt[0] == "norm" else "ds"
    assert not kron_sparse.fits(*shape) and kron_sparse_big.fits_grid(kind, *shape)
    rng = np.random.default_rng(31)
    (jst,) = _walked(rng, [fmt], [shape])
    (dx,), (dg,) = _probes(rng, [shape])
    ref = jkron.update(jst, jnp.asarray(dx), jnp.asarray(dg), step=0.05)
    jfn = jksb.fused_update_ns if kind == "ns" else jksb.fused_update_ds
    kl, kr = jfn(jst.ql, jst.qr, jnp.asarray(dx), jnp.asarray(dg), 0.05, TINY, interpret=True)
    ql, qr = interop.tensors([np.asarray(jst.ql), np.asarray(jst.qr)], device="cpu")
    fn = kron_sparse_big.fused_update_ns if kind == "ns" else kron_sparse_big.fused_update_ds
    gl, gr = fn(ql, qr, torch.from_numpy(dx), torch.from_numpy(dg), 0.05)
    # the JAX suite's own bound for kron_sparse_big against its XLA path
    for got, want in [(gl, kl), (gr, kr), (gl, ref.ql), (gr, ref.qr)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5, atol=5e-6)
    (st,) = _to_port([jst])
    via_update = kron.update(st, torch.from_numpy(dx), torch.from_numpy(dg), step=0.05)
    assert torch.equal(via_update.ql, gl) and torch.equal(via_update.qr, gr)


# the JAX suite's own bound for kron_sparse_big against its XLA path
BIG_TOL = dict(rtol=5e-5, atol=5e-6)


@pytest.mark.parametrize("fmt,shape", [
    (("norm", "dense"), (600, 64)),
    (("norm", "dense"), (1024, 384)),
    (("norm", "dense"), (2048, 10)),
    (("dense", "norm"), (48, 700)),
], ids=str)
def test_streaming_k9_matches_jax(fmt, shape):
    """K9's plain kernel part plus its tail, against `fused_update_nd` in
    interpret mode and the XLA path; the mirrored (dense, norm) layer
    transposes in, its probes as dX.T views."""
    mirrored = fmt[0] == "dense"
    m, n = shape[::-1] if mirrored else shape
    assert not kron_sparse.fits(m, n) and kron_sparse_big.fits_grid("nd", m, n)
    assert kron.route(fmt, shape, "cuda") == jkron.route(fmt, shape) == "kron_sparse_big:nd"
    rng = np.random.default_rng(33)
    (jst,) = _walked(rng, [fmt], [shape])
    (dx,), (dg,) = _probes(rng, [shape])
    ref = jkron.update(jst, jnp.asarray(dx), jnp.asarray(dg), step=0.05)
    arrow, dense = (jst.qr, jst.ql) if mirrored else (jst.ql, jst.qr)
    jx, jg = (jnp.asarray(a.T if mirrored else a) for a in (dx, dg))
    ka, kd = jksb.fused_update_nd(arrow, dense, jx, jg, 0.05, TINY, interpret=True)
    ql, Qr = interop.tensors([np.asarray(arrow), np.asarray(dense)], device="cpu")
    tx, tg = torch.from_numpy(dx), torch.from_numpy(dg)
    ga, gd = kron_sparse_big.fused_update_nd(ql, Qr, *(t.T if mirrored else t for t in (tx, tg)),
                                             0.05)
    ra, rd = (ref.qr, ref.ql) if mirrored else (ref.ql, ref.qr)
    for got, want in [(ga, ka), (gd, kd), (ga, ra), (gd, rd)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BIG_TOL)
    assert ga[1, -1].item() == 0.0
    assert torch.equal(gd, torch.triu(gd))
    (st,) = _to_port([jst])
    via_update = kron.update(st, tx, tg, step=0.05)
    assert torch.equal(via_update.ql, gd if mirrored else ga)
    assert torch.equal(via_update.qr, ga if mirrored else gd)


@pytest.mark.parametrize("fmt,shape,jname", [
    (("norm", "scale"), (70, 140_000), "_fused_update_ns_wide2"),
    (("scale", "norm"), (140_000, 70), "_fused_update_ns_wide2"),
    (("norm", "scale"), (16, 140_000), "_fused_update_ns_wide_xla"),
], ids=str)
def test_wide_k7_k8_match_jax(fmt, shape, jname):
    """The wide (norm, scale) update past MAX_LANES (K7/K8's plain kernel
    part, shared with K6, plus the tail), against the two JAX wide
    functions in interpret mode and the XLA path. Both JAX functions
    compute one update; K8 is held at a width K7 also takes."""
    mirrored = fmt[0] == "scale"
    m, n = shape[::-1] if mirrored else shape
    assert kron_sparse_big._lanes(n) > kron_sparse_big.MAX_LANES
    assert kron.route(fmt, shape, "cuda") == jkron.route(fmt, shape) == "kron_sparse_big:ns_wide"
    rng = np.random.default_rng(34)
    (jst,) = _walked(rng, [fmt], [shape], steps=2)
    (dx,), (dg,) = _probes(rng, [shape])
    ref = jkron.update(jst, jnp.asarray(dx), jnp.asarray(dg), step=0.05)
    arrow, scale = (jst.qr, jst.ql) if mirrored else (jst.ql, jst.qr)
    jx, jg = (jnp.asarray(a.T if mirrored else a) for a in (dx, dg))
    jfn = jax.jit(functools.partial(getattr(jksb, jname), tiny=TINY, interpret=True))
    ka, ks = jfn(arrow, scale, jx, jg, jnp.float32(0.05))
    ql, qr = interop.tensors([np.asarray(arrow), np.asarray(scale)], device="cpu")
    tx, tg = torch.from_numpy(dx), torch.from_numpy(dg)
    ga, gs = kron_sparse_big.fused_update_ns(ql, qr, *(t.T if mirrored else t for t in (tx, tg)),
                                             0.05)
    ra, rs = (ref.qr, ref.ql) if mirrored else (ref.ql, ref.qr)
    for got, want in [(ga, ka), (gs, ks), (ga, ra), (gs, rs)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BIG_TOL)
    assert ga[1, -1].item() == 0.0
    (st,) = _to_port([jst])
    via_update = kron.update(st, tx, tg, step=0.05)
    assert torch.equal(via_update.ql, gs if mirrored else ga)
    assert torch.equal(via_update.qr, ga if mirrored else gs)


def test_mirrored_k10_layer_matches_jax():
    """A (scale, dense) layer past the resident cap transposes into K10."""
    shape = (900, 130)
    rng = np.random.default_rng(32)
    (jst,) = _walked(rng, [("scale", "dense")], [shape])
    (dx,), (dg,) = _probes(rng, [shape])
    ref = jkron.update(jst, jnp.asarray(dx), jnp.asarray(dg), step=0.05)
    (st,) = _to_port([jst])
    got = kron.update(st, torch.from_numpy(dx), torch.from_numpy(dg), step=0.05)
    _close([got], [ref], rtol=5e-5, atol=5e-6)


def test_update_multi_toy_nmt_matches_jax_k1():
    cfg = jnmt.Config()
    fmts, shapes = jnmt.kron_formats(cfg), jnmt.layer_shapes(cfg)
    rng = np.random.default_rng(0)
    jstates = _walked(rng, fmts, shapes, steps=2)
    dxs, dgs = _probes(rng, shapes)
    jx, jg = [jnp.asarray(x) for x in dxs], [jnp.asarray(g) for g in dgs]
    ref_xla = [jkron.update(st, x, g, step=0.05) for st, x, g in zip(jstates, jx, jg)]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("shard",))
    with pallas_ops.sharding(mesh):  # kernels_active() on CPU: K1, interpreted
        ref_k1 = jkron.update_multi(jstates, jx, jg, step=0.05)
    got = kron.update_multi(_to_port(jstates), interop.tensors(dxs, device="cpu"),
                            interop.tensors(dgs, device="cpu"), step=0.05)
    _close(got, ref_xla, rtol=2e-5, atol=2e-6)
    _close(got, ref_k1, rtol=2e-5, atol=2e-6)


def test_k1_plain_kinds_match_per_layer_plain():
    rng = np.random.default_rng(3)
    kinds = ["ds", "ns", "nd", "dd"]
    fmts = [("dense", "scale"), ("norm", "scale"), ("norm", "dense"), ("dense", "dense")]
    shapes = [(20, 9), (9, 20), (17, 5), (6, 6)]
    states = _to_port(_walked(rng, fmts, shapes))
    dxs, dgs = (interop.tensors(a, device="cpu") for a in _probes(rng, shapes))
    res = kron_multi.fused_update_multi(
        kinds, [s.ql for s in states], [s.qr for s in states], dxs, dgs, 0.1)
    for (a, b), st, x, g in zip(res, states, dxs, dgs):
        want = kron.update(st, x, g, step=0.1)
        assert torch.equal(a, want.ql) and torch.equal(b, want.qr)
    with pytest.raises(ValueError, match="unknown kind"):
        kron_multi.fused_update_multi(["sd"], [states[0].ql], [states[0].qr], dxs[:1], dgs[:1], 0.1)


@pytest.mark.parametrize("shape", [(37, 21), (600, 96)])
def test_arrow_convention_preserved(shape):
    """ql[1, -1] stays exactly 0 through the (norm, *) updates, resident
    and streaming."""
    rng = np.random.default_rng(5)
    for fmt in [("norm", "scale"), ("norm", "dense"), ("scale", "norm")]:
        st = kron.init(shape[::-1] if fmt[0] == "scale" else shape, fmt=fmt, init_scale=0.6,
                       device="cpu")
        for _ in range(3):
            (dx,), (dg,) = _probes(rng, [st.ql.shape[-1:] + st.qr.shape[-1:]])
            st = kron.update(st, torch.from_numpy(dx), torch.from_numpy(dg), step=0.1)
        arrow = st.ql if fmt[0] == "norm" else st.qr
        assert arrow[1, -1].item() == 0.0


@pytest.mark.parametrize("fmt", ALL, ids=str)
def test_apply_matches_jax(fmt):
    rng = np.random.default_rng(4)
    shape = (26, 9)
    (jst,) = _walked(rng, [fmt], [shape])
    g = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jkron.apply(jst, jnp.asarray(g)))
    (st,) = _to_port([jst])
    np.testing.assert_allclose(kron.apply(st, torch.from_numpy(g)).numpy(), ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("fmt", ALL, ids=str)
def test_materialize_matches_jax(fmt):
    rng = np.random.default_rng(6)
    (jst,) = _walked(rng, [fmt], [(11, 7)], steps=2)
    (st,) = _to_port([jst])
    for a, b in zip(kron.materialize(st), jkron.materialize(jst)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cfg", [jnmt.Config(), jnmt.ref_config()], ids=["toy", "ref"])
def test_route_matches_jax_at_nmt_widths(cfg):
    fmts, shapes = jnmt.kron_formats(cfg), jnmt.layer_shapes(cfg)
    want = [jkron.route(f, s) for f, s in zip(fmts, shapes)]
    assert [kron.route(f, s, "cuda") for f, s in zip(fmts, shapes)] == want
    assert all(kron.route(f, s, "cpu") == "plain" for f, s in zip(fmts, shapes))


def test_route_unported_and_xla_regimes_match_jax():
    """The K9, K7 and K8 regimes and the plain ('xla') one past the caps."""
    for fmt, shape in [
        (("norm", "scale"), (256, 256)),
        (("norm", "scale"), (128, 1_000_000)),
        (("scale", "norm"), (1_000_000, 128)),
        (("norm", "scale"), (64, 3_000_017)),
        (("norm", "scale"), (8, (1 << 23) + 1)),
        (("norm", "dense"), (4096, 512)),
        (("dense", "norm"), (512, 4096)),
        (("norm", "dense"), (4096, 2048)),
        (("dense", "scale"), (2048, 4096)),
    ]:
        assert kron.route(fmt, shape, "cuda") == jkron.route(fmt, shape), (fmt, shape)
    assert kron.route(("norm", "dense"), (4096, 512), "cuda") == "kron_sparse_big:nd"
    assert kron.route(("scale", "norm"), (1_000_000, 128), "cuda") == "kron_sparse_big:ns_wide"
    assert kron.route(("norm", "scale"), (64, 3_000_017), "cuda") == "kron_sparse_big:ns_wide"
    assert kron.route(("norm", "scale"), (8, (1 << 23) + 1), "cuda") == "xla"
    assert kron.route(("norm", "dense"), (4096, 2048), "cuda") == "xla"
    # the wide kernel's launches count under the JAX function the width takes
    assert kron_sparse_big.WIDE2_MAX_LANES == jksb.WIDE2_MAX_LANES
    assert kron_sparse_big.ns_wide_counter(1_000_000) == "kron_sparse_big_ns_wide2"
    assert kron_sparse_big.ns_wide_counter(jksb.WIDE2_MAX_LANES) == "kron_sparse_big_ns_wide2"
    assert kron_sparse_big.ns_wide_counter(3_000_017) == "kron_sparse_big_ns_wide_xla"
    # the port's (dense, dense) chain has no side cap; JAX reports 'xla' past 1024
    assert kron.route(("dense", "dense"), (2048, 64), "cuda") == "kron_dd"


def test_unported_route_on_cpu_takes_plain():
    """On the CPU a K9-routed layer runs K9's plain kernel part and tail
    (the card launches K9), equal to the XLA path."""
    rng = np.random.default_rng(8)
    shape = (600, 20)
    assert not kron_sparse.fits(*shape)
    (jst,) = _walked(rng, [("norm", "dense")], [shape], steps=1)
    (dx,), (dg,) = _probes(rng, [shape])
    ref = jkron.update(jst, jnp.asarray(dx), jnp.asarray(dg), step=0.05)
    (st,) = _to_port([jst])
    _close([kron.update(st, torch.from_numpy(dx), torch.from_numpy(dg), step=0.05)], [ref],
           rtol=2e-5, atol=2e-6)


def test_init_all_formats_and_interop_takes_sparse_arrays():
    for fmt in ALL:
        jst = jkron.init((9, 5), fmt=fmt, init_scale=0.7)
        st = kron.init((9, 5), fmt=fmt, init_scale=0.7, device="cpu")
        np.testing.assert_array_equal(st.ql.numpy(), np.asarray(jst.ql))
        np.testing.assert_array_equal(st.qr.numpy(), np.asarray(jst.qr))
        (back,) = _to_port([jst])
        assert back.fmt == fmt and back.ql.shape == st.ql.shape and back.qr.shape == st.qr.shape
    with pytest.raises(ValueError):
        kron.init((8, 4), fmt=("norm", "norm"), device="cpu")
    with pytest.raises(ValueError):
        kron.init((8, 4), fmt=("scale", "scale"), device="cpu")
