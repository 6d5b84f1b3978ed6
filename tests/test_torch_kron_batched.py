"""Port parity for the batched (dense, dense) Kronecker path: the stacked,
identity-padded state, its update (K4's plain version on the CPU), its
apply, the `KronPrecond` bucketing of PSGD and the interop converters,
psgd_tf_tpu_torch against psgd_tf_tpu on the CPU with the same numpy
inputs. The counterpart of `tests/test_kron_batched.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psgd_tf_tpu.hvp as jhvp
from psgd_tf_tpu import PSGD as JPSGD
from psgd_tf_tpu.groups import kron as jkron
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import kron_dd as jkron_dd
from psgd_tf_tpu.optim.psgd import KronPrecond as JKronPrecond
from psgd_tf_tpu_torch import PSGD, interop, kron
from psgd_tf_tpu_torch.ops.hopper import kron_dd
from psgd_tf_tpu_torch.optim.psgd import KronPrecond

torch.set_num_threads(1)

DD = ("dense", "dense")
SHAPES = [(26, 6), (121, 84), (85, 10), (100, 128)]  # one (128, 128) bucket
FORMATS = [[DD] * 4, [("scale", "dense")] + [DD] * 3]


def _probes(rng, shapes):
    return ([rng.standard_normal(s).astype(np.float32) for s in shapes],
            [rng.standard_normal(s).astype(np.float32) for s in shapes])


def _t(arrays):
    return interop.tensors(arrays, device="cpu")


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _padding_is_identity(q, sides):
    for i, d in enumerate(sides):
        want = torch.eye(q.shape[1], dtype=q.dtype)
        want[:d, :d] = q[i, :d, :d]
        if not torch.equal(q[i], want):
            return False
    return True


def test_init_batched_matches_jax():
    bst, jbst = kron.init_batched(SHAPES, init_scale=0.5, device="cpu"), jkron.init_batched(
        tuple(SHAPES), init_scale=0.5)
    assert bst.shapes == jbst.shapes == tuple(SHAPES)
    jql, jqr = _t([jbst.ql, jbst.qr])
    assert torch.equal(bst.ql, jql) and torch.equal(bst.qr, jqr)
    dx = _t([np.ones(s, np.float32) for s in SHAPES])
    np.testing.assert_array_equal(kron.stack_padded(dx, 128, 128).numpy(),
                                  np.asarray(jkron.stack_padded(_j(dx), 128, 128)))


def test_update_batched_matches_per_layer():
    rng = np.random.default_rng(0)
    bst = kron.init_batched(SHAPES, device="cpu")
    singles = [kron.init(s, DD, device="cpu") for s in SHAPES]
    for _ in range(4):
        dxs, dgs = map(_t, _probes(rng, SHAPES))
        bst = kron.update_batched(bst, dxs, dgs, step=0.1)
        singles = [kron.update(s, x, g, step=0.1) for s, x, g in zip(singles, dxs, dgs)]
    for u, s in zip(kron.unbatch(bst), singles, strict=True):
        np.testing.assert_allclose(u.ql.numpy(), s.ql.numpy(), atol=2e-5)
        np.testing.assert_allclose(u.qr.numpy(), s.qr.numpy(), atol=2e-5)
    # the identity padding stays exact, not merely close
    assert _padding_is_identity(bst.ql, [m for m, _ in SHAPES])
    assert _padding_is_identity(bst.qr, [n for _, n in SHAPES])


def test_update_batched_matches_jax_and_padding_stays_exact():
    """Twenty updates from the same numpy probes in both packages; the
    padding of both stacks is exact identity after the last."""
    rng = np.random.default_rng(1)
    bst, jbst = kron.init_batched(SHAPES, device="cpu"), jkron.init_batched(tuple(SHAPES))
    for k in range(20):
        dxs, dgs = _probes(rng, SHAPES)
        bst = kron.update_batched(bst, _t(dxs), _t(dgs), step=0.1)
        jbst = jkron.update_batched(jbst, _j(dxs), _j(dgs), step=0.1)
        if k == 0:  # one update: fp32 sums in other orders
            np.testing.assert_allclose(bst.ql.numpy(), np.asarray(jbst.ql), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(bst.qr.numpy(), np.asarray(jbst.qr), rtol=1e-5, atol=1e-6)
    # ROADMAP's trajectory bound
    np.testing.assert_allclose(bst.ql.numpy(), np.asarray(jbst.ql), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(bst.qr.numpy(), np.asarray(jbst.qr), rtol=5e-4, atol=5e-5)
    assert _padding_is_identity(bst.ql, [m for m, _ in SHAPES])
    assert _padding_is_identity(bst.qr, [n for _, n in SHAPES])


def test_plain_k4_matches_jax_pallas_interpret():
    """The port's plain K4 against the JAX package's gridded Pallas kernel
    in interpret mode, on one walked stack."""
    rng = np.random.default_rng(2)
    jbst = jkron.init_batched(tuple(SHAPES))
    for _ in range(2):
        jbst = jkron.update_batched(jbst, *map(_j, _probes(rng, SHAPES)), step=0.1)
    dxs, dgs = _probes(rng, SHAPES)
    dx, dg = jkron.stack_padded(_j(dxs), 128, 128), jkron.stack_padded(_j(dgs), 128, 128)
    ms, ns = [m for m, _ in SHAPES], [n for _, n in SHAPES]
    jql, jqr = jkron_dd.fused_update_batched(
        jbst.ql, jbst.qr, dx, dg, jnp.asarray(ms, jnp.int32), jnp.asarray(ns, jnp.int32), 0.1,
        jlinalg.tiny(jnp.float32), interpret=True)
    ql, qr = kron_dd.fused_update_batched(*_t([jbst.ql, jbst.qr, dx, dg]), torch.tensor(ms),
                                          torch.tensor(ns), 0.1)
    np.testing.assert_allclose(ql.numpy(), np.asarray(jql), atol=1e-5)
    np.testing.assert_allclose(qr.numpy(), np.asarray(jqr), atol=1e-5)


def test_apply_batched_matches_jax():
    rng = np.random.default_rng(3)
    jbst = jkron.update_batched(jkron.init_batched(tuple(SHAPES)), *map(_j, _probes(rng, SHAPES)),
                                step=0.2)
    bst = interop.batched_dd_state(np.asarray(jbst.ql), np.asarray(jbst.qr), jbst.shapes,
                                   device="cpu")
    gs = _t([rng.standard_normal(s).astype(np.float32) for s in SHAPES])
    got = kron.apply_batched(bst, gs)
    jgot = jkron.apply_batched(jbst, _j(gs))
    for p, jp, s, g in zip(got, jgot, kron.unbatch(bst), gs, strict=True):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=2e-4)
        np.testing.assert_allclose(p.numpy(), kron.apply(s, g).numpy(), atol=2e-4)


def test_unbatch_and_interop_round_trip():
    rng = np.random.default_rng(4)
    jbst = jkron.update_batched(jkron.init_batched(tuple(SHAPES)), *map(_j, _probes(rng, SHAPES)),
                                step=0.1)
    bst = interop.batched_dd_state(np.asarray(jbst.ql), np.asarray(jbst.qr), jbst.shapes,
                                   device="cpu")
    for u, ju in zip(kron.unbatch(bst), jkron.unbatch(jbst), strict=True):
        assert u.fmt == tuple(ju.fmt) == DD and u.ql.is_contiguous()
        np.testing.assert_array_equal(u.ql.numpy(), np.asarray(ju.ql))
        np.testing.assert_array_equal(u.qr.numpy(), np.asarray(ju.qr))

    params = [jnp.zeros(s) for s in SHAPES + [(5, 300)]]
    jpc = JPSGD(preconditioner="kron").init(params).precond
    assert isinstance(jpc, JKronPrecond)
    pc = interop.kron_precond(
        [(np.asarray(b.ql), np.asarray(b.qr), b.shapes) for b in jpc.batches],
        [(np.asarray(s.ql), np.asarray(s.qr), s.fmt) for s in jpc.singles],
        jpc.batched_idx, jpc.single_idx, device="cpu")
    want = PSGD(preconditioner="kron").init([torch.zeros(s) for s in SHAPES + [(5, 300)]]).precond
    assert isinstance(pc, KronPrecond) and isinstance(want, KronPrecond)
    assert pc.batched_idx == want.batched_idx == ((0, 1, 2, 3),) and pc.single_idx == (4,)
    assert torch.equal(pc.batches[0].ql, want.batches[0].ql)
    assert torch.equal(pc.batches[0].qr, want.batches[0].qr)
    assert pc.batches[0].shapes == want.batches[0].shapes
    assert pc.singles[0].fmt == want.singles[0].fmt == ("dense", "dense")
    assert torch.equal(pc.singles[0].qr, want.singles[0].qr)


def _loss(p):
    return sum(torch.sum(w * w) * 0.5 + torch.sum(torch.sin(w)) for w in p)


def _jloss(p):
    return sum(jnp.sum(w * w) * 0.5 + jnp.sum(jnp.sin(w)) for w in p)


def _params(seed):
    rng = np.random.default_rng(seed)
    return [0.1 * rng.standard_normal(s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("formats", FORMATS, ids=["dd", "sd+dd"])
def test_optimizer_batched_trajectory_matches_unbatched(formats):
    w = _params(5)
    rng = np.random.default_rng(6)
    probes = [_probes(rng, SHAPES)[0] for _ in range(10)]

    def run(batched):
        opt = PSGD(preconditioner="kron", kron_formats=formats, lr_params=0.05,
                   lr_preconditioner=0.1, kron_batched=batched, kron_batch_min=2)
        p = _t(w)
        state = opt.init(p)
        assert isinstance(state.precond, KronPrecond) == batched
        for v in probes:
            p, state, aux = opt.step(_loss, p, state, None, probes=_t(v))
        return p, aux["loss"]

    pb, lb = run(True)
    pu, lu = run(False)
    for a, b in zip(pb, pu, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)
    assert lb.item() == pytest.approx(lu.item(), rel=1e-5)


@pytest.mark.parametrize("formats", FORMATS, ids=["dd", "sd+dd"])
def test_optimizer_batched_trajectory_matches_jax(formats, monkeypatch):
    """Ten PSGD steps on the batched path in both packages, the same
    probes injected into both."""
    w = _params(7)
    rng = np.random.default_rng(8)
    probes = [_probes(rng, SHAPES)[0] for _ in range(10)]
    hyper = dict(preconditioner="kron", kron_formats=formats, lr_params=0.05,
                 lr_preconditioner=0.1, kron_batch_min=2)
    jopt = JPSGD(**hyper)
    jparams = _j(w)
    jstate = jopt.init(jparams, jax.random.PRNGKey(0))
    probe = []
    monkeypatch.setattr(jhvp, "random_like", lambda key, params: probe[0])

    def jstep(params, state, v):
        probe[:] = [v]
        return jopt.step(_jloss, params, state, jax.random.PRNGKey(1))

    jstep = jax.jit(jstep)
    opt = PSGD(**hyper)
    params = _t(w)
    state = opt.init(params)
    for v in probes:
        jparams, jstate, jaux = jstep(jparams, jstate, _j(v))
        params, state, aux = opt.step(_loss, params, state, None, probes=_t(v))
        assert aux["loss"].item() == pytest.approx(float(jaux["loss"]), rel=5e-4)
    assert state.precond.batched_idx == jstate.precond.batched_idx
    assert state.precond.single_idx == jstate.precond.single_idx
    for a, b in zip(params, jparams, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)
    for b, jb in zip(state.precond.batches, jstate.precond.batches, strict=True):
        np.testing.assert_allclose(b.ql.numpy(), np.asarray(jb.ql), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(b.qr.numpy(), np.asarray(jb.qr), rtol=5e-4, atol=5e-5)
        assert _padding_is_identity(b.ql, [m for m, _ in b.shapes])
        assert _padding_is_identity(b.qr, [n for _, n in b.shapes])
    for s, js in zip(state.precond.singles, jstate.precond.singles, strict=True):
        np.testing.assert_allclose(s.ql.numpy(), np.asarray(js.ql), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(s.qr.numpy(), np.asarray(js.qr), rtol=5e-4, atol=5e-5)


def test_bucket_threshold_respected():
    """The port buckets as the JAX package does: below kron_batch_min, with
    kron_batched off, and for a non-fp32 state, a plain list."""
    shapes = [(20, 6), (30, 8)]
    opt = PSGD(preconditioner="kron", kron_formats=[DD] * 2, kron_batch_min=4)
    jopt = JPSGD(preconditioner="kron", kron_formats=[DD] * 2, kron_batch_min=4)
    assert isinstance(opt.init([torch.ones(s) for s in shapes]).precond, list)
    assert isinstance(jopt.init([jnp.ones(s) for s in shapes]).precond, list)
    pc = PSGD(preconditioner="kron", kron_formats=[DD] * 2, kron_batch_min=2).init(
        [torch.ones(s) for s in shapes]).precond
    assert isinstance(pc, KronPrecond) and pc.batched_idx == ((0, 1),) and pc.single_idx == ()
    four = [torch.ones(s) for s in SHAPES]
    assert isinstance(PSGD(preconditioner="kron", kron_batched=False).init(four).precond, list)
    assert isinstance(PSGD(preconditioner="kron", dtype=torch.bfloat16).init(four).precond, list)
    # a side past 1024 is never bucketed
    wide = [torch.ones(1025, 4) for _ in range(4)]
    assert isinstance(PSGD(preconditioner="kron", kron_formats=DD).init(wide).precond, list)


def test_bf16_batched_state_takes_the_plain_update():
    rng = np.random.default_rng(9)
    bst = kron.init_batched(SHAPES, dtype=torch.bfloat16, device="cpu")
    dxs, dgs = (_t(x) for x in _probes(rng, SHAPES))
    out = kron.update_batched(bst, [x.bfloat16() for x in dxs], [g.bfloat16() for g in dgs], 0.1)
    assert out.ql.dtype == out.qr.dtype == torch.bfloat16
    ref = kron.update_batched(kron.init_batched(SHAPES, device="cpu"), dxs, dgs, 0.1)
    np.testing.assert_allclose(out.ql.float().numpy(), ref.ql.numpy(), atol=3e-2)
