"""Port parity: the (dense, dense) Kronecker update of psgd_tf_tpu_torch on
the CPU (the plain version of K1/K2) against the JAX package's XLA path and
its Pallas kernel K1 in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import kron as jkron
from psgd_tf_tpu.ops import pallas as pallas_ops
from psgd_tf_tpu_torch import interop
from psgd_tf_tpu_torch.groups import kron
from psgd_tf_tpu_torch.ops import hopper

torch.set_num_threads(1)

LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
DD = ("dense", "dense")


def _probes(rng, shapes):
    return (
        [rng.standard_normal(s).astype(np.float32) for s in shapes],
        [rng.standard_normal(s).astype(np.float32) for s in shapes],
    )


def _walked_states(rng, shapes, steps=2):
    """JAX KronStates walked `steps` XLA updates off the identity."""
    states = [jkron.init(s, fmt=DD, init_scale=0.8) for s in shapes]
    for _ in range(steps):
        dxs, dgs = _probes(rng, shapes)
        states = [
            jkron.update(st, jnp.asarray(x), jnp.asarray(g), step=0.1)
            for st, x, g in zip(states, dxs, dgs)
        ]
    return states


def _to_port(jstates):
    return interop.kron_states([(np.asarray(s.ql), np.asarray(s.qr), s.fmt) for s in jstates],
                               device="cpu")


def _t(arrays):
    return interop.tensors(arrays, device="cpu")


def _assert_states_close(got, ref, rtol, atol):
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_allclose(g.ql.numpy(), np.asarray(r.ql), rtol=rtol, atol=atol)
        np.testing.assert_allclose(g.qr.numpy(), np.asarray(r.qr), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", LENET5)
def test_update_matches_jax_xla(shape):
    rng = np.random.default_rng(sum(shape))
    (jst,) = _walked_states(rng, [shape])
    (dx,), (dg,) = _probes(rng, [shape])
    ref = jkron.update(jst, jnp.asarray(dx), jnp.asarray(dg), step=0.1)
    (st,) = _to_port([jst])
    got = kron.update(st, torch.from_numpy(dx), torch.from_numpy(dg), step=0.1)
    _assert_states_close([got], [ref], rtol=2e-5, atol=2e-6)


def test_update_multi_matches_jax_xla_and_pallas_k1():
    rng = np.random.default_rng(0)
    jstates = _walked_states(rng, LENET5)
    dxs, dgs = _probes(rng, LENET5)
    jx, jg = [jnp.asarray(x) for x in dxs], [jnp.asarray(g) for g in dgs]
    ref_xla = [jkron.update(st, x, g, step=0.1) for st, x, g in zip(jstates, jx, jg)]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("shard",))
    with pallas_ops.sharding(mesh):  # kernels_active() on CPU: K1, interpreted
        ref_k1 = jkron.update_multi(jstates, jx, jg, step=0.1)
    got = kron.update_multi(_to_port(jstates), _t(dxs), _t(dgs), step=0.1)
    # the JAX suite's own tolerance between its kernel and its XLA path
    _assert_states_close(got, ref_xla, rtol=2e-5, atol=2e-6)
    _assert_states_close(got, ref_k1, rtol=2e-5, atol=2e-6)


def test_update_multi_20_step_trajectory():
    rng = np.random.default_rng(1)
    jstates = [jkron.init(s, fmt=DD, init_scale=0.8) for s in LENET5]
    states = _to_port(jstates)
    update = jax.jit(lambda sts, xs, gs: jkron.update_multi(sts, xs, gs, step=0.1))
    for _ in range(20):
        dxs, dgs = _probes(rng, LENET5)
        jstates = update(jstates, [jnp.asarray(x) for x in dxs], [jnp.asarray(g) for g in dgs])
        states = kron.update_multi(states, _t(dxs), _t(dgs), step=0.1)
    # fp32 rounding compounds over 20 chained steps: ROADMAP's trajectory bound
    _assert_states_close(states, jstates, rtol=5e-4, atol=5e-5)


def test_zero_probe_gives_no_nan():
    """A zero probe makes both group gradients exactly 0: the saturating
    step scale keeps the update finite (the Pallas kernel's unsaturated
    `step / (0 + tiny) * 0` would be NaN)."""
    rng = np.random.default_rng(2)
    jstates = _walked_states(rng, LENET5[:2])
    zeros = [np.zeros(s, np.float32) for s in LENET5[:2]]
    ref = [jkron.update(st, jnp.asarray(z), jnp.asarray(z), step=0.1) for st, z in zip(jstates, zeros)]
    got = kron.update_multi(_to_port(jstates), _t(zeros), _t(zeros), step=0.1)
    for g in got:
        assert torch.isfinite(g.ql).all() and torch.isfinite(g.qr).all()
    _assert_states_close(got, ref, rtol=2e-5, atol=2e-6)


def test_apply_matches_jax():
    rng = np.random.default_rng(4)
    jstates = _walked_states(rng, [(26, 6), (85, 10), (6, 26)])
    gs = [rng.standard_normal(st.ql.shape[:1] + st.qr.shape[:1]).astype(np.float32) for st in jstates]
    for jst, st, g in zip(jstates, _to_port(jstates), gs):
        ref = np.asarray(jkron.apply(jst, jnp.asarray(g)))
        np.testing.assert_allclose(kron.apply(st, torch.from_numpy(g)).numpy(), ref, rtol=2e-5, atol=2e-6)


def test_route_and_unported_formats():
    for shape in LENET5:
        assert kron.route(DD, shape, "cpu") == "plain"
    with hopper.disabled():
        assert kron.route(DD, (26, 6), "cuda") == "plain"
    assert kron.route(DD, (26, 6), "cuda") == "kron_dd"
    # the sparse pairs are ported: each reports its kernel on CUDA, mirrors
    # their canonical sibling's, and takes the plain update on the CPU
    for fmt, cuda_route in [(("norm", "dense"), "kron_sparse:nd"),
                            (("dense", "scale"), "kron_sparse:ds"),
                            (("scale", "norm"), "kron_sparse:ns")]:
        st = kron.init((8, 4), fmt=fmt, device="cpu")
        assert st.fmt == fmt
        assert kron.route(fmt, (8, 4), "cpu") == "plain"
        assert kron.route(fmt, (8, 4), "cuda") == cuda_route
    with pytest.raises(ValueError):
        kron.init((8, 4), fmt=("norm", "norm"), device="cpu")
    st = kron.init((8, 4), fmt=DD, init_scale=0.5, device="cpu")
    assert torch.equal(st.ql, 0.5 * torch.eye(8)) and st.fmt == DD
