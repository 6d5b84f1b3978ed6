"""Port parity for the sparse-LU family (K15, K16): psgd_tf_tpu_torch on the
CPU against psgd_tf_tpu on the same numpy inputs. The port's direct form
and its kernel chain's plain stages are held to the JAX XLA path, to
`splu_one.fused_update` and to `splu_upd.fused_update_stream` in interpret
mode, with the JAX suite's bounds (rtol 2e-5, atol 2e-6)."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import splu as jsplu
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import splu_one as jsplu_one
from psgd_tf_tpu.ops.pallas import splu_upd as jsplu_upd
from psgd_tf_tpu_torch import PSGD, interop, splu
from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import splu_one, splu_upd

torch.set_num_threads(1)
TINY = jlinalg.tiny(jnp.float32)
TOL = dict(rtol=2e-5, atol=2e-6)
# the JAX tests' shapes (tests/test_groups.py, tests/test_pallas.py), the
# all-preconditioners workload's n = 400, r = 10, and ranks past 32, where
# the card takes the chain's rank-generic kernels
SHAPES = [(64, 6), (100, 10), (300, 4), (48, 1), (400, 10), (300, 40), (400, 64)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _walked(n, r, seed, steps=3):
    """A JAX state walked `steps` updates off 0.7 I, and fresh v, h, g."""
    rng = np.random.default_rng(seed)
    st = jsplu.init(n, rank=r, init_scale=0.7)
    for _ in range(steps):
        v, h = (jnp.asarray(rng.standard_normal(n).astype(np.float32)) for _ in range(2))
        st = jsplu.update(st, v, h, step=0.1)
    return st, [rng.standard_normal(n).astype(np.float32) for _ in range(3)]


def _port(jst):
    return interop.splu_state(*(np.asarray(x) for x in (jst.Lt, jst.l3, jst.U12, jst.u3)),
                              device="cpu")


def _close_state(got, want, **tol):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **(tol or TOL))


def _fields(st):
    return st.Lt, st.l3, st.U12, st.u3


@pytest.mark.parametrize("n,r", SHAPES)
def test_direct_form_matches_jax_xla(n, r):
    jst, (v, h, g) = _walked(n, r, n + r)
    want = jsplu.update(jst, v, h, step=0.05)
    want_pre = jsplu.apply(want, g)
    st = _port(jst)
    assert splu.route(r, n, "cpu") == "plain"
    _close_state(_fields(splu.update(st, _t(v), _t(h), 0.05)), _fields(want))
    got, pre = splu.update_apply(st, _t(v), _t(h), _t(g), 0.05)
    _close_state(_fields(got), _fields(want))
    np.testing.assert_allclose(pre.numpy(), np.asarray(want_pre), **TOL)
    np.testing.assert_allclose(splu.apply(st, _t(g)).numpy(), np.asarray(jsplu.apply(jst, g)), **TOL)
    np.testing.assert_allclose(splu.materialize(st).numpy(), np.asarray(jsplu.materialize(jst)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,r", SHAPES)
def test_k15_chain_matches_pallas_interpret(n, r):
    """K15's wrapper on CPU tensors (the chain's plain stages) against the
    Pallas kernel in interpret mode and the XLA path, update and
    update + apply."""
    jst, (v, h, g) = _walked(n, r, 2 * n + r)
    want = jsplu_one.fused_update(jst.Lt, jst.l3, jst.U12, jst.u3, v, h, 0.05, TINY,
                                  interpret=True, g=g)
    xla = jsplu.update(jst, v, h, step=0.05)
    st = _port(jst)
    got = splu_one.fused_update_apply(*_fields(st), _t(v), _t(h), _t(g), 0.05)
    _close_state(got, want)
    _close_state(got[:4], _fields(xla))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(jsplu.apply(xla, g)), **TOL)
    _close_state(splu_one.fused_update(*_fields(st), _t(v), _t(h), 0.05), want[:4])
    # the triangles come out exact
    L1, U1 = got[0][:, :r].T, got[2][:, :r]
    assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))


@pytest.mark.parametrize("g_too", [False, True])
def test_k15_one_launch_entries_past_rank_32_match_pallas_interpret(g_too):
    """K15's entries (one launch on the card, the chain's plain stages here)
    at r = 40 and a ragged n against `splu_one.fused_update` in interpret
    mode, with and without g; the update alone equal bit for bit to the
    first four outputs with g."""
    n, r = 257, 40
    jst, (v, h, g) = _walked(n, r, 7 * n + r)
    want = jsplu_one.fused_update(jst.Lt, jst.l3, jst.U12, jst.u3, v, h, 0.05, TINY,
                                  interpret=True, g=g if g_too else None)
    st = _port(jst)
    both = splu_one.fused_update_apply(*_fields(st), _t(v), _t(h), _t(g), 0.05)
    got = both if g_too else splu_one.fused_update(*_fields(st), _t(v), _t(h), 0.05)
    _close_state(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], both[:4], strict=True))


def test_k16_chain_matches_stream_interpret():
    """The streaming regime at (3000, 5): JAX's padded SpLUStreamState (its
    cap patched, as tests/test_groups.py forces it) through its logical
    views, K16's chain against `fused_update_stream` in interpret mode, and
    the port's apply of the new state against JAX's fused P' g."""
    _k16_stream_case(3000, 5)


def test_k16_chain_matches_stream_interpret_past_rank_32():
    """The same at r = 40, where the card takes the rank-generic chain."""
    _k16_stream_case(3000, 40)


def _k16_stream_case(n, r):
    with mock.patch.object(jsplu_one, "fits", lambda r_, n_: False):
        jst = jsplu.init(n, rank=r, init_scale=0.7)
    assert isinstance(jst, jsplu.SpLUStreamState)
    rng = np.random.default_rng(3)
    v, h, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    out = jsplu_upd.fused_update_stream(jst.L1t, jst.U1, jst.L2tp, jst.U2p, jst.l3p, jst.u3p,
                                        jst.n, v, h, 0.05, TINY, interpret=True, g=g)
    want = jst.replace(L1t=out[0], U1=out[1], L2tp=out[2], U2p=out[3], l3p=out[4], u3p=out[5])
    st = _port(jst)  # the logical views
    assert st.Lt.shape == (r, n) and st.l3.shape == (n - r,)
    got = splu.SpLUState(*splu_upd.fused_update(*_fields(st), _t(v), _t(h), 0.05))
    _close_state(_fields(got), _fields(want))
    np.testing.assert_allclose(splu.apply(got, _t(g)).numpy(), np.asarray(out[6]), **TOL)
    # a second step from the stream state's views agrees with the XLA path
    leg = jsplu.SpLUState(Lt=want.Lt, l3=want.l3, U12=want.U12, u3=want.u3)
    v2, h2 = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    _close_state(splu_upd.fused_update(*_fields(got), _t(v2), _t(h2), 0.05),
                 _fields(jsplu.update(leg, v2, h2, step=0.05)))


@pytest.mark.parametrize("path", ["direct", "chain"])
def test_twenty_step_trajectory_matches_jax(path):
    """ROADMAP's trajectory bound, 5e-4, over 20 chained updates at the
    workload's n = 400, r = 10."""
    _twenty_steps(path, 400, 10)


@pytest.mark.parametrize("path", ["direct", "chain"])
def test_twenty_step_trajectory_past_rank_32(path):
    """The same bound at r = 40 (the rank-generic chain's plain stages)."""
    _twenty_steps(path, 400, 40)


def _twenty_steps(path, n, r):
    rng = np.random.default_rng(11)
    jst = jsplu.init(n, rank=r, init_scale=0.5)
    st = splu.init(n, rank=r, init_scale=0.5, device="cpu")
    for _ in range(20):
        v, h = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
        jst = jsplu.update(jst, jnp.asarray(v), jnp.asarray(h), step=0.1)
        if path == "direct":
            st = splu.update(st, _t(v), _t(h), 0.1)
        else:
            st = splu.SpLUState(*splu_one.fused_update(*_fields(st), _t(v), _t(h), 0.1))
    _close_state(_fields(st), _fields(jst), rtol=5e-4, atol=5e-5)
    L1, U1 = st.Lt[:, :r].T, st.U12[:, :r]
    assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))


def test_route_at_the_cap():
    assert splu_one.fits(10, 400) and splu_one.fits(10, 65_536)
    for r, n in [(10, 400), (10, 65_536), (10, 92_000), (10, 93_000), (10, 1 << 20), (1, 100_003),
                 (32, 30_000), (32, 40_000), (4, 300)]:
        assert splu_one.fits(r, n) == jsplu_one.fits(r, n), (r, n)
        assert splu.route(r, n, "cuda") == ("splu_one" if jsplu_one.fits(r, n) else "splu_upd")
    assert splu.route(10, 92_000, "cuda") == "splu_one"
    assert splu.route(10, 93_000, "cuda") == "splu_upd"
    assert splu.route(10, 400, "cpu") == "plain"
    assert splu.route(10, 10, "cuda") == "plain"          # n - r < 1: no tail
    assert splu.route(10, 400, "cuda", torch.bfloat16) == "plain"
    with hopper.disabled():
        assert splu.route(10, 400, "cuda") == "plain"


def test_init_and_degenerate_rank():
    jst, st = jsplu.init(30, rank=6, init_scale=0.7), splu.init(30, rank=6, init_scale=0.7,
                                                              device="cpu")
    _close_state(_fields(st), _fields(jst), rtol=0, atol=0)
    assert st.rank == 6 and st.L12.shape == (30, 6)
    # rank >= n: the tails are empty and the direct form still updates
    st = splu.init(4, rank=10, device="cpu")
    assert st.rank == 4 and st.l3.numel() == 0
    jst = jsplu.init(4, rank=10)
    v, h = _t([1.0, -2.0, 0.5, 3.0]), _t([0.3, 1.0, -1.0, 2.0])
    _close_state(_fields(splu.update(st, v, h, 0.1)),
                 _fields(jsplu.update(jst, v.numpy(), h.numpy(), step=0.1)))


def test_psgd_builds_the_new_families():
    params = [torch.zeros(5, 10), torch.zeros(5, 20), torch.zeros(5, 50)]
    for fam, cls in [("xmat", "XMatState"), ("shift", "ShiftState"), ("splu", "SpLUState")]:
        state = PSGD(preconditioner=fam).init(params)
        assert type(state.precond).__name__ == cls
    st = PSGD(preconditioner="splu", rank=7).init(params).precond
    assert st.Lt.shape == (7, 400) and st.l3.shape == (393,)
    jst = jax.tree_util.tree_map(np.asarray, jsplu.init(400, rank=7))
    assert jst.Lt.shape == tuple(st.Lt.shape)
