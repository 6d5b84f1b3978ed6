"""Port parity for the flat families: diag, dense (K11, K12) and lra (K13),
psgd_tf_tpu_torch's plain versions on the CPU against psgd_tf_tpu on the
same numpy inputs (the XLA paths, and the Pallas kernels in interpret
mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu import PSGD as JPSGD
from psgd_tf_tpu.groups import dense as jdense
from psgd_tf_tpu.groups import diag as jdiag
from psgd_tf_tpu.groups import lra as jlra
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import dense_big as jdense_big
from psgd_tf_tpu.ops.pallas import dense_upd as jdense_upd
from psgd_tf_tpu.ops.pallas import lra_upd as jlra_upd
from psgd_tf_tpu_torch import PSGD, dense, diag, interop, lra
from psgd_tf_tpu_torch.ops import hopper, linalg
from psgd_tf_tpu_torch.ops.hopper import dense_big, dense_upd, lra_upd

torch.set_num_threads(1)
TINY = jlinalg.tiny(jnp.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _vecs(n, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


# ------------------------------------------------------------------ linalg

def test_linalg_helpers_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(40).astype(np.float32) for _ in range(2))
    q = np.triu(rng.standard_normal((40, 40))).astype(np.float32)
    m = rng.standard_normal((6, 6)).astype(np.float32) + 6 * np.eye(6, dtype=np.float32)
    np.testing.assert_allclose(linalg.triu_outer_diff_matmul(_t(a), _t(b), _t(q)).numpy(),
                               jlinalg.triu_outer_diff_matmul(a, b, q), rtol=1e-5, atol=1e-5)
    assert linalg.triu_outer_diff_maxabs(_t(a), _t(b)).item() == pytest.approx(
        float(jlinalg.triu_outer_diff_maxabs(a, b)), rel=1e-6)
    np.testing.assert_allclose(linalg.solve_small(_t(m), _t(a[:6])).numpy(),
                               jlinalg.solve_small(m, a[:6]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(linalg.tril(_t(q)).numpy(), np.asarray(jlinalg.tril(q)))


# ------------------------------------------------------------------ diag

@pytest.mark.parametrize("fn", ["update", "closed_form_update", "apply"])
def test_diag_matches_jax(fn):
    n = 257
    q0 = np.abs(_vecs(n, 1, 1)[0]) + 0.5
    v, h, g = _vecs(n, 3, 2)
    jst, st = jdiag.DiagState(q=jnp.asarray(q0)), interop.diag_state(q0, device="cpu")
    if fn == "apply":
        got, want = diag.apply(st, _t(g)), jdiag.apply(jst, jnp.asarray(g))
    else:
        got = getattr(diag, fn)(st, _t(v), _t(h), 0.1).q
        want = getattr(jdiag, fn)(jst, jnp.asarray(v), jnp.asarray(h), 0.1).q
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-7)


# ------------------------------------------------------------------ dense

def _dense_q(n, seed):
    rng = np.random.default_rng(seed)
    q = np.triu(0.02 * rng.standard_normal((n, n))) + 0.5 * np.eye(n)
    return q.astype(np.float32)


@pytest.mark.parametrize("n", [2, 130])
def test_dense_matches_jax_xla_path(n):
    q = _dense_q(n, 3)
    v, h, g = _vecs(n, 3, 4)
    jst = jdense.DenseState(Q=jnp.asarray(q))
    st = interop.dense_state(q, device="cpu")
    want = jdense.update(jst, v, h, 0.1).Q
    want_st, want_pre = jdense.update_apply(jst, v, h, g, 0.1)
    np.testing.assert_allclose(dense.update(st, _t(v), _t(h), 0.1).Q.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    got_st, got_pre = dense.update_apply(st, _t(v), _t(h), _t(g), 0.1)
    np.testing.assert_allclose(got_st.Q.numpy(), np.asarray(want_st.Q), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dense.apply(st, _t(g)).numpy(), np.asarray(jdense.apply(jst, g)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dense.materialize(st).numpy(), np.asarray(jdense.materialize(jst)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [130, 300])
def test_k11_matches_pallas_interpret(n):
    """The JAX suite's bound for dense_upd (tests/test_pallas.py)."""
    q = _dense_q(n, 5)
    v, h, g = _vecs(n, 3, 6)
    want = jdense_upd.fused_update(q, v, h, 0.1, TINY, interpret=True)
    np.testing.assert_allclose(dense_upd.fused_update(_t(q), _t(v), _t(h), 0.1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    want_q, want_pre = jdense_upd.fused_update_apply(q, v, h, g, 0.1, TINY, interpret=True)
    got_q, got_pre = dense_upd.fused_update_apply(_t(q), _t(v), _t(h), _t(g), 0.1)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), rtol=1e-4, atol=1e-5)


def test_k12_matches_pallas_interpret(monkeypatch):
    """dense_big's 128-row panel schedule at an interpret-tractable size,
    as tests/test_pallas.py runs it, with its bounds."""
    monkeypatch.setattr(jdense_big, "BLK_SWITCH_N", 256)
    n = 300
    q = _dense_q(n, 7)
    v, h, g = _vecs(n, 3, 8)
    want_q, want_pre = jdense_big.fused_update_apply(q, v, h, g, 0.05, TINY, interpret=True)
    got_q, got_pre = dense_big.fused_update_apply(_t(q), _t(v), _t(h), _t(g), 0.05)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), rtol=2e-4, atol=2e-5)
    got = dense_big.fused_update(_t(q), _t(v), _t(h), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_q), rtol=2e-5, atol=2e-6)


def test_dense_route_at_the_caps():
    assert dense_upd.MAX_N == jdense_upd.MAX_N and dense_big.MAX_N == jdense_big.MAX_N
    assert dense.route(16, "cpu") == "plain"
    assert [dense.route(n, "cuda") for n in (1536, 1537, 16384, 16385)] == [
        "dense_upd", "dense_big", "dense_big", "xla"]
    assert dense.route(64, "cuda", torch.bfloat16) == "plain"
    with hopper.disabled():
        assert dense.route(64, "cuda") == "plain"


# ------------------------------------------------------------------ lra

COINS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture(scope="module")
def coin_keys():
    """One JAX key per coin pair (balance, update_u), recovered as
    `lra.update` splits its key (tests/test_golden.py)."""
    keys = {}
    i = 0
    while len(keys) < 4:
        k = jax.random.PRNGKey(200000 + i)
        i += 1
        k_bal, k_uv = jax.random.split(k)
        coins = (bool(jax.random.uniform(k_bal, dtype=jnp.float32) < 0.01),
                 bool(jax.random.uniform(k_uv, dtype=jnp.float32) < 0.5))
        keys.setdefault(coins, k)
    return keys


def _lra_case(n, r, seed):
    key = jax.random.PRNGKey(seed)
    st = jlra.init(key, n, rank=r, init_scale=0.8)
    st = jlra.pack(st.U * 3.0, st.V, st.d)  # imbalanced, so a rebalance moves it
    v, h, g = _vecs(n, 3, seed)
    return st, v, h, g


def _close(got, want):
    """tests/test_lra_fused.py's bound: atol 3e-5 of the largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("r", [3, 10, 40, 64])
@pytest.mark.parametrize("n", [300, 1021])
@pytest.mark.parametrize("coins", COINS, ids=str)
def test_lra_matches_jax(coin_keys, n, r, coins):
    """The port's direct form against `lra.update` (XLA), and its K13 chain
    (plain stages) against `lra_upd.fused_update(_apply)` in interpret mode;
    r = 40 and 64 past the rank-32 kernels, where the card takes K13's
    rank-generic chain."""
    st, v, h, g = _lra_case(n, r, n + r)
    k = coin_keys[coins]
    ref = jlra.update(st, v, h, 0.05, k)
    ref_apply = jlra.apply(ref, g)
    kst = interop.lra_state(np.asarray(st.UV), np.asarray(st.d), device="cpu")
    got = lra.update(kst, _t(v), _t(h), 0.05, coins)
    _close(got.UV, ref.UV)
    _close(got.d, ref.d)
    got_st, got_pre = lra.update_apply(kst, _t(v), _t(h), _t(g), 0.05, coins)
    _close(got_st.UV, ref.UV)
    _close(got_pre, ref_apply)

    want = jlra_upd.fused_update_apply(st.UV, st.d, v, h, g, 0.05, k, TINY, interpret=True)
    chain = lra_upd.fused_update_apply(_t(st.UV), _t(st.d), _t(v), _t(h), _t(g), 0.05, coins)
    for a, b in zip(chain, want, strict=True):
        _close(a, b)
    want_uv, want_d = jlra_upd.fused_update(st.UV, st.d, v, h, 0.05, k, TINY, interpret=True)
    uv, d = lra_upd.fused_update(_t(st.UV), _t(st.d), _t(v), _t(h), 0.05, coins)
    _close(uv, want_uv)
    _close(d, want_d)


def test_lra_packed_layout_and_pack():
    rng = np.random.default_rng(9)
    U, V = rng.standard_normal((2, 3, 50)).astype(np.float32)
    d = np.abs(rng.standard_normal(50)).astype(np.float32) + 0.5
    st = lra.pack(_t(U), _t(V), _t(d))
    jst = jlra.pack(jnp.asarray(U), jnp.asarray(V), jnp.asarray(d))
    assert st.UV.shape == (6, 50)
    np.testing.assert_array_equal(st.UV.numpy(), np.asarray(jst.UV))
    np.testing.assert_array_equal(st.U.numpy(), U)
    np.testing.assert_array_equal(st.V.numpy(), V)
    np.testing.assert_allclose(lra.materialize(st).numpy(), np.asarray(jlra.materialize(jst)),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="coins"):
        lra.update(st, st.d, st.d, 0.1)


def test_psgd_defaults_build_what_jax_builds():
    params = [torch.zeros(33, 30), torch.zeros(31, 1)]
    state = PSGD().init(params)
    assert PSGD().preconditioner == "lra" and PSGD().rank == 10
    assert isinstance(state.precond, lra.LRAState)
    assert state.precond.UV.shape == (20, 1021) and state.precond.d.shape == (1021,)
    assert state.branch is not None and state.branch.device.type == "cpu"
    for fam, cls in [("dense", dense.DenseState), ("diag", diag.DiagState)]:
        assert isinstance(PSGD(preconditioner=fam).init(params).precond, cls)
    for fam in ("xmat", "shift", "splu"):  # ported: they build what JAX builds
        jst = JPSGD(preconditioner=fam).init(
            {"a": jnp.zeros((33, 30)), "b": jnp.zeros((31, 1))}, jax.random.PRNGKey(0)).precond
        st = PSGD(preconditioner=fam).init(params).precond
        assert type(st).__name__ == type(jst).__name__
        for name in ("af", "bf", "Lt", "l3", "U12", "u3"):
            if hasattr(st, name):
                np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)))
    # the same seed draws the same U, V
    again = PSGD().init(params)
    assert torch.equal(state.precond.UV, again.precond.UV)
