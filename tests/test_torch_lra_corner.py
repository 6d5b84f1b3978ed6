"""K13's rank-space corners on the CPU: `corner_a_plain` and `corner_b_plain`
(the plain versions of csrc/lra.cu's corner kernels) inside the full plain
chain against JAX `lra_upd.fused_update(_apply)` in interpret mode, with
the coins injected and the probes from numpy; and a system I + V U^T that
partial pivoting must reorder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import lra as jlra
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import lra_upd as jlra_upd
from psgd_tf_tpu_torch.ops import linalg
from psgd_tf_tpu_torch.ops.hopper import lra_upd

torch.set_num_threads(1)
TINY = jlinalg.tiny(jnp.float32)
COINS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture(scope="module")
def coin_keys():
    """One JAX key per coin pair (balance, update_u), recovered as
    `lra_upd._update_impl` splits its key."""
    keys, i = {}, 0
    while len(keys) < 4:
        k = jax.random.PRNGKey(300000 + i)
        i += 1
        k_bal, k_uv = jax.random.split(k)
        coins = (bool(jax.random.uniform(k_bal, dtype=jnp.float32) < 0.01),
                 bool(jax.random.uniform(k_uv, dtype=jnp.float32) < 0.5))
        keys.setdefault(coins, k)
    return keys


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want):
    """tests/test_torch_flat.py::test_lra_matches_jax's bound: atol 3e-5 of
    the largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5 * np.abs(want).max())


def _chain(UV, d, v, h, step, coins, g=None):
    """The chain written out stage by stage and corner by corner, as the
    kernels run it."""
    gram, maxs = lra_upd.stage1_plain(UV, d, h, v)
    coef, scal = lra_upd.corner_a_plain(gram, maxs, step, coins)
    new_uv, nd, gram2 = lra_upd.stage3_plain(UV, d, h, v, coef, scal, g)
    mu_d, coef4 = lra_upd.corner_b_plain(linalg.max_abs(nd), step, gram2)
    new_d, pre = lra_upd.stage4_plain(new_uv, d, nd, mu_d, g, coef4)
    return new_uv, new_d, pre


@pytest.mark.parametrize("n,r", [(300, 3), (1021, 10), (257, 32)])
@pytest.mark.parametrize("coins", COINS, ids=str)
def test_corners_in_the_chain_match_jax(coin_keys, n, r, coins):
    key = jax.random.PRNGKey(n + r)
    st = jlra.init(key, n, rank=r, init_scale=0.8)
    st = jlra.pack(st.U * 3.0, st.V, st.d)  # imbalanced, so a rebalance moves it
    rng = np.random.default_rng(n + r)
    v, h, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    k = coin_keys[coins]
    want = jlra_upd.fused_update_apply(st.UV, st.d, v, h, g, 0.05, k, TINY, interpret=True)
    got = _chain(_t(st.UV), _t(st.d), _t(v), _t(h), 0.05, coins, _t(g))
    for a, b in zip(got, want, strict=True):
        _close(a, b)
    want_uv, want_d = jlra_upd.fused_update(st.UV, st.d, v, h, 0.05, k, TINY, interpret=True)
    uv, d, pre = _chain(_t(st.UV), _t(st.d), _t(v), _t(h), 0.05, coins)
    assert pre is None
    _close(uv, want_uv)
    _close(d, want_d)
    # the chain `fused_update_apply` runs on the CPU is this one, bit for bit
    for a, b in zip(lra_upd.fused_update_apply(_t(st.UV), _t(st.d), _t(v), _t(h), _t(g), 0.05,
                                               coins), got, strict=True):
        assert torch.equal(a, b)
    assert lra_upd._Plain.corner_a is lra_upd.corner_a_plain
    assert lra_upd._Plain.corner_b is lra_upd.corner_b_plain


def test_corner_b_saturates_and_skips_the_apply():
    mu, coef4 = lra_upd.corner_b_plain(torch.tensor(0.0), 0.05)
    assert coef4 is None and mu.item() == np.finfo(np.float32).max
    gram2 = torch.eye(6)
    mu, coef4 = lra_upd.corner_b_plain(torch.tensor(2.0), 0.5, gram2)
    assert mu.item() == pytest.approx(0.25) and coef4.shape == (2, 2)


# ------------------------------------------------- a system that must pivot

# I + G with a zero leading pivot: elimination without row exchanges
# divides by zero at the first step
IPG = np.array([[0.0, 1.0, 0.2], [1.0, 0.5, 0.0], [0.3, 0.0, 2.0]], dtype=np.float32)


def _lu_solve(a, b):
    """The corner kernel's routine (csrc/lra.cu `lra_lu_solve`) in numpy:
    at column j the pivot is the first row of largest |a[i, j]|, i >= j
    (LAPACK's getrf), then L y = P b and U x = y."""
    a, b = a.astype(np.float32).copy(), b.astype(np.float32).copy()
    r = len(b)
    for j in range(r):
        p = j + int(np.argmax(np.abs(a[j:, j])))
        a[[j, p]], b[[j, p]] = a[[p, j]], b[[p, j]]
        for k in range(j + 1, r):
            a[k, j] = a[k, j] / a[j, j]
            a[k, j + 1:] -= a[k, j] * a[j, j + 1:]
    for i in range(r):
        b[i + 1:] -= a[i + 1:, i] * b[i]
    for i in reversed(range(r)):
        b[i] = b[i] / a[i, i]
        b[:i] -= a[:i, i] * b[i]
    return b


def _pivot_state(n=64, seed=4):
    """U with orthonormal rows and V = (IPG - I) U, so that V U^T = IPG - I
    exactly in real arithmetic; x and w random."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((n, 3)))[0].T
    vv = (IPG.astype(np.float64) - np.eye(3)) @ u
    d = 0.5 + rng.random(n)
    uv = np.concatenate([u, vv]).astype(np.float32)
    v, h = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    return _t(uv), _t(d), _t(v), _t(h)


def test_lu_with_partial_pivoting_agrees_with_solve_small():
    b = np.array([1.0, -2.0, 0.5], dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = IPG.copy()
        assert a[0, 0] == 0.0 and not np.isfinite(a[1, 0] / a[0, 0])  # must pivot
    want = linalg.solve_small(_t(IPG), _t(b)).numpy()
    np.testing.assert_allclose(_lu_solve(IPG, b), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_lu_solve(IPG.T, b), linalg.solve_small(_t(IPG.T), _t(b)).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want, np.linalg.solve(IPG.astype(np.float64), b), rtol=1e-5)


@pytest.mark.parametrize("coins", COINS, ids=str)
def test_corner_a_pivots(coins):
    """The stage-1 Gram of a state whose I + V U^T needs row exchanges: the
    plain corner's solves agree with solve_small and with the kernel
    routine's numpy mirror, and its coefficients are finite."""
    uv, d, v, h = _pivot_state()
    gram, maxs = lra_upd.stage1_plain(uv, d, h, v)
    coef, scal = lra_upd.corner_a_plain(gram, maxs, 0.05, coins)
    assert torch.isfinite(coef).all() and torch.isfinite(scal).all()
    ipg = torch.eye(3) + gram[3:6, 0:3]
    assert ipg[0, 0].abs() < 1e-5  # the leading pivot vanishes
    cu, cv = scal
    a1 = linalg.solve_small(ipg.T, cu * gram[0:3, 7])
    torch.testing.assert_close(coef[:, 1], cv * a1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_lu_solve(ipg.T.numpy(), (cu * gram[0:3, 7]).numpy()),
                               a1.numpy(), rtol=1e-4, atol=1e-6)
