"""K19's blocked schedule on the CPU: `tri.schedule` and its torch executor
`tri.solve_triangular_blocked_plain` (the kernels' index maps: each
diagonal block read as U = M or M^T, the forward leaves taking its inverse
transposed, the updates reading M's blocks through the transposed index)
against JAX `tri.solve_triangular` in interpret mode for n <= 768, and
against `torch.linalg.solve_triangular` up to n = 2048."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.ops.pallas import tri as jtri
from psgd_tf_tpu_torch.ops.hopper import tri

torch.set_num_threads(1)

ORIENTS = [(False, False), (False, True), (True, False), (True, True)]  # (lower, trans)


def _system(n, nrhs, lower, scale, seed):
    """An (n, n) triangular Q (unit diagonal plus `scale` noise above it)
    and B (n, nrhs), or a vector B when nrhs is 0."""
    rng = np.random.default_rng(seed)
    q = np.triu(np.eye(n) + scale * rng.standard_normal((n, n))).astype(np.float32)
    if lower:
        q = np.ascontiguousarray(q.T)
    b = rng.standard_normal((n, nrhs) if nrhs else (n,)).astype(np.float32)
    return q, b


def _close(got, ref):
    """Norm-relative, 1e-5 of max |ref|: a triangular solve amplifies fp32
    rounding with the system's condition number (the JAX suite's bound)."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("nb,subst_max", [(32, 0), (tri.NB, 0), (tri.NB, tri.SUBST_MAX_N)],
                         ids=["nb32", "blocked", "default"])
@pytest.mark.parametrize("n", [1, 31, 33, 129, 700])
@pytest.mark.parametrize("nrhs", [0, 512])
@pytest.mark.parametrize("lower,trans", ORIENTS, ids=str)
def test_blocked_schedule_matches_jax(n, nrhs, lower, trans, nb, subst_max):
    q, b = _system(n, nrhs, lower, 0.1, n + nrhs)
    ref = jtri.solve_triangular(jnp.asarray(q), jnp.asarray(b), lower=lower, trans=trans,
                                interpret=True)
    got = tri.solve_triangular_blocked_plain(torch.from_numpy(q), torch.from_numpy(b),
                                             lower=lower, trans=trans, nb=nb,
                                             subst_max=subst_max)
    _close(got, ref)


@pytest.mark.parametrize("n,nrhs", [(1024, 1), (1024, 512), (2048, 1), (2048, 512)])
@pytest.mark.parametrize("lower,trans", ORIENTS, ids=str)
def test_blocked_schedule_matches_torch_past_the_jax_cap(n, nrhs, lower, trans):
    """Past JAX's n <= 768 cap, against `torch.linalg.solve_triangular` of
    the same system (a factor scaled as the walked Kronecker factors are)."""
    q, b = _system(n, nrhs, lower, 0.1 / np.sqrt(n), n + nrhs)
    qt, bt = torch.from_numpy(q), torch.from_numpy(b)
    ref = torch.linalg.solve_triangular(qt.T if trans else qt, bt, upper=lower == trans)
    got = tri.solve_triangular_blocked_plain(qt, bt, lower=lower, trans=trans)
    _close(got, ref)


def test_schedule_records():
    """At n = 2048, NB = 256: one INV, then 8 leaves in substitution order,
    each followed by one update of every row still unsolved (7); rows come
    from B until the first update has written C; a small system is one
    SUBST record; a backward system mirrors, a ragged one ends short."""
    ops = tri.schedule(2048, lower=False, trans=True, nb=256, subst_max=384)  # forward
    assert ops[0] == (tri.OP_INV, 0, 2048, 0, 0, 0)
    assert ops[1:4] == [(tri.OP_LEAF, 0, 256, 0, 0, 0), (tri.OP_UPDATE, 256, 1792, 0, 256, 0),
                        (tri.OP_LEAF, 256, 256, 0, 0, 1)]
    assert [op[0] for op in ops[1:]] == [tri.OP_LEAF, tri.OP_UPDATE] * 7 + [tri.OP_LEAF]
    assert ops[-1] == (tri.OP_LEAF, 1792, 256, 0, 0, 1)
    back = tri.schedule(2048, lower=False, trans=False, nb=256, subst_max=384)
    assert back[1:3] == [(tri.OP_LEAF, 1792, 256, 0, 0, 0), (tri.OP_UPDATE, 0, 1792, 1792, 256, 0)]
    assert back[-1] == (tri.OP_LEAF, 0, 256, 0, 0, 1)
    for kind, r0, rows, k0, k, _ in ops + back:
        if kind == tri.OP_UPDATE:
            assert k0 + k <= r0 or r0 + rows <= k0  # off the diagonal blocks
    assert tri.schedule(200, lower=True, trans=False) == [(tri.OP_SUBST, 0, 200, 0, 0, 0)]
    assert tri.schedule(257, lower=True, trans=False, nb=128, subst_max=256)[-1] == (
        tri.OP_LEAF, 256, 1, 0, 0, 1)
    assert tri.schedule(257, lower=False, trans=False, nb=128, subst_max=256)[1:3] == [
        (tri.OP_LEAF, 256, 1, 0, 0, 0), (tri.OP_UPDATE, 0, 256, 256, 1, 0)]


@pytest.mark.parametrize("lower,trans", ORIENTS, ids=str)
def test_blocked_executor_reads_only_the_named_triangle(lower, trans):
    """NaN in the triangle `lower` does not name changes nothing."""
    q, b = _system(300, 7, lower, 0.1, 3)
    qt = torch.from_numpy(q)
    dirty = qt.clone()
    other = torch.tril(torch.ones_like(qt, dtype=torch.bool), -1)
    dirty[other.T if lower else other] = float("nan")
    want = tri.solve_triangular_blocked_plain(qt, torch.from_numpy(b), lower=lower, trans=trans,
                                              nb=64, subst_max=0)
    got = tri.solve_triangular_blocked_plain(dirty, torch.from_numpy(b), lower=lower, trans=trans,
                                             nb=64, subst_max=0)
    assert torch.equal(got, want)
