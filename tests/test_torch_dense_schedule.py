"""The dense family's update schedule (`csrc/dense.cu`, K11 and K12),
executed in torch by `dense_upd.update_apply_blocked_plain`: pass 1's
ticketed panel solve on K3-style inverted diagonal blocks, Q' g from pass
1's vectors, pass 2's reverse carries summed in their fixed order, at
several panel sizes. Held against the JAX package's K11 and K12 in
interpret mode (`dense_upd.fused_update(_apply)`, `dense_big.fused_update_apply`
with its block switch lowered, as `tests/test_pallas.py` runs it), against
a float64 oracle, and its ticket orders against their waits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import dense_big as jdense_big
from psgd_tf_tpu.ops.pallas import dense_upd as jdense_upd
from psgd_tf_tpu_torch.ops.hopper import dense_upd

torch.set_num_threads(1)
TINY = jlinalg.tiny(jnp.float32)
# tests/test_torch_flat.py's bounds for K12 against its interpret-mode kernel
RTOL_Q, ATOL_Q, RTOL_PRE, ATOL_PRE = 2e-5, 2e-6, 2e-4, 2e-5


def _case(n, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    q = (np.triu(scale * rng.standard_normal((n, n))) + 0.8 * np.eye(n)).astype(np.float32)
    v, h, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    return q, v, h, g


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _oracle(q, v, h, g, step):
    """float64: Q' = Q - s0 triu(a a^T - b b^T) Q with the (n, n) gradient
    formed, and P' g = Q'^T Q' g."""
    q, v, h, g = (torch.from_numpy(np.array(x, dtype=np.float64)) for x in (q, v, h, g))
    a = q @ h
    b = torch.linalg.solve_triangular(q.T, v[:, None], upper=False)[:, 0]
    grad = torch.triu(a[:, None] * a[None, :] - b[:, None] * b[None, :])
    s0 = min(step / (grad.abs().max().item() + float(TINY)), float(np.finfo(np.float32).max))
    new_q = q - s0 * grad @ q
    return new_q.numpy(), (new_q.T @ (new_q @ g)).numpy()


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 300, 400])
@pytest.mark.parametrize("panel", [8, 32, 128])
def test_schedule_matches_float64(n, panel):
    q, v, h, g = _case(n, n + panel)
    want_q, want_pre = _oracle(q, v, h, g, 0.1)
    got_q, got_pre = dense_upd.update_apply_blocked_plain(_t(q), _t(v), _t(h), _t(g), 0.1, panel)
    scale_q, scale_pre = np.abs(want_q).max(), np.abs(want_pre).max()
    assert np.abs(got_q.numpy() - want_q).max() <= 2e-6 * scale_q
    assert np.abs(got_pre.numpy() - want_pre).max() <= 2e-5 * scale_pre
    assert torch.count_nonzero(torch.tril(got_q, -1)).item() == 0
    only_q, none = dense_upd.update_apply_blocked_plain(_t(q), _t(v), _t(h), None, 0.1, panel)
    assert none is None and torch.equal(only_q, got_q)


@pytest.mark.parametrize("n", [127, 128, 129, 300, 400])
@pytest.mark.parametrize("panel", [32, 128])
def test_schedule_matches_k11_interpret(n, panel):
    """JAX's K11 (Q resident, Newton-inverted 128-blocks) in interpret mode."""
    q, v, h, g = _case(n, 2 * n + panel)
    want_q, want_pre = jdense_upd.fused_update_apply(q, v, h, g, 0.1, TINY, interpret=True)
    got_q, got_pre = dense_upd.update_apply_blocked_plain(_t(q), _t(v), _t(h), _t(g), 0.1, panel)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=RTOL_Q, atol=ATOL_Q)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), rtol=RTOL_PRE, atol=ATOL_PRE)
    want = jdense_upd.fused_update(q, v, h, 0.1, TINY, interpret=True)
    got, _ = dense_upd.update_apply_blocked_plain(_t(q), _t(v), _t(h), None, 0.1, panel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_Q, atol=ATOL_Q)


@pytest.mark.parametrize("panel", [32, 128])
def test_schedule_matches_k12_interpret(monkeypatch, panel):
    """JAX's K12 (row panels streamed, reversed carries) in interpret mode,
    its block switch lowered as tests/test_torch_flat.py does."""
    monkeypatch.setattr(jdense_big, "BLK_SWITCH_N", 256)
    n = 300
    q, v, h, g = _case(n, 7 + panel, 0.02)
    want_q, want_pre = jdense_big.fused_update_apply(q, v, h, g, 0.05, TINY, interpret=True)
    got_q, got_pre = dense_upd.update_apply_blocked_plain(_t(q), _t(v), _t(h), _t(g), 0.05, panel)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=RTOL_Q, atol=ATOL_Q)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), rtol=RTOL_PRE, atol=ATOL_PRE)


@pytest.mark.parametrize("n", [1, 129, 400])
def test_schedule_zero_probes_leave_q(n):
    """v = h = 0: the step scale saturates at the fp32 max, Q' is Q exactly
    and P' g is Q^T Q g."""
    q, _, _, g = _case(n, 3)
    z = torch.zeros(n)
    got_q, got_pre = dense_upd.update_apply_blocked_plain(_t(q), z, z, _t(g), 0.1, 32)
    assert torch.equal(got_q, torch.triu(_t(q)))
    want = _t(q).T @ (_t(q) @ _t(g))
    np.testing.assert_allclose(got_pre.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m", [(100, 128), (300, 384), (129, 160)])
def test_schedule_identity_extension_is_untouched(n, m):
    """Q padded with an identity block and zero probes (the TPU kernels'
    layout): the extension comes back exactly, the leading block as the
    unpadded update."""
    q, v, h, g = _case(n, 4)
    qp = np.eye(m, dtype=np.float32)
    qp[:n, :n] = q
    pad = lambda x: np.concatenate([x, np.zeros(m - n, np.float32)])
    got_q, got_pre = dense_upd.update_apply_blocked_plain(_t(qp), _t(pad(v)), _t(pad(h)),
                                                         _t(pad(g)), 0.1, 32)
    assert torch.equal(got_q[n:, n:], torch.eye(m - n))
    assert torch.count_nonzero(got_q[:n, n:]).item() == 0
    ref_q, ref_pre = dense_upd.update_apply_blocked_plain(_t(q), _t(v), _t(h), _t(g), 0.1, 32)
    np.testing.assert_allclose(got_q[:n, :n].numpy(), ref_q.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_pre[:n].numpy(), ref_pre.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.count_nonzero(got_pre[n:]).item() == 0


def _pass1_waits(nb: int, p: int, k: int) -> list[tuple[int, int]]:
    """The pass-1 items that item (p, k) waits on in `csrc/dense.cu`: D(p)
    for the running sum of the contributions to its columns (R(p - 2, 1),
    which holds block p) and D(p - 1)'s look-ahead; R(p, k) for D(p)'s b_p
    and for the running sums of its blocks p + 2k and p + 2k + 1 at panel
    p - 1 (the second block of R(p - 1, k), the first of R(p - 1, k + 1))."""
    if k == 0:
        return ([(p - 2, 1)] if p >= 2 else []) + ([(p - 1, 0)] if p else [])
    if p == 0:
        return [(0, 0)]
    return [(p, 0), (p - 1, k)] + ([(p - 1, k + 1)] if p + 2 * k + 1 < nb else [])


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 7, 12, 31, 128])
def test_tickets_wait_only_on_lower_tickets(nb):
    """Every pass-1 item and pass-2 block waits only on work of a lower
    ticket (a block that holds a ticket runs to its end, so the launch
    progresses without a cooperative launch), and each list covers its
    work once."""
    one = dense_upd.pass1_tickets(nb)
    at = {item: t for t, item in enumerate(one)}
    assert len(at) == len(one) == sum((nb - p + 1) // 2 for p in range(nb))
    covered = sorted(c for p, k in one for c in (p + 2 * k, p + 2 * k + 1) if c < nb)
    assert covered == sorted(c for p in range(nb) for c in range(p, nb))
    for t, (p, k) in enumerate(one):
        assert all(at[w] < t for w in _pass1_waits(nb, p, k))
    two = dense_upd.pass2_tickets(nb)
    at2 = {blk: t for t, blk in enumerate(two)}
    assert len(at2) == len(two) == nb * (nb + 1) // 2
    for t, (p, c) in enumerate(two):
        assert all(at2[q, c] < t for q in range(p + 1, min(c, p + dense_upd.DCHK) + 1))


@pytest.mark.parametrize("n", [5, 200])
def test_q_prime_g_from_pass_one(n):
    """Q' g = Q g - s0 (a * revcumsum(a * Qg) - b * revcumsum(b * Qg)),
    the identity that spares pass 2 a read of Q', in float64."""
    q, v, h, g = (_t(x, torch.float64) for x in _case(n, 9))
    a = q @ h
    b = torch.linalg.solve_triangular(q.T, v[:, None], upper=False)[:, 0]
    grad = torch.triu(a[:, None] * a[None, :] - b[:, None] * b[None, :])
    s0 = 0.1 / grad.abs().max()
    qg = q @ g
    rev = lambda x: torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))
    u = qg - s0 * (a * rev(a * qg) - b * rev(b * qg))
    np.testing.assert_allclose(u.numpy(), ((q - s0 * grad @ q) @ g).numpy(), rtol=1e-12, atol=1e-12)
