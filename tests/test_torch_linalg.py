"""Port parity: psgd_tf_tpu_torch.ops.linalg and the plain triangular
inverse of K3 against the JAX package, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import tri as jtri
from psgd_tf_tpu_torch.ops import linalg
from psgd_tf_tpu_torch.ops.hopper import tri

torch.set_num_threads(1)


def _triu_factor(rng, n, noise=0.1):
    """Upper-triangular, diagonal in [0.5, 1.5], off-diagonal noise scaled
    by 1/sqrt(n) so the factor stays well conditioned at every side."""
    u = np.triu(noise / np.sqrt(n) * rng.standard_normal((n, n)), 1)
    return (u + np.diag(rng.uniform(0.5, 1.5, n))).astype(np.float32)


@pytest.mark.parametrize(
    "tdtype,jdtype",
    [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)],
)
def test_tiny_and_delta_scale_match_jax(tdtype, jdtype):
    assert linalg.tiny(tdtype) == jlinalg.tiny(jdtype)
    assert linalg.delta_scale(tdtype) == pytest.approx(jlinalg.delta_scale(jdtype), rel=1e-12)


def test_tiny_is_the_fp32_subnormal():
    assert linalg.tiny(torch.float32) == 2.0**-149
    assert linalg.tiny(torch.float32) < torch.finfo(torch.float32).tiny


@pytest.mark.parametrize("max_grad", [0.0, 1e-44, 3.5])
def test_step_scale_saturates_like_jax(max_grad):
    got = linalg.step_scale(0.1, torch.tensor(max_grad), torch.float32)
    ref = jlinalg.step_scale(0.1, jnp.asarray(max_grad, jnp.float32), jnp.float32)
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-7)
    # a zero gradient times the saturated scale is a zero update, not NaN
    assert (got * torch.zeros(())).item() == 0.0


def test_norm_clip_scale_and_max_abs_triu():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 7)).astype(np.float32)
    assert linalg.max_abs(torch.from_numpy(x)).item() == float(jlinalg.max_abs(jnp.asarray(x)))
    np.testing.assert_array_equal(linalg.triu(torch.from_numpy(x)).numpy(), np.asarray(jlinalg.triu(jnp.asarray(x))))
    for norm, cap in [(2.0, 1.0), (0.5, 1.0), (3.0, float("inf"))]:
        got = linalg.norm_clip_scale(torch.tensor(norm), cap).item()
        ref = float(jlinalg.norm_clip_scale(jnp.float32(norm), jnp.float32(cap)))
        assert got == pytest.approx(ref, rel=1e-7)


@pytest.mark.parametrize("n,nrhs", [(26, 6), (151, 16), (257, 120)])
def test_solve_ut_t_matches_jax(n, nrhs):
    rng = np.random.default_rng(n)
    u = _triu_factor(rng, n)
    b = rng.standard_normal((n, nrhs)).astype(np.float32)
    got = linalg.solve_ut_t(torch.from_numpy(u), torch.from_numpy(b)).numpy()
    ref = np.asarray(jlinalg.solve_ut_t(jnp.asarray(u), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_solve_ut_t_upcasts_half_states():
    rng = np.random.default_rng(0)
    u = torch.from_numpy(_triu_factor(rng, 40)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32)).to(torch.bfloat16)
    got = linalg.solve_ut_t(u, b)
    assert got.dtype == torch.bfloat16
    ref = torch.linalg.solve_triangular(u.float().T, b.float(), upper=False)
    torch.testing.assert_close(got.float(), ref.bfloat16().float())


# LeNet5's ten factor sides, and a side just past a 32-tile boundary
SIDES = [26, 6, 151, 16, 257, 120, 121, 84, 85, 10, 33]


def test_plain_triangular_inverse_matches_numpy():
    rng = np.random.default_rng(7)
    us = [_triu_factor(rng, n) for n in SIDES]
    got = tri.inverse_upper([torch.from_numpy(u) for u in us])
    for u, x in zip(us, got):
        ref = np.linalg.inv(u.astype(np.float64))
        np.testing.assert_allclose(x.numpy(), ref, rtol=1e-5, atol=1e-6)
        assert np.all(np.tril(x.numpy(), -1) == 0.0)


def test_plain_triangular_inverse_matches_newton_blocks():
    """K3 replaces the Pallas batched Newton inverse of 128x128 diagonal
    blocks: on a stack of such blocks both give the same inverse."""
    rng = np.random.default_rng(11)
    blocks = np.stack([_triu_factor(rng, 128) for _ in range(3)])
    ref = np.asarray(jtri._newton_inv_batched(jnp.asarray(blocks)))
    got = tri.inverse_upper([torch.from_numpy(b) for b in blocks])
    for x, r in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), r, rtol=1e-5, atol=1e-6)


def test_wrappers_take_the_plain_path_on_cpu_without_counting():
    from psgd_tf_tpu_torch.ops import hopper

    before = dict(hopper.counts)
    u = torch.eye(5) * 2.0
    assert torch.equal(tri.inverse_upper([u])[0], torch.eye(5) * 0.5)
    assert hopper.counts == before
    assert hopper.use_kernel(u) is False
    with pytest.raises(NotImplementedError):
        hopper.use_kernel("meta")
