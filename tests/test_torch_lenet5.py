"""Port parity: LeNet5, its data and the exact Hvp of psgd_tf_tpu_torch
against the JAX package, on the CPU, with weights moved by `interop`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu import hvp as jhvp
from psgd_tf_tpu.data import mnist as jmnist
from psgd_tf_tpu.models import lenet5 as jlenet5
from psgd_tf_tpu_torch import hvp, interop
from psgd_tf_tpu_torch.data import mnist
from psgd_tf_tpu_torch.models import lenet5

torch.set_num_threads(1)


def _inputs(seed, batch=8):
    rng = np.random.default_rng(seed)
    w = [0.1 * rng.standard_normal(s).astype(np.float32) for s in jlenet5.LAYER_SHAPES]
    x = rng.uniform(0.0, 1.0, (batch, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, batch).astype(np.int32)
    v = [rng.standard_normal(s).astype(np.float32) for s in jlenet5.LAYER_SHAPES]
    return w, x, y, v


def _jx(arrays):
    return [jnp.asarray(a) for a in arrays]


def test_apply_loss_and_error_rate_match_jax():
    w, x, y, _ = _inputs(0)
    tw = interop.tensors(w, device="cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    np.testing.assert_allclose(
        lenet5.apply(tw, tx).numpy(), np.asarray(jlenet5.apply(_jx(w), jnp.asarray(x))),
        rtol=1e-5, atol=1e-6,
    )
    assert lenet5.loss(tw, tx, ty).item() == pytest.approx(
        float(jlenet5.loss(_jx(w), jnp.asarray(x), jnp.asarray(y))), rel=1e-6
    )
    assert lenet5.error_rate(tw, tx, ty).item() == pytest.approx(
        float(jlenet5.error_rate(_jx(w), jnp.asarray(x), jnp.asarray(y)))
    )
    model = lenet5.LeNet5(torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in model.weights] == jlenet5.LAYER_SHAPES
    assert model(tx).shape == (8, 10)


def test_maxpool_splits_ties_like_jax():
    """After the ReLU most 2x2 windows tie at 0: the derivative must split
    between ties level by level as JAX's two `jnp.max` do."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 0, 0, 0] = x[0, 0, 1, 0] = x[0, 1, 0, 0] = 1.0  # three-way tie
    gj = jax.grad(lambda a: jnp.sum(jlenet5._maxpool2(a)))(jnp.asarray(x))
    gt = torch.func.grad(lambda a: lenet5._maxpool2(a).sum())(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(gt.permute(0, 2, 3, 1).numpy(), np.asarray(gj), rtol=0, atol=0)


def test_grads_and_exact_hvp_match_jax():
    w, x, y, v = _inputs(1)
    jargs = (jnp.asarray(x), jnp.asarray(y))
    jl, jg, jh = jhvp.exact(jlenet5.loss, _jx(w), _jx(v), *jargs)
    targs = (torch.from_numpy(x), torch.from_numpy(y).long())
    tl, tg, th = hvp.exact(lenet5.loss, interop.tensors(w, device="cpu"),
                           interop.tensors(v, device="cpu"), *targs)
    assert tl.item() == pytest.approx(float(jl), rel=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    gl, gg = hvp.grad_only(lenet5.loss, interop.tensors(w, device="cpu"), *targs)
    assert gl.item() == tl.item()
    for a, b in zip(gg, tg):
        torch.testing.assert_close(a, b)


def test_finite_diff_hvp_matches_jax_and_returns_unperturbed_grad():
    w, x, y, v = _inputs(2)
    jl, jg, jh = jhvp.finite_diff(jlenet5.loss, _jx(w), _jx(v), jnp.asarray(x), jnp.asarray(y))
    targs = (torch.from_numpy(x), torch.from_numpy(y).long())
    tw, tv = interop.tensors(w, device="cpu"), interop.tensors(v, device="cpu")
    l_fd, g_fd, h_fd = hvp.finite_diff(lenet5.loss, tw, tv, *targs)
    l_ex, g_ex, _ = hvp.exact(lenet5.loss, tw, tv, *targs)
    assert l_fd.item() == pytest.approx(float(jl), rel=1e-6)
    assert l_fd.item() == pytest.approx(l_ex.item(), rel=1e-6)
    for a, b in zip(g_fd, g_ex):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    # (g(theta + delta v) - g(theta)) / delta divides the gradients' fp32
    # rounding by delta = sqrt(eps) ~ 3.5e-4: measured max |diff| 4.7e-4
    # against entries up to 41
    for a, b in zip(h_fd, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-3)


def test_random_like_draws_from_the_generator():
    w = interop.tensors(_inputs(3)[0], device="cpu")
    a = hvp.random_like(torch.Generator().manual_seed(5), w)
    b = hvp.random_like(torch.Generator().manual_seed(5), w)
    assert [p.shape for p in a] == [p.shape for p in w]
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_glyph_bank_equals_jax():
    np.testing.assert_array_equal(mnist._glyph_bank(), jmnist._glyph_bank())


@pytest.mark.parametrize("fn", [mnist.synthetic, mnist.synthetic_hard])
def test_synthetic_digits_shape_range_and_seed(fn):
    x, y = fn(torch.Generator().manual_seed(0), 16)
    assert x.shape == (16, 28, 28, 1) and x.dtype == torch.float32
    assert y.shape == (16,) and int(y.min()) >= 0 and int(y.max()) <= 9
    assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    x2, y2 = fn(torch.Generator().manual_seed(0), 16)
    assert torch.equal(x, x2) and torch.equal(y, y2)


def test_workload_runs_with_finite_loss():
    from psgd_tf_tpu_torch.workloads import mnist_lenet5

    out = mnist_lenet5.run(epochs=1, steps_per_epoch=3, device="cpu", eval_size=64)
    assert np.isfinite(out["loss"]) and out["steps"] == 3
    assert 0.0 <= out["best_test_error"] <= 1.0
