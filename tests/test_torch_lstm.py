"""Port parity for the delayed-XOR LSTM slice: the model, PSGD steps with
its two (dense, dense) Kronecker factors (K1 with two layers on the card)
and the `lstm_xor` workload, psgd_tf_tpu_torch against psgd_tf_tpu on the
CPU with the same weights, batches and probes."""
import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psgd_tf_tpu.hvp as jhvp
from psgd_tf_tpu import PSGD as JPSGD
from psgd_tf_tpu.data import xor as jxor
from psgd_tf_tpu.models import lstm as jlstm
from psgd_tf_tpu_torch import PSGD, hvp, interop
from psgd_tf_tpu_torch.models import lstm
from psgd_tf_tpu_torch.workloads import lstm_xor

torch.set_num_threads(1)
HIDDEN, T, BATCH = 8, 12, 8
DD = ("dense", "dense")


def _case(seed):
    jparams = jlstm.init(jax.random.PRNGKey(seed), dim_hidden=HIDDEN)
    x, y = jxor.batch(jax.random.PRNGKey(seed + 1), BATCH, T)
    return [np.asarray(p) for p in jparams], np.asarray(x), np.asarray(y)


def test_layer_shapes_and_init_match_jax():
    assert lstm.layer_shapes() == jlstm.layer_shapes() == [(63, 120), (31, 1)]
    assert lstm.layer_shapes(3, 5, 2) == jlstm.layer_shapes(3, 5, 2)
    params = lstm.init(torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in params] == [(63, 120), (31, 1)]
    assert all(p.dtype == torch.float32 for p in params)
    assert 0.09 < params[0].std().item() < 0.11  # 0.1 N(0, 1) over 7,560 entries


def test_apply_loss_and_hvp_match_jax():
    w, x, y = _case(0)
    params = interop.tensors(w, device="cpu")
    X, Y = interop.tensors([x, y], device="cpu")
    # T chained cell steps whose fp32 sums run in another order
    np.testing.assert_allclose(lstm.apply(params, X).numpy(),
                               np.asarray(jlstm.apply([jnp.asarray(a) for a in w], x)),
                               rtol=1e-5, atol=1e-6)
    assert lstm.loss(params, X, Y).item() == pytest.approx(
        float(jlstm.loss([jnp.asarray(a) for a in w], x, y)), rel=1e-5)
    v = [np.random.default_rng(1).standard_normal(a.shape).astype(np.float32) for a in w]
    jl, jg, jh = jhvp.exact(jlstm.loss, [jnp.asarray(a) for a in w], [jnp.asarray(a) for a in v],
                            x, y)
    tl, tg, th = hvp.exact(lstm.loss, params, interop.tensors(v, device="cpu"), X, Y)
    assert tl.item() == pytest.approx(float(jl), rel=1e-5)
    for a, b in zip(tg, jg, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    for a, b in zip(th, jh, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_twenty_psgd_steps_match_jax(monkeypatch):
    """Twenty PSGD steps with the workload's recipe ((dense, dense) x 2, lr
    0.02, preconditioner step 0.01, clip 1.0, exact Hvp), the same batches
    and probes injected into both packages."""
    w, _, _ = _case(2)
    rng = np.random.default_rng(3)
    steps = []
    for k in range(20):
        x, y = jxor.batch(jax.random.PRNGKey(100 + k), BATCH, T)
        steps.append((np.asarray(x), np.asarray(y),
                      [rng.standard_normal(a.shape).astype(np.float32) for a in w]))
    hyper = dict(preconditioner="kron", kron_formats=[DD] * 2, lr_params=0.02,
                 lr_preconditioner=0.01, grad_clip_max_norm=1.0)
    jopt = JPSGD(**hyper)
    jparams = [jnp.asarray(a) for a in w]
    jstate = jopt.init(jparams, jax.random.PRNGKey(0))
    probe = []
    monkeypatch.setattr(jhvp, "random_like", lambda key, params: probe[0])

    def jstep(params, state, v, x, y):
        probe[:] = [v]
        return jopt.step(jlstm.loss, params, state, jax.random.PRNGKey(1), x, y)

    jstep = jax.jit(jstep)
    opt = PSGD(**hyper)
    params = interop.tensors(w, device="cpu")
    state = opt.init(params)
    assert isinstance(state.precond, list) and isinstance(jstate.precond, list)  # a bucket of 2
    for x, y, v in steps:
        jparams, jstate, jaux = jstep(jparams, jstate, [jnp.asarray(a) for a in v], x, y)
        params, state, aux = opt.step(lstm.loss, params, state, None,
                                      *interop.tensors([x, y], device="cpu"),
                                      probes=interop.tensors(v, device="cpu"))
        assert aux["loss"].item() == pytest.approx(float(jaux["loss"]), rel=5e-4)
    # ROADMAP's trajectory bound
    for a, b in zip(params, jparams, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)
    for st, jst in zip(state.precond, jstate.precond, strict=True):
        assert st.fmt == tuple(jst.fmt) == DD
        np.testing.assert_allclose(st.ql.numpy(), np.asarray(jst.ql), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(st.qr.numpy(), np.asarray(jst.qr), rtol=5e-4, atol=5e-5)


def test_lstm_xor_smoke():
    out = lstm_xor.run(max_iters=4, seq_len=8, batch_size=8, hidden=4, check_every=2,
                       device="cpu")
    assert out["steps"] == 4 and np.isfinite(out["loss"]) and out["success"] is False


def test_lstm_xor_hyperparameters_match_jax():
    from psgd_tf_tpu.workloads import lstm_xor as jlstm_xor

    got, want = inspect.signature(lstm_xor.run).parameters, inspect.signature(
        jlstm_xor.run).parameters
    assert {k: p.default for k, p in got.items() if k != "device"} == {
        k: p.default for k, p in want.items()}
    assert got["device"].default == "cuda"
    assert "is_available" not in inspect.getsource(lstm_xor)


def test_lstm_xor_loss_falls_on_cpu():
    """300 steps at a short length: the loss falls (not the bar: that takes
    thousands of steps at length 100)."""
    run = partial(lstm_xor.run, seq_len=10, batch_size=32, hidden=8, device="cpu")
    first = run(max_iters=3, check_every=3)["loss"]
    later = run(max_iters=300, check_every=300)["loss"]
    assert np.isfinite(first) and later < first
