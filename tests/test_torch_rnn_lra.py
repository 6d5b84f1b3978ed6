"""Port parity for the slice as a whole: the delayed-XOR RNN, its data, PSGD
with the dense, diag and lra families, the UVd class and the two workloads
(hello_psgd, rnn_xor_lra), psgd_tf_tpu_torch against psgd_tf_tpu on the
CPU with the same weights, batches, probes and coins."""
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
from psgd_tf_tpu.models import rnn as jrnn
from psgd_tf_tpu_torch import PSGD, UVd, hvp, interop
from psgd_tf_tpu_torch.data import xor
from psgd_tf_tpu_torch.models import rnn, rosenbrock
from psgd_tf_tpu_torch.workloads import hello_psgd, mnist_lenet5, nmt_attention, rnn_xor_lra

torch.set_num_threads(1)
HIDDEN, T, BATCH = 6, 8, 8
EPS = float(np.finfo(np.float32).eps)


def _jax_case(seed=0):
    jparams = jrnn.init(jax.random.PRNGKey(seed), hidden=HIDDEN)
    x, y = jxor.batch(jax.random.PRNGKey(seed + 1), BATCH, T)
    return jparams, np.asarray(x), np.asarray(y)


def _np(xs):
    return [np.asarray(a) for a in xs]


# ------------------------------------------------------------------ the model

def test_rnn_loss_grad_and_hvps_match_jax():
    jparams, x, y = _jax_case()
    rng = np.random.default_rng(0)
    v = [rng.standard_normal(p.shape).astype(np.float32) for p in jparams]
    params, vt = interop.tensors(_np(jparams), device="cpu"), interop.tensors(v, device="cpu")
    X, Y = interop.tensors([x, y], device="cpu")
    assert rnn.loss(params, X, Y).item() == pytest.approx(float(jrnn.loss(jparams, x, y)), rel=1e-6)

    jl, jg, jh = jhvp.exact(jrnn.loss, jparams, v, x, y)
    loss, g, h = hvp.exact(rnn.loss, params, vt, X, Y)
    assert loss.item() == pytest.approx(float(jl), rel=1e-6)
    for a, b in zip(g, jg, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    for a, b in zip(h, jh, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)

    # FD: the two frameworks' gradients agree to a few ulps of max|g|
    # (measured 2.5); h = (g(theta + delta v) - g(theta)) / delta divides
    # that difference by delta = sqrt(eps), so allow 8 ulps over delta
    _, jg, jh = jhvp.finite_diff(jrnn.loss, jparams, v, x, y)
    _, g, h = hvp.finite_diff(rnn.loss, params, vt, X, Y)
    gmax = max(float(np.abs(np.asarray(b)).max()) for b in jg)
    atol = 8 * EPS * gmax / np.sqrt(EPS)
    for a, b in zip(h, jh, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_rnn_init_layout():
    w_rnn, w_fc = rnn.init(torch.Generator().manual_seed(0), hidden=30)
    assert w_rnn.shape == (33, 30) and w_fc.shape == (31, 1)
    assert sum(p.numel() for p in (w_rnn, w_fc)) == 1021
    w_rec = w_rnn[2:32]
    torch.testing.assert_close(w_rec.T @ w_rec, torch.eye(30), rtol=0, atol=1e-5)
    assert torch.equal(w_rnn[-1], torch.zeros(30)) and w_fc[-1].item() == 0.0
    lim = (6.0 / 32) ** 0.5 / 3.0
    assert w_rnn[:2].abs().max().item() <= lim and w_fc[:-1].abs().max().item() <= (6.0 / 31) ** 0.5 / 3


@pytest.mark.parametrize("seq_len", [8, 100])
def test_xor_batch_structure(seq_len):
    x, y = xor.batch(torch.Generator().manual_seed(seq_len), 64, seq_len)
    assert x.shape == (64, seq_len, 2) and y.shape == (64, 1)
    bits, marks = x[..., 0], x[..., 1]
    assert set(bits.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(marks.sum(1), torch.full((64,), 2.0))
    for row in range(64):
        pos = torch.nonzero(marks[row]).flatten().tolist()
        if len(pos) == 1:  # both markers on one position: only when T/10 == 0
            assert seq_len < 10 and marks[row, pos[0]].item() == 2.0
            i = j = pos[0]
        else:
            i, j = pos
        assert 0 <= i < max(seq_len // 10, 1) and seq_len // 10 <= j < seq_len // 2
        want = -1.0 if bits[row, i] == bits[row, j] else 1.0
        assert y[row, 0].item() == want
    logits = torch.linspace(-100.0, 100.0, 64)[:, None]
    assert torch.isfinite(xor.logistic_loss(logits, y))
    np.testing.assert_allclose(xor.logistic_loss(logits, y).item(),
                               float(jxor.logistic_loss(logits.numpy(), y.numpy())), rtol=1e-6)


# ------------------------------------------------------------------ PSGD trajectories

@pytest.mark.parametrize("fam", ["dense", "diag", "lra"])
def test_five_steps_match_jax(fam):
    """Five PSGD steps on the RNN with each flat family, the probe and the
    lra coins recovered from the JAX step's key and injected into the
    port. Bounds: ROADMAP's 5e-4 / 5e-5, 2e-3 for lra."""
    jparams, _, _ = _jax_case(1)
    hyper = dict(preconditioner=fam, rank=3, lr_params=0.05, lr_preconditioner=0.05,
                 grad_clip_max_norm=1.0)
    jopt = JPSGD(**hyper)
    jstate = jopt.init(jparams, jax.random.PRNGKey(5))
    jstep = jax.jit(partial(jopt.step, jrnn.loss))
    opt = PSGD(**hyper)
    params = interop.tensors(_np(jparams), device="cpu")
    state = opt.init(params)
    if fam == "lra":
        state = state.replace(precond=interop.lra_state(np.asarray(jstate.precond.UV),
                                                        np.asarray(jstate.precond.d), device="cpu"))
    shapes = [p.shape for p in params]
    n = sum(p.numel() for p in params)
    for k in range(5):
        x, y = _np(jxor.batch(jax.random.PRNGKey(100 + k), BATCH, T))
        key = jax.random.PRNGKey(1000 + k)
        _, k_probe, k_prec = jax.random.split(key, 3)
        v = np.asarray(jax.random.normal(k_probe, (n,), jnp.float32))
        k_bal, k_uv = jax.random.split(k_prec)
        coins = (bool(jax.random.uniform(k_bal) < 0.01), bool(jax.random.uniform(k_uv) < 0.5))
        parts = torch.split(torch.from_numpy(v.copy()), [s.numel() for s in shapes])
        probes = [t.reshape(s) for t, s in zip(parts, shapes)]
        jparams, jstate, jaux = jstep(jparams, jstate, key, x, y)
        params, state, aux = opt.step(rnn.loss, params, state, None,
                                      *interop.tensors([x, y], device="cpu"),
                                      probes=probes, coins=coins)
        assert aux["loss"].item() == pytest.approx(float(jaux["loss"]), rel=5e-4)
    tol = dict(rtol=2e-3, atol=2e-3) if fam == "lra" else dict(rtol=5e-4, atol=5e-5)
    for a, b in zip(params, jparams, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    if fam == "lra":
        pairs = [(state.precond.UV, jstate.precond.UV), (state.precond.d, jstate.precond.d)]
    elif fam == "dense":
        pairs = [(state.precond.Q, jstate.precond.Q)]
    else:
        pairs = [(state.precond.q, jstate.precond.q)]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


# ------------------------------------------------------------------ the UVd class

def _uvd(**kw):
    g = torch.Generator().manual_seed(0)
    params = rnn.init(g, hidden=4)
    return UVd(params, rank_of_modification=2, grad_clip_max_norm=1.0, generator=g, **kw), g


def test_uvd_returns_the_closure_value_at_the_pre_step_params():
    opt, g = _uvd()
    x, y = xor.batch(g, 8, 8)
    before = opt.params
    want = rnn.loss(before, x, y)
    got = opt.step(rnn.loss, x, y)
    assert got.item() == pytest.approx(want.item(), rel=1e-6)
    assert opt.params is not before and opt.state.count == 1

    def closure(p, x, y):
        logits = rnn.apply(p, x)
        return xor.logistic_loss(logits, y), logits

    before = opt.params
    loss, logits = opt.step(closure, x, y)
    assert loss.item() == pytest.approx(rnn.loss(before, x, y).item(), rel=1e-6)
    torch.testing.assert_close(logits, rnn.apply(before, x))
    assert opt.last_aux["loss"].item() == pytest.approx(loss.item(), rel=1e-6)


def test_uvd_hyperparameters_and_switches(monkeypatch):
    from psgd_tf_tpu_torch import hvp as port_hvp

    opt, g = _uvd()
    x, y = xor.batch(g, 8, 8)
    opt.lr_params = 0.005
    opt.lr_preconditioner = 0.02
    opt.grad_clip_max_norm = None
    assert (opt.lr_params, opt.lr_preconditioner, opt.grad_clip_max_norm) == (0.005, 0.02, np.inf)

    calls = []
    fd = port_hvp.finite_diff
    monkeypatch.setattr(port_hvp, "finite_diff", lambda *a, **k: calls.append(1) or fd(*a, **k))
    opt.step(rnn.loss, x, y)
    assert not calls
    opt.exact_hessian_vector_product = False
    assert not opt.exact_hessian_vector_product
    assert np.isfinite(opt.step(rnn.loss, x, y).item()) and calls == [1]

    # always-update -> the coin: the state gains a coin generator
    assert opt.state.always_update and opt.state.coin is None
    opt.preconditioner_update_probability = 1.0  # still always-update: nothing changes
    assert opt.state.always_update
    opt.preconditioner_update_probability = 0.5
    assert not opt.state.always_update and opt.state.coin is not None
    assert opt.preconditioner_update_probability == 0.5
    uv = opt.state.precond.UV
    updated = 0
    for _ in range(8):
        opt.step(rnn.loss, x, y)
        updated += opt.state.precond.UV is not uv
        uv = opt.state.precond.UV
    assert 0 < updated < 8

    always = PSGD(preconditioner="lra").init(opt.params)
    with pytest.raises(ValueError, match="always-update"):
        PSGD.set_hyper(always, update_probability=0.5)


# ------------------------------------------------------------------ the workloads

def test_hello_psgd_reaches_its_bar():
    out = hello_psgd.run(device="cpu", steps=500)
    assert out["steps"] == 500 and out["success"] and out["loss"] < 1e-4
    assert rosenbrock.loss(rosenbrock.init(device="cpu")).item() == pytest.approx(4.0)


def test_rnn_xor_lra_smoke():
    out = rnn_xor_lra.run(device="cpu", max_iters=4, seq_len=8, batch_size=8, hidden=4, rank=2,
                          switch_to_fd_at=2, check_every=2)
    assert out["steps"] == 4 and np.isfinite(out["loss"]) and out["success"] is False


@pytest.mark.parametrize("module", [hello_psgd, rnn_xor_lra, mnist_lenet5, nmt_attention],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_workloads_run_on_the_card_by_default(module):
    assert inspect.signature(module.run).parameters["device"].default == "cuda"
    assert "is_available" not in inspect.getsource(module)
