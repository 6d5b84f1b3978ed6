"""Port parity for the slice as a whole: PSGD steps of LeNet5 with
(dense, dense) Kronecker preconditioners and exact Hvp, psgd_tf_tpu_torch
against psgd_tf_tpu on the CPU, with the same probes injected into both."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psgd_tf_tpu.hvp as jhvp
from psgd_tf_tpu import PSGD as JPSGD
from psgd_tf_tpu.models import lenet5 as jlenet5
from psgd_tf_tpu_torch import PSGD, interop, kron
from psgd_tf_tpu_torch.models import lenet5
from psgd_tf_tpu_torch.optim.psgd import KronPrecond

torch.set_num_threads(1)

DD = ("dense", "dense")
N_PARAMS = sum(m * n for m, n in jlenet5.LAYER_SHAPES)  # 44,426
HYPER = dict(
    preconditioner="kron", kron_formats=[DD] * 5, lr_params=0.1,
    lr_preconditioner=0.1, grad_clip_max_norm=0.1 * math.sqrt(N_PARAMS),
)


def test_five_steps_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    batch = 8
    w = [0.1 * rng.standard_normal(s).astype(np.float32) for s in jlenet5.LAYER_SHAPES]
    steps = [
        (
            rng.uniform(0.0, 1.0, (batch, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, batch).astype(np.int32),
            [rng.standard_normal(s).astype(np.float32) for s in jlenet5.LAYER_SHAPES],
        )
        for _ in range(5)
    ]

    jopt = JPSGD(**HYPER)
    jparams = [jnp.asarray(a) for a in w]
    jstate = jopt.init(jparams, jax.random.PRNGKey(0))
    probe = []  # the JAX step draws its probes through hvp.random_like
    monkeypatch.setattr(jhvp, "random_like", lambda key, params: probe[0])

    def jstep(params, state, v, x, y):
        probe[:] = [v]
        return jopt.step(jlenet5.loss, params, state, jax.random.PRNGKey(1), x, y)

    jstep = jax.jit(jstep)
    opt = PSGD(**HYPER)
    params = interop.tensors(w, device="cpu")
    state = opt.init(params)
    for x, y, v in steps:
        jparams, jstate, jaux = jstep(jparams, jstate, [jnp.asarray(a) for a in v],
                                      jnp.asarray(x), jnp.asarray(y))
        params, state, aux = opt.step(
            lenet5.loss, params, state, None, torch.from_numpy(x),
            torch.from_numpy(y).long(), probes=interop.tensors(v, device="cpu"),
        )
        assert aux["loss"].item() == pytest.approx(float(jaux["loss"]), rel=5e-4)

    # ROADMAP's 20-step trajectory bound; 5 steps of fp32 rounding in two
    # frameworks (conv, solve and GEMM sums taken in other orders) stay
    # well inside it
    assert state.count == 5
    for a, b in zip(params, jparams, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)
    for st, jst in zip(state.precond, jstate.precond, strict=True):
        assert st.fmt == jst.fmt == DD
        np.testing.assert_allclose(st.ql.numpy(), np.asarray(jst.ql), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(st.qr.numpy(), np.asarray(jst.qr), rtol=5e-4, atol=5e-5)


FORMAT_PAIRS = [("dense", "dense"), ("norm", "dense"), ("dense", "norm"), ("dense", "scale"),
                ("scale", "dense"), ("norm", "scale"), ("scale", "norm")]


@pytest.mark.parametrize("fmt", FORMAT_PAIRS, ids="-".join)
def test_non_fp32_kron_states_route_plain(fmt):
    """Only fp32 Kronecker states go to a kernel, as in the JAX package:
    every pair reports 'plain' for bf16 on the card, a kernel for fp32."""
    for shape in [(26, 6), (2305, 1024), (64, 3_000_017)]:
        assert kron.route(fmt, shape, "cuda", torch.bfloat16) == "plain"
        assert kron.route(fmt, shape, "cuda", torch.float16) == "plain"
        assert kron.route(fmt, shape, "cuda") != "plain"
        assert kron.route(fmt, shape, "cpu", torch.float32) == "plain"


def test_bf16_kron_state_reduces_quadratic():
    """The counterpart of the JAX package's bf16 test for kron
    (`tests/test_optim.py`): the whole Q state stays bf16 (fp32 params and
    Hvp) and PSGD still cuts an ill-conditioned quadratic below 0.2x its
    first loss in 150 steps."""
    rng = np.random.default_rng(0)
    a_diag = torch.logspace(-1, 1, 12)
    params = interop.tensors([rng.standard_normal(6).astype(np.float32) for _ in range(2)],
                             device="cpu")

    def quad(p):
        x = torch.cat(p)
        return 0.5 * x @ (a_diag * x)

    loss0 = quad(params).item()
    opt = PSGD(preconditioner="kron", init_scale=0.1, lr_params=0.2, lr_preconditioner=0.1,
               dtype=torch.bfloat16)
    state = opt.init(params)
    g = torch.Generator().manual_seed(4)
    for _ in range(150):
        params, state, aux = opt.step(quad, params, state, g)
    for st in state.precond:
        assert st.fmt == DD and st.ql.dtype == st.qr.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in params)
    assert aux["loss"].item() < 0.2 * loss0


def test_coin_branch_and_set_hyper():
    g = torch.Generator().manual_seed(0)
    params = lenet5.init(g)
    x = torch.rand((4, 28, 28, 1), generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    opt = PSGD(**{**HYPER, "preconditioner_update_probability": 0.5})
    state = opt.init(params, seed=3)
    assert not state.always_update and state.coin.device.type == "cpu"
    updated = 0
    for _ in range(8):
        before = state.precond
        params, state, aux = opt.step(lenet5.loss, params, state, g, x, y)
        assert torch.isfinite(aux["loss"])
        updated += state.precond is not before
    assert 0 < updated < 8  # seed 3 draws both branches
    state = PSGD.set_hyper(state, lr_params=0.05, update_probability=0.25)
    assert state.hyper.lr_params == 0.05 and state.hyper.update_probability == 0.25

    always = PSGD(**HYPER).init(params)
    assert always.always_update and always.coin is None
    with pytest.raises(ValueError, match="always-update"):
        PSGD.set_hyper(always, update_probability=0.5)


def test_init_layout_and_unported_paths():
    params = lenet5.init(torch.Generator().manual_seed(0))
    state = PSGD(**HYPER).init(params)
    assert [(st.ql.shape[0], st.qr.shape[0]) for st in state.precond] == jlenet5.LAYER_SHAPES
    assert all(kron.route(st.fmt, (st.ql.shape[0], st.qr.shape[0]), "cpu") == "plain"
               for st in state.precond)
    # splu is ported: a rank-10 corner over LeNet5's 44,426 parameters
    st = PSGD(preconditioner="splu").init(params).precond
    assert st.Lt.shape == (10, N_PARAMS) and st.l3.shape == (N_PARAMS - 10,)
    # four (dense, dense) layers in one padded bucket are stacked (K4 on the
    # card), as in JAX; below kron_batch_min they stay a list
    same = [torch.zeros(100, 50) for _ in range(4)]
    pc = PSGD(preconditioner="kron", kron_formats=DD).init(same).precond
    assert isinstance(pc, KronPrecond)
    assert pc.batched_idx == ((0, 1, 2, 3),) and pc.single_idx == () and pc.singles == []
    (bst,) = pc.batches
    assert bst.ql.shape == (4, 128, 128) and bst.qr.shape == (4, 128, 128)
    assert bst.shapes == ((100, 50),) * 4
    assert len(PSGD(preconditioner="kron", kron_formats=DD, kron_batch_min=5)
               .init(same).precond) == 4
