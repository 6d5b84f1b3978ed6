"""Port parity for the slice as a whole: the tensor-decomposition model and
PSGD with each of the seven families on it, psgd_tf_tpu_torch against
psgd_tf_tpu on the CPU with the same target, factors, probes and coins;
and the all-preconditioners workload against its bar."""
import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psgd_tf_tpu.hvp as jhvp
from psgd_tf_tpu import PSGD as JPSGD
from psgd_tf_tpu.models import tensor_decomp as jtd
from psgd_tf_tpu_torch import PSGD, interop
from psgd_tf_tpu_torch.models import tensor_decomp
from psgd_tf_tpu_torch.workloads import all_preconditioners

torch.set_num_threads(1)
FAMILIES = all_preconditioners.FAMILIES


def _case(seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.0, 1.0, (10, 20, 50)).astype(np.float32)
    factors = [rng.standard_normal((5, d)).astype(np.float32) for d in (10, 20, 50)]
    return target, factors


def test_loss_matches_jax():
    target, factors = _case()
    jparams = dict(zip("xyz", (jnp.asarray(f) for f in factors)))
    want = float(jtd.loss(jparams, jnp.asarray(target)))
    got = tensor_decomp.loss(interop.tensors(factors, device="cpu"),
                             torch.from_numpy(target)).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_model_init_layout():
    g = torch.Generator().manual_seed(0)
    target = tensor_decomp.make_target(g)
    params = tensor_decomp.init(g)
    assert target.shape == (10, 20, 50) and 0.0 <= target.min() and target.max() < 1.0
    assert [tuple(p.shape) for p in params] == [(5, 10), (5, 20), (5, 50)]
    assert sum(p.numel() for p in params) == 400


@pytest.mark.parametrize("fam", FAMILIES)
def test_twenty_steps_match_jax(fam):
    """20 PSGD steps of the workload's recipe (init scale 0.1, both lrs 0.1,
    rank 10), the probes recovered from each JAX step's key (and lra's
    coins) and injected into the port. ROADMAP's bounds: 5e-4, 2e-3 for lra."""
    _twenty_steps(fam, 10)


@pytest.mark.parametrize("fam", ["lra", "splu"])
def test_twenty_steps_match_jax_past_rank_32(fam):
    """The same recipe at rank 40, past the rank-32 kernels: on the card
    these states take the lra and splu chains' rank-generic kernels."""
    _twenty_steps(fam, 40)


def _twenty_steps(fam, rank):
    target, factors = _case(1)
    hyper = dict(preconditioner=fam, rank=rank, init_scale=0.1, lr_params=0.1,
                 lr_preconditioner=0.1)
    jopt = JPSGD(**hyper)
    jparams = dict(zip("xyz", (jnp.asarray(f) for f in factors)))
    jstate = jopt.init(jparams, jax.random.PRNGKey(3))
    jstep = jax.jit(partial(jopt.step, jtd.loss))
    opt = PSGD(**hyper)
    params = interop.tensors(factors, device="cpu")
    state = opt.init(params)
    if fam == "lra":
        state = state.replace(precond=interop.lra_state(np.asarray(jstate.precond.UV),
                                                        np.asarray(jstate.precond.d), device="cpu"))
    jt, t = jnp.asarray(target), torch.from_numpy(target)
    shapes = [p.shape for p in params]
    for k in range(20):
        key = jax.random.PRNGKey(100 + k)
        _, k_probe, k_prec = jax.random.split(key, 3)
        if fam == "kron":
            probes = interop.tensors([np.asarray(x) for x in
                                      jax.tree_util.tree_leaves(jhvp.random_like(k_probe, jparams))],
                                     device="cpu")
        else:
            v = np.asarray(jax.random.normal(k_probe, (400,), jnp.float32))
            parts = torch.split(torch.from_numpy(v.copy()), [s.numel() for s in shapes])
            probes = [x.reshape(s) for x, s in zip(parts, shapes)]
        k_bal, k_uv = jax.random.split(k_prec)
        coins = (bool(jax.random.uniform(k_bal) < 0.01), bool(jax.random.uniform(k_uv) < 0.5))
        jparams, jstate, jaux = jstep(jparams, jstate, key, jt)
        params, state, aux = opt.step(tensor_decomp.loss, params, state, None, t, probes=probes,
                                      coins=coins if fam == "lra" else None)
        assert aux["loss"].item() == pytest.approx(float(jaux["loss"]), rel=5e-4)
    tol = dict(rtol=2e-3, atol=2e-3) if fam == "lra" else dict(rtol=5e-4, atol=5e-5)
    for a, b in zip(params, jax.tree_util.tree_leaves(jparams), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("fam", FAMILIES)
def test_all_preconditioners_meets_its_bar(fam):
    out = all_preconditioners.run(fam, device="cpu")
    assert out["steps"] == 100 and out["success"], out
    assert out["loss"] < 0.1 * out["first_loss"]


def test_workload_runs_on_the_card_by_default():
    for fn in (all_preconditioners.run, all_preconditioners.run_all):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "is_available" not in inspect.getsource(all_preconditioners)
