"""Port parity for the triangular solves and the involution-subgroup
families (xmat, shift), psgd_tf_tpu_torch on the CPU against psgd_tf_tpu on
the same numpy inputs; the centre invariants; the CUDA defaults of the
public inits."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import shift as jshift
from psgd_tf_tpu.groups import xmat as jxmat
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu_torch import interop
from psgd_tf_tpu_torch.groups import dense, diag, kron, lra, shift, splu, xmat
from psgd_tf_tpu_torch.models import rosenbrock, tensor_decomp
from psgd_tf_tpu_torch.ops import linalg

torch.set_num_threads(1)
FAMS = {"xmat": (xmat, jxmat), "shift": (shift, jshift)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _vecs(n, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("name", ["solve_ut", "solve_ut_t", "solve_lt", "solve_lt_t"])
@pytest.mark.parametrize("cols", [0, 3])
def test_triangular_solves_match_jax(name, cols):
    rng = np.random.default_rng(1)
    m = rng.standard_normal((12, 12)).astype(np.float32) * 0.1 + 2.0 * np.eye(12, dtype=np.float32)
    a = np.triu(m) if "_ut" in name else np.tril(m)
    b = rng.standard_normal((12, cols) if cols else (12,)).astype(np.float32)
    got = getattr(linalg, name)(_t(a), _t(b))
    want = getattr(jlinalg, name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # half precision upcasts to fp32 for the solve and casts back
    half = getattr(linalg, name)(_t(a).bfloat16(), _t(b).bfloat16())
    assert half.dtype == torch.bfloat16


def _walked(jfam, n, seed):
    """A JAX state walked three updates off 0.8 I, and fresh probes."""
    st = jfam.init(n, 0.8)
    vecs = _vecs(n, 9, seed)
    for k in range(3):
        st = jfam.update(st, jnp.asarray(vecs[2 * k]), jnp.asarray(vecs[2 * k + 1]), step=0.1)
    return st, vecs[6:]


def _port(fam, jst):
    make = interop.xmat_state if fam is xmat else interop.shift_state
    return make(np.asarray(jst.af), np.asarray(jst.bf), np.asarray(jst.ac), jst.odd,
                device="cpu")


@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("name", list(FAMS))
def test_matches_jax(name, n):
    fam, jfam = FAMS[name]
    jst, (v, h, x) = _walked(jfam, n, n)
    st = _port(fam, jst)
    assert st.n == jst.n == n and st.odd == jst.odd
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.a.numpy(), np.asarray(jst.a), **tol)
    np.testing.assert_allclose(st.b.numpy(), np.asarray(jst.b), **tol)
    np.testing.assert_allclose(fam.matvec(st, _t(x)).numpy(), np.asarray(jfam.matvec(jst, x)), **tol)
    np.testing.assert_allclose(fam.apply(st, _t(x)).numpy(), np.asarray(jfam.apply(jst, x)), **tol)
    np.testing.assert_allclose(fam.materialize(st).numpy(), np.asarray(jfam.materialize(jst)),
                               rtol=1e-5, atol=1e-5)
    got = fam.update(st, _t(v), _t(h), 0.1)
    want = jfam.update(jst, jnp.asarray(v), jnp.asarray(h), step=0.1)
    for a, b in [(got.af, want.af), (got.bf, want.bf), (got.ac, want.ac)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("name", list(FAMS))
def test_init_matches_jax(name, n):
    fam, jfam = FAMS[name]
    st, jst = fam.init(n, 0.7, device="cpu"), jfam.init(n, 0.7)
    assert st.af.shape == jst.af.shape == (2, n // 2) and st.odd == jst.odd
    np.testing.assert_array_equal(st.a.numpy(), np.asarray(jst.a))
    np.testing.assert_array_equal(st.b.numpy(), np.asarray(jst.b))


@pytest.mark.parametrize("name", list(FAMS))
def test_centre_stays_zero_odd_n(name):
    """The σ-fixed centre's off-diagonal entry stays exactly 0: the middle
    index for xmat, the LAST index for shift."""
    fam, _ = FAMS[name]
    n = 65
    st = fam.init(n, device="cpu")
    for k in range(5):
        v, h = _vecs(n, 2, 50 + k)
        st = fam.update(st, _t(v), _t(h), 0.1)
    centre = n // 2 if fam is xmat else n - 1
    assert st.b[centre].item() == 0.0
    assert torch.count_nonzero(st.b).item() == n - 1


def test_xmat_inverse_transpose_identity():
    """The pair solve: Q^T (Q^{-T} v) == v."""
    n = 64
    st = xmat.update(xmat.init(n, 0.8, device="cpu"), *map(_t, _vecs(n, 2, 61)), 0.2)
    (v,) = map(_t, _vecs(n, 1, 62))
    a, b = st.a, st.b
    fl = lambda x: torch.flip(x, (0,))
    w = (fl(a) * v - fl(b) * fl(v)) / (a * fl(a) - b * fl(b))
    torch.testing.assert_close(a * w + fl(b) * fl(w), v, rtol=1e-4, atol=1e-5)


def test_shift_couples_half_shift_partners():
    """Q's off-diagonal pattern is {(i, (i + n//2) mod n)}: the butterfly
    pairing, not xmat's mirror."""
    n = 64
    st = shift.update(shift.init(n, 0.8, device="cpu"), *map(_t, _vecs(n, 2, 81)), 0.2)
    (x,) = map(_t, _vecs(n, 1, 82))
    torch.testing.assert_close(shift.matvec(st, x), st.a * x + st.b * torch.roll(x, -(n // 2)),
                               rtol=1e-5, atol=1e-6)


def test_public_inits_default_to_the_card():
    for init in (kron.init, dense.init, diag.init, lra.init, xmat.init, shift.init, splu.init,
                 rosenbrock.init):
        assert inspect.signature(init).parameters["device"].default == "cuda", init
    # the models that draw from a generator place on the generator's device
    g = torch.Generator().manual_seed(0)
    assert all(p.device.type == "cpu" for p in tensor_decomp.init(g))


def test_interop_defaults_to_the_card():
    """Every function that carries the JAX package's arrays into the port
    places on the card unless told otherwise: no silent CPU state."""
    fns = [interop.tensors, interop.kron_states, interop.dense_state, interop.diag_state,
           interop.lra_state, interop.splu_state, interop.xmat_state, interop.shift_state]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    (t,) = interop.tensors([np.ones(3, np.float32)], device="cpu")
    assert t.device.type == "cpu"
