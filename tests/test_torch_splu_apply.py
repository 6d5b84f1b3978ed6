"""Port parity for the sparse-LU fused apply entry and the one-launch
schedule: `splu_upd.fused_update(..., g=g)` and `fused_update_apply_mono`
of psgd_tf_tpu_torch on the CPU (their plain chain) against the JAX
package's functions of the same names in interpret mode, with the JAX
suite's bounds (rtol 2e-5, atol 2e-6); and what the port computes in
place of `tri.dot_bf16x3`."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import splu as jsplu
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import splu_one as jsplu_one
from psgd_tf_tpu.ops.pallas import splu_upd as jsplu_upd
from psgd_tf_tpu.ops.pallas import tri as jtri
from psgd_tf_tpu_torch import interop, splu
from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import splu_upd

torch.set_num_threads(1)
TINY = jlinalg.tiny(jnp.float32)
TOL = dict(rtol=2e-5, atol=2e-6)
# tests/test_pallas.py:290's shapes, then r = 10, r = 1, r = 16 and
# (9000, 3), where the JAX kernels' tail spans two 8192-lane grid steps
APPLY_SHAPES = [(64, 6), (130, 4), (100, 10), (48, 1), (200, 16), (9000, 3)]
# tests/test_pallas.py:695's shapes, then two grid steps
# the JAX tests' shapes and ranks past 32, where the card's one launch runs
# the rank-generic chain's bodies
MONO_SHAPES = [(100, 10), (300, 4), (48, 1), (9000, 3), (200, 40), (300, 64)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _walked(n, r, seed, steps=3):
    """A JAX state walked `steps` XLA updates off 0.7 I, and fresh v, h, g."""
    rng = np.random.default_rng(seed)
    st = jsplu.init(n, rank=r, init_scale=0.7)
    for _ in range(steps):
        v, h = (jnp.asarray(rng.standard_normal(n).astype(np.float32)) for _ in range(2))
        st = jsplu.update(st, v, h, step=0.1)
    return st, [rng.standard_normal(n).astype(np.float32) for _ in range(3)]


def _fields(st):
    return st.Lt, st.l3, st.U12, st.u3


def _port(jst):
    st = interop.splu_state(*(np.asarray(x) for x in _fields(jst)), device="cpu")
    return _fields(st)


def _close(got, want, **tol):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("n,r", APPLY_SHAPES)
def test_fused_apply_matches_pallas_interpret(n, r):
    """The port's `fused_update(g=g)` against JAX's `fused_update(g=g)`
    (stage 3 with the apply Gram, stage 4) in interpret mode, and against
    the XLA update followed by the apply of the updated state."""
    jst, (v, h, g) = _walked(n, r, 3 * n + r)
    want = jsplu_upd.fused_update(*_fields(jst), v, h, 0.05, TINY, interpret=True, g=g)
    xla = jsplu.update(jst, v, h, step=0.05)
    got = splu_upd.fused_update(*_port(jst), _t(v), _t(h), 0.05, g=_t(g))
    _close(got, want)
    _close(got, _fields(xla) + (jsplu.apply(xla, g),))
    L1, U1 = got[0][:, :r].T, got[2][:, :r]
    assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))


def test_fused_apply_matches_stream_interpret():
    """The streaming regime at (3000, 5): JAX's padded SpLUStreamState (its
    cap patched) through `fused_update_stream(g=g)` in interpret mode, the
    port's fused apply on its logical views."""
    n, r = 3000, 5
    with mock.patch.object(jsplu_one, "fits", lambda r_, n_: False):
        jst = jsplu.init(n, rank=r, init_scale=0.7)
    assert isinstance(jst, jsplu.SpLUStreamState)
    rng = np.random.default_rng(5)
    v, h, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    out = jsplu_upd.fused_update_stream(jst.L1t, jst.U1, jst.L2tp, jst.U2p, jst.l3p, jst.u3p,
                                        jst.n, v, h, 0.05, TINY, interpret=True, g=g)
    want = jst.replace(L1t=out[0], U1=out[1], L2tp=out[2], U2p=out[3], l3p=out[4], u3p=out[5])
    got = splu_upd.fused_update(*_port(jst), _t(v), _t(h), 0.05, g=_t(g))
    _close(got, _fields(want) + (out[6],))


@pytest.mark.parametrize("n,r", MONO_SHAPES)
def test_mono_matches_pallas_interpret(n, r):
    """The port's one-launch entry (its plain version on the CPU) against
    JAX's `fused_update_apply_mono` in interpret mode, and equal bit for bit
    to the port's fused apply entry."""
    jst, (v, h, g) = _walked(n, r, 5 * n + r)
    want = jsplu_upd.fused_update_apply_mono(*_fields(jst), v, h, g, 0.05, TINY, interpret=True)
    fields = _port(jst)
    got = splu_upd.fused_update_apply_mono(*fields, _t(v), _t(h), _t(g), 0.05)
    _close(got, want)
    chain = splu_upd.fused_update(*fields, _t(v), _t(h), 0.05, g=_t(g))
    assert all(torch.equal(a, b) for a, b in zip(got, chain, strict=True))
    plain = splu_upd.fused_update_apply_mono_plain(*fields, _t(v), _t(h), _t(g), 0.05)
    assert all(torch.equal(a, b) for a, b in zip(got, plain, strict=True))


def test_twenty_step_walk_through_the_fused_apply():
    """The slice as a whole: 20 chained updates with P' g at (3000, 5)
    through the fused entry against JAX's XLA `splu.update` then
    `splu.apply`, at ROADMAP's trajectory bound 5e-4."""
    n, r = 3000, 5
    rng = np.random.default_rng(21)
    jst = jsplu.init(n, rank=r, init_scale=0.5)
    assert isinstance(jst, jsplu.SpLUState)
    st = _fields(splu.init(n, rank=r, init_scale=0.5, device="cpu"))
    for _ in range(20):
        v, h, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
        jst = jsplu.update(jst, jnp.asarray(v), jnp.asarray(h), step=0.1)
        *st, pre = splu_upd.fused_update(*st, _t(v), _t(h), 0.1, g=_t(g))
        np.testing.assert_allclose(pre.numpy(), np.asarray(jsplu.apply(jst, g)), rtol=5e-4,
                                   atol=5e-5)
    _close(st, _fields(jst), rtol=5e-4, atol=5e-5)
    L1, U1 = st[0][:, :r].T, st[2][:, :r]
    assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))


def test_entry_arities_and_counters():
    """Four outputs without g, five with it (JAX's contract); the CPU takes
    the plain chain and counts no launch."""
    jst, (v, h, g) = _walked(64, 6, 1)
    fields = _port(jst)
    before = dict(hopper.counts)
    upd = splu_upd.fused_update(*fields, _t(v), _t(h), 0.05)
    fused = splu_upd.fused_update(*fields, _t(v), _t(h), 0.05, g=_t(g))
    mono = splu_upd.fused_update_apply_mono(*fields, _t(v), _t(h), _t(g), 0.05)
    assert (len(upd), len(fused), len(mono)) == (4, 5, 5)
    assert fused[4].shape == (64,) and all(torch.equal(a, b) for a, b in zip(upd, fused))
    assert dict(hopper.counts) == before
    jout = jsplu_upd.fused_update(*_fields(jst), v, h, 0.05, TINY, interpret=True)
    assert len(jout) == 4


def test_fp32_product_in_place_of_dot_bf16x3():
    """`tri.dot_bf16x3` stands in for Precision.HIGH on the TPU; the port
    computes those products in fp32 (K9/K10's substitutions in
    `csrc/kron_dd.cu`'s grouped GEMM). Against a float64 reference on the
    same (256, 128) @ (128, 384) operands the fp32 product is within 1e-6
    of max |ref| and no less accurate than dot_bf16x3 (x 1.5). dot_bf16x3
    keeps 16 of each operand's 24 mantissa bits (two bf16 halves) and drops
    lo * lo, so it is held to 2^-16 of max |ref|."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = rng.standard_normal((128, 384)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    err_x3 = np.abs(np.asarray(jtri.dot_bf16x3(jnp.asarray(a), jnp.asarray(b)), np.float64)
                    - ref).max()
    err_f32 = np.abs((torch.from_numpy(a) @ torch.from_numpy(b)).double().numpy() - ref).max()
    assert err_f32 <= 1e-6 * scale
    assert err_x3 <= 2.0**-16 * scale
    assert err_f32 <= 1.5 * err_x3
