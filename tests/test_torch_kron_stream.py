"""Port parity: the streaming (norm, scale) and (dense, scale) updates (K6,
K10; their plain versions on the CPU) at the shapes beside the NMT layers'
that their one-call kernels on the card must also take: a mirrored
(scale, norm) layer (K6 given dX.T), an arrow of two rows, ragged scale
sides, and zero probes. Held against the JAX package's `fused_update_ns` /
`fused_update_ds` in interpret mode and its `kron.update` (the XLA path)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import kron as jkron
from psgd_tf_tpu.ops.pallas import kron_sparse_big as jksb
from psgd_tf_tpu_torch import interop
from psgd_tf_tpu_torch.groups import kron
from psgd_tf_tpu_torch.ops.hopper import kron_sparse, kron_sparse_big

torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny * np.finfo(np.float32).eps)
# the JAX suite's own bound for kron_sparse_big against its XLA path
BIG_TOL = dict(rtol=5e-5, atol=5e-6)
NS, SN = ("norm", "scale"), ("scale", "norm")
DS, SD = ("dense", "scale"), ("scale", "dense")


def _walked(rng, fmt, shape, steps=3):
    """A JAX KronState walked `steps` XLA updates off 0.8 I."""
    st = jkron.init(shape, fmt=fmt, init_scale=0.8)
    for _ in range(steps):
        dx, dg = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        st = jkron.update(st, jnp.asarray(dx), jnp.asarray(dg), step=0.05)
    return st


def _port(jst):
    (st,) = interop.kron_states([(np.asarray(jst.ql), np.asarray(jst.qr), jst.fmt)],
                                device="cpu")
    return st


def _check_against_jax(fmt, shape, seed):
    """The port's update (through `kron.update` and the streaming wrapper)
    against JAX's streaming function in interpret mode and its XLA path."""
    kind = "ns" if "norm" in fmt else "ds"
    mirrored = fmt[0] == "scale"
    m, n = shape[::-1] if mirrored else shape
    assert not kron_sparse.fits(m, n) and kron_sparse_big.fits_grid(kind, m, n)
    assert kron.route(fmt, shape, "cuda") == jkron.route(fmt, shape) == f"kron_sparse_big:{kind}"
    rng = np.random.default_rng(seed)
    jst = _walked(rng, fmt, shape)
    dx, dg = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    ref = jkron.update(jst, jnp.asarray(dx), jnp.asarray(dg), step=0.05)
    a, b = (jst.qr, jst.ql) if mirrored else (jst.ql, jst.qr)
    jx, jg = (jnp.asarray(t.T if mirrored else t) for t in (dx, dg))
    jfn = jksb.fused_update_ns if kind == "ns" else jksb.fused_update_ds
    ka, kb = jfn(a, b, jx, jg, 0.05, TINY, interpret=True)
    ta, tb = interop.tensors([np.asarray(a), np.asarray(b)], device="cpu")
    tx, tg = torch.from_numpy(dx), torch.from_numpy(dg)
    fn = kron_sparse_big.fused_update_ns if kind == "ns" else kron_sparse_big.fused_update_ds
    ga, gb = fn(ta, tb, *(t.T if mirrored else t for t in (tx, tg)), 0.05)
    ra, rb = (ref.qr, ref.ql) if mirrored else (ref.ql, ref.qr)
    for got, want in [(ga, ka), (gb, kb), (ga, ra), (gb, rb)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BIG_TOL)
    if kind == "ns":
        assert ga[1, -1].item() == 0.0
    else:
        assert torch.equal(ga, torch.triu(ga))
    via_update = kron.update(_port(jst), tx, tg, step=0.05)
    assert torch.equal(via_update.ql, gb if mirrored else ga)
    assert torch.equal(via_update.qr, ga if mirrored else gb)


@pytest.mark.parametrize("shape", [(130, 700), (1029, 600), (1024, 257)], ids=str)
def test_mirrored_ns_layer_matches_jax(shape):
    """A (scale, norm) layer under MAX_LANES transposes into K6: the
    kernel reads its dX.T in place."""
    _check_against_jax(SN, shape, sum(shape))


@pytest.mark.parametrize("fmt,shape", [(NS, (2, 600)), (SN, (600, 2)), (DS, (2, 600)),
                                       (NS, (2, 1029))], ids=str)
def test_two_row_arrow_and_dense_side_match_jax(fmt, shape):
    """m = 2: the masked row m-1 is half the layer (an arrow of two rows),
    and K10's dense side of two rows."""
    _check_against_jax(fmt, shape, 7 + sum(shape))


@pytest.mark.parametrize("fmt,shape", [(NS, (300, 1029)), (NS, (257, 1023)), (NS, (129, 4935)),
                                       (DS, (130, 1029)), (DS, (10, 2047)),
                                       (SD, (1029, 130))], ids=str)
def test_ragged_scale_side_matches_jax(fmt, shape):
    """Scale sides with n % 4 != 0 (the kernels' strided loads) and ragged
    tiles, K10's narrow (10, n) layer among them."""
    _check_against_jax(fmt, shape, 11 + sum(shape))


@pytest.mark.parametrize("fmt,shape", [(NS, (700, 130)), (SN, (130, 700)), (DS, (130, 900)),
                                       (SD, (900, 130)), (NS, (64, 140_001))], ids=str)
def test_zero_probes_give_the_balanced_factors(fmt, shape):
    """A zero probe gives a zero gradient, the step scales saturate at the
    fp32 max (`linalg.step_scale`), and the update returns the balanced
    factors, finite (JAX's step / (0 + tiny) overflows there)."""
    rng = np.random.default_rng(19)
    jst = _walked(rng, fmt, shape, steps=2)
    st = _port(jst)
    z = torch.zeros(shape)
    got = kron.update(st, z, z, step=0.05)
    mirrored = fmt[0] == "scale"
    a, b = (np.asarray(jst.qr), np.asarray(jst.ql)) if mirrored else (np.asarray(jst.ql),
                                                                      np.asarray(jst.qr))
    left = a[0] if "norm" in fmt else np.diagonal(a)
    rho = np.sqrt(np.float32(left.max()) / np.float32(b.max()), dtype=np.float32)
    want_a, want_b = a / rho, rho * b
    ga, gb = (got.qr, got.ql) if mirrored else (got.ql, got.qr)
    for g, w in [(ga, want_a), (gb, want_b)]:
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
