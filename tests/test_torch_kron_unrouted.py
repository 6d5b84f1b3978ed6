"""Port parity: the Kronecker family's unrouted kernels of psgd_tf_tpu_torch
on the CPU (the plain versions of K17 `fused_apply_ns`/`fused_apply_nd`,
K18 `fused_apply_ns_wide`, K19 `solve_triangular` and K20
`kron_dd.fused_update_multi`) against the JAX functions of the same names,
their Pallas kernels run in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import kron as jkron
from psgd_tf_tpu.ops.pallas import kron_dd as jkdd
from psgd_tf_tpu.ops.pallas import kron_sparse_big as jksb
from psgd_tf_tpu.ops.pallas import tri as jtri
from psgd_tf_tpu_torch import interop
from psgd_tf_tpu_torch.groups import kron
from psgd_tf_tpu_torch.ops import hopper
from psgd_tf_tpu_torch.ops.hopper import kron_dd, kron_sparse_big, tri

torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny * np.finfo(np.float32).eps)


def _walked(rng, fmt, shape, steps=3):
    """A JAX KronState walked `steps` XLA updates off 0.8 I, and the port's
    copy of it."""
    st = jkron.init(shape, fmt=fmt, init_scale=0.8)
    for _ in range(steps):
        dx, dg = (jnp.asarray(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
        st = jkron.update(st, dx, dg, step=0.05)
    (port,) = interop.kron_states([(np.asarray(st.ql), np.asarray(st.qr), st.fmt)],
                                  device="cpu")
    return st, port


# -------------------------------------------------------------- K17 / K18

@pytest.mark.parametrize("fmt,shape", [
    (("norm", "scale"), (1030, 257)),   # m-1 mid-panel after the JAX padding
    (("norm", "scale"), (80, 34000)),   # the lane-streaming regime
    (("norm", "dense"), (900, 70)),
    (("norm", "dense"), (1500, 200)),
    # K17 nd's GEMM tiles at ragged edges: m = 2 (row m - 1 is both an
    # ordinary row and the arrow's), n odd; m past a tile, n odd
    (("norm", "dense"), (2, 65)),
    (("norm", "dense"), (130, 67)),
], ids=str)
def test_streamed_apply_matches_jax(fmt, shape):
    rng = np.random.default_rng(sum(shape))
    jst, st = _walked(rng, fmt, shape)
    G = rng.standard_normal(shape).astype(np.float32)
    jfn, fn = {"scale": (jksb.fused_apply_ns, kron_sparse_big.fused_apply_ns),
               "dense": (jksb.fused_apply_nd, kron_sparse_big.fused_apply_nd)}[fmt[1]]
    ref = np.asarray(jfn(jst.ql, jst.qr, jnp.asarray(G), interpret=True))
    before = dict(hopper.counts)
    got = fn(st.ql, st.qr, torch.from_numpy(G))
    assert hopper.counts == before  # CPU tensors take the plain version, no launch
    # the JAX suite's own bound for these kernels against the XLA chain
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5, atol=5e-6)
    np.testing.assert_allclose(got.numpy(), kron.apply(st, torch.from_numpy(G)).numpy(),
                               rtol=5e-5, atol=5e-6)


def test_wide_apply_matches_jax_at_a_ragged_shape():
    rng = np.random.default_rng(3)
    m, n = 70, 40000  # m not a multiple of WIDE2_BLK, n not of 128
    ql = np.stack([0.8 + 0.1 * rng.standard_normal(m),
                   0.05 * rng.standard_normal(m)]).astype(np.float32)
    ql[1, -1] = 0.0
    qr = (0.9 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    G = rng.standard_normal((m, n)).astype(np.float32)
    ref = np.asarray(jksb.fused_apply_ns_wide(jnp.asarray(ql), jnp.asarray(qr), jnp.asarray(G),
                                              interpret=True))
    got = kron_sparse_big.fused_apply_ns_wide(*map(torch.from_numpy, (ql, qr, G)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


# -------------------------------------------------------------------- K19

def _tri_system(rng, n, nrhs, lower):
    q = np.triu(np.eye(n) + 0.1 * rng.standard_normal((n, n))).astype(np.float32)
    if lower:
        q = np.ascontiguousarray(q.T)
    b = rng.standard_normal((n, nrhs) if nrhs else (n,)).astype(np.float32)
    return q, b


@pytest.mark.parametrize("n,nrhs,lower,trans", [
    (128, 128, False, True),
    (300, 64, False, True),
    (512, 256, False, False),
    (257, 0, True, False),   # nrhs 0: a 1-D right-hand side (JAX's (257, 1) case)
    (640, 200, True, True),
    (300, 0, False, True),
])
def test_solve_triangular_matches_jax(n, nrhs, lower, trans):
    rng = np.random.default_rng(n + nrhs)
    q, b = _tri_system(rng, n, nrhs, lower)
    ref = np.asarray(jtri.solve_triangular(jnp.asarray(q), jnp.asarray(b), lower=lower,
                                           trans=trans, interpret=True))
    got = tri.solve_triangular(torch.from_numpy(q), torch.from_numpy(b), lower=lower,
                               trans=trans)
    assert got.shape == b.shape
    # norm-relative: a triangular solve amplifies fp32 rounding with the
    # system's condition number (the JAX suite's bound)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("trans", [False, True])
def test_solve_triangular_past_the_jax_cap(lower, trans):
    """n = 1024 is past the Pallas kernel's VMEM cap (768); the port has
    none. Held against a float64 dense solve of the same system."""
    rng = np.random.default_rng(1024)
    q, b = _tri_system(rng, 1024, 48, lower)
    ref = np.linalg.solve((q.T if trans else q).astype(np.float64), b.astype(np.float64))
    got = tri.solve_triangular(torch.from_numpy(q), torch.from_numpy(b), lower=lower,
                               trans=trans)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# -------------------------------------------------------------------- K20

def _dd_layers(rng, shapes):
    qls = [np.triu(np.eye(m) + 0.05 * rng.standard_normal((m, m))).astype(np.float32)
           for m, _ in shapes]
    qrs = [np.triu(np.eye(n) + 0.05 * rng.standard_normal((n, n))).astype(np.float32)
           for _, n in shapes]
    dxs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    dgs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return qls, qrs, dxs, dgs


def test_dd_multi_matches_jax():
    """JAX's multi-layer test list: the LeNet5 layer zoo and an odd shape."""
    shapes = [(26, 6), (151, 16), (401, 120), (121, 84), (85, 10), (7, 3)]
    layers = _dd_layers(np.random.default_rng(10), shapes)
    ref_qls, ref_qrs = jkdd.fused_update_multi(*[[jnp.asarray(a) for a in x] for x in layers],
                                               0.1, TINY, interpret=True)
    got_qls, got_qrs = kron_dd.fused_update_multi(
        *[[torch.from_numpy(a) for a in x] for x in layers], 0.1)
    assert len(got_qls) == len(got_qrs) == len(shapes)
    for g, r in zip(got_qls + got_qrs, ref_qls + ref_qrs, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_dd_multi_past_one_chain_matches_per_layer_jax():
    """18 layers of mixed sizes (two chains of K1 on the card), in order,
    against the JAX package's per-layer (dense, dense) update."""
    rng = np.random.default_rng(18)
    shapes = [(26, 6), (1, 10), (61, 33)] * 6  # three sizes keep JAX's compiles few
    layers = _dd_layers(rng, shapes)
    got_qls, got_qrs = kron_dd.fused_update_multi(
        *[[torch.from_numpy(a) for a in x] for x in layers], 0.1)
    update_dd = jax.jit(jkron._update_dd)
    for i, (ql, qr, dx, dg) in enumerate(zip(*layers)):
        rl, rr = update_dd(*map(jnp.asarray, (ql, qr, dx, dg)), jnp.float32(0.1), TINY)
        np.testing.assert_allclose(got_qls[i].numpy(), np.asarray(rl), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_qrs[i].numpy(), np.asarray(rr), rtol=1e-5, atol=1e-6)
