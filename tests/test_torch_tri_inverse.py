"""K3's recursive schedule on the CPU, and the route of K1's chain.

`tri.inverse_schedule` lists the levels the CUDA kernels run (pairs of
diagonal blocks joined by X12 = -X11 (U12 X22)); `tri.inverse_upper_blocked_
plain` executes it in torch through the same index maps. Both are held
against float64 inverses at ragged sides and against the JAX package's
batched Newton inverse of 128 x 128 blocks (`tri._newton_inv_batched`,
plain JAX, run on the CPU as the JAX suite runs it). `kron_dd.route`, the
mirror of `csrc/kron_dd.cu`'s pick between the chain of launches and the
one cooperative launch, is checked on the paths' lists."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.ops.pallas import tri as jtri
from psgd_tf_tpu_torch import kron
from psgd_tf_tpu_torch.models import nmt
from psgd_tf_tpu_torch.ops.hopper import kron_dd, tri

torch.set_num_threads(1)

LENET5 = [(26, 6), (151, 16), (257, 120), (121, 84), (85, 10)]
DD = ("dense", "dense")


def _triu_factor(rng, n):
    """A factor as the walked Kronecker factors are: a positive diagonal
    and small upper entries."""
    u = np.triu(0.1 / np.sqrt(n) * rng.standard_normal((n, n)), 1)
    return (u + np.diag(0.5 + rng.random(n))).astype(np.float32)


@pytest.mark.parametrize("n", [1, 6, 31, 32, 33, 257, 300])
def test_blocked_inverse_matches_float64(n):
    """1e-5 relative to max |X| (both exact to fp32 rounding), the strictly
    lower part exactly zero."""
    u = _triu_factor(np.random.default_rng(n), n)
    (got,) = tri.inverse_upper_blocked_plain([torch.from_numpy(u)])
    ref = np.linalg.inv(u.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.all(np.tril(got.numpy(), -1) == 0.0)


def test_blocked_inverse_matches_jax_newton_blocks():
    """On stacked 128 x 128 blocks, K3's schedule (two levels past its
    32-row leaves) and the JAX package's batched Newton inverse agree."""
    rng = np.random.default_rng(11)
    blocks = np.stack([_triu_factor(rng, 128) for _ in range(4)])
    ref = np.asarray(jtri._newton_inv_batched(jnp.asarray(blocks)))
    got = tri.inverse_upper_blocked_plain([torch.from_numpy(b) for b in blocks])
    for x, r in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("n,levels", [(1, 0), (32, 0), (33, 1), (64, 1), (65, 2), (257, 4),
                                      (300, 4), (1024, 5), (1025, 6)])
def test_schedule_levels_and_pairs(n, levels):
    """ceil(log2(leaves)) levels; every off-diagonal leaf pair joined once."""
    sched = tri.inverse_schedule(n)
    assert len(sched) == levels
    leaves = -(-n // tri.LEAF)
    covered = np.zeros((leaves, leaves), dtype=int)
    for l, pairs in enumerate(sched):
        for r0, s, e in pairs:
            assert s - r0 == tri.LEAF << l and s < n and e == min(r0 + 2 * (s - r0), n)
            covered[r0 // 32:-(-s // 32), s // 32:-(-e // 32)] += 1
    assert np.array_equal(covered, np.triu(np.ones_like(covered), 1))


def _canonical(fmts, shapes):
    """(kinds, m, n) of a layer list as the chain takes it: mirrors
    transposed into their sibling."""
    kinds, ms, ns = [], [], []
    for fmt, (m, n) in zip(fmts, shapes):
        kind, mirrored = kron._canon(fmt)
        kinds.append(kind)
        ms.append(n if mirrored else m)
        ns.append(m if mirrored else n)
    return kinds, ms, ns


def test_route_takes_one_launch_on_lists_with_sparse_sides():
    """The toy NMT model's list of mixed kinds and single (dense, scale),
    (norm, dense) and (norm, scale) layers up to K5's cap take the one
    launch; LeNet5's five (dense, dense) layers, the K4 path's bucket and a
    (1, 10) layer keep the chain."""
    cfg = nmt.Config()
    assert kron_dd.route(*_canonical(nmt.kron_formats(cfg), nmt.layer_shapes(cfg))) == "mono"
    for kind in ("ds", "nd", "ns"):
        assert kron_dd.route([kind], [130], [65]) == "mono"
        assert kron_dd.route([kind], [512], [512]) == "mono"
    k4 = [s for s in nmt.layer_shapes(nmt.Config(vocab_src=1100, vocab_tgt=1030, embed=16,
                                                 units=32)) if kron.auto_format(s) == DD]
    assert kron_dd.route(["dd"] * len(k4), [m for m, _ in k4], [n for _, n in k4]) == "chain"
    assert kron_dd.route(["dd"], [1], [10]) == "chain"
    ms, ns = [m for m, _ in LENET5], [n for _, n in LENET5]
    assert kron_dd.route(["dd"] * 5, ms, ns) == "chain"


@pytest.mark.parametrize("B", [16, 8])
def test_route_keeps_the_chain_where_the_gemm_fills_the_card(B):
    """K2 at (1024, 1024) and K4's B = 24 bucket of (200, 256) (its two
    chunks, 16 and 8 layers) keep the chain of launches."""
    assert kron_dd.route(["dd"], [1024], [1024]) == "chain"
    assert kron_dd.route(["dd"] * B, [200] * B, [256] * B) == "chain"


def test_route_flops_and_tiles():
    """The route's work count (2 M N K a product) and its 128 x 128-tile
    rule: a list past 4 x SMs such tiles in one stage is the chain's alone,
    whatever its FLOPs."""
    assert kron_dd.chain_flops(["ns"], [512], [4096]) == 0.0
    m, n = 26, 6
    assert kron_dd.chain_flops(["dd"], [m], [n]) == 8 * m * n * (m + n) + 2 * (m**3 + n**3)
    assert kron_dd.route(["ns"] * 16, [4096] * 16, [4096] * 16, sms=132) == "mono"
    assert kron_dd.route(["ns"] + ["dd"] * 4, [8] + [512] * 4, [8] + [512] * 4) == "chain"
    assert kron_dd.route(["nd"] * 16, [4096] * 16, [1] * 16, sms=8) == "chain"


def test_forced_route_names_a_route():
    with pytest.raises(ValueError):
        with kron_dd.forced_route("auto"):
            pass
    with kron_dd.forced_route("mono"):
        assert kron_dd._forced == "mono"
    assert kron_dd._forced is None
