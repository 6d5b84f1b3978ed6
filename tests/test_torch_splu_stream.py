"""K16's streaming chain on the CPU: `splu_upd.chain_plain` (the kernels'
oracle) and the same chain split over two simulated shard ranks, against
the JAX package's streaming kernels (`splu_upd.fused_update`, its stage
pallas_calls in interpret mode), at ragged shapes: odd n, n - r not a
multiple of 4, and r on both sides of the rank-32 kernels. Then the
premise of a Gram that computes only what the corners read: the corner
algebra reads no Gram entry outside those listed here (`_gram_read`), and
the kernels' register tiles (`_gram_tiles`, `splu_tile` in csrc/splu.cu)
hold every entry it reads. Tolerances
are tests/test_torch_splu.py's: rtol 2e-5, atol 2e-6 for one update
(rtol 2e-5, atol 1e-5 for the sharded chain, as tests/test_torch_parallel.py
holds the sharded K16)."""
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import splu as jsplu
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import splu_upd as jsplu_upd
from psgd_tf_tpu_torch import interop
from psgd_tf_tpu_torch.groups import splu
from psgd_tf_tpu_torch.ops.hopper import splu_upd
from psgd_tf_tpu_torch.parallel import policies

torch.set_num_threads(1)
TINY = jlinalg.tiny(jnp.float32)
TOL = dict(rtol=2e-5, atol=2e-6)
TOL_SHARDED = dict(rtol=2e-5, atol=1e-5)
# odd n, n - r = 2 or 3 mod 4; r = 1, 3, 10, 32 (the rank-32 kernels) and
# 33, 64 (the rank-generic chain)
SHAPES = [(303, 1), (301, 3), (517, 10), (451, 32), (451, 33), (517, 64)]
RANKS = [1, 3, 10, 32, 33, 64]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _fields(st):
    return st.Lt, st.l3, st.U12, st.u3


_CASES = {}


def _case(n, r):
    """A JAX state walked three XLA updates off 0.7 I (l3 spread below 1,
    so that a balance counting the shards' 1-padding would move it), fresh
    v, h, g, and JAX's streaming update with and without g in interpret
    mode; cached per shape."""
    if (n, r) not in _CASES:
        rng = np.random.default_rng(n + 100 * r)
        st = jsplu.init(n, rank=r, init_scale=0.7)
        for _ in range(3):
            v, h = (jnp.asarray(rng.standard_normal(n).astype(np.float32)) for _ in range(2))
            st = jsplu.update(st, v, h, step=0.1)
        l3 = np.asarray(st.l3) * (0.3 + 0.5 * rng.random(n - r)).astype(np.float32)
        st = jsplu.SpLUState(Lt=st.Lt, l3=jnp.asarray(l3), U12=st.U12, u3=st.u3)
        v, h, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
        want = jsplu_upd.fused_update(*_fields(st), v, h, 0.05, TINY, interpret=True)
        want_g = jsplu_upd.fused_update(*_fields(st), v, h, 0.05, TINY, interpret=True, g=g)
        port = interop.splu_state(*(np.asarray(x) for x in _fields(st)), device="cpu")
        _CASES[(n, r)] = (port, (_t(v), _t(h), _t(g)), want, want_g)
    return _CASES[(n, r)]


def _gram_read(r, which=1):
    """The entries (a <= b) of a (2r + 2)-square Gram that the corner
    algebra reads (with their mirrors): stage 1's (which = 1, rows [L2^T;
    U2 w; dx2 w; l3 u3 dg2], `splu_upd.stage1_plain`) for `corner_a_plain`,
    the apply's (which = 2, rows [L2^T'; U2'; l3' u3' g2; g2]) for
    `corner_c_plain`."""
    sym = [(a, b) for a in range(r) for b in range(a, r)]
    if which == 2:
        return sym + [(a, 2 * r) for a in range(r)] + [(r + a, 2 * r + 1) for a in range(r)]
    return (sym + [(a, r + b) for a in range(r) for b in range(r)]
            + [(r + a, r + b) for a, b in sym]
            + [(a, 2 * r + c) for a in range(2 * r) for c in (0, 1)])


def _gram_tiles(r, which=1, size=4):
    """The first rows (a0, b0) of the size x size tiles in which the kernels
    sum a Gram (`splu_tile` in `csrc/splu.cu`): the upper triangle of stage
    1's rows in tiles over size ceil((2r + 2) / size) rows (4 x 4 tiles in
    the rank-32 kernels, 8 x 8 in the rank-generic stage 1); the apply's
    (size 4) upper triangle of its first r rows, then each row quad of its
    first 2r rows against rows 2r, 2r + 1."""
    q = (2 * r + 1 + size) // size if which == 1 else (r + 3) // 4
    up = [(size * a, size * b) for a in range(q) for b in range(a, q)]
    return up if which == 1 else up + [(4 * a, 2 * r) for a in range((r + 1) // 2)]


def _close(got, want, **tol):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("n,r", SHAPES)
def test_chain_plain_matches_stream_interpret(n, r):
    """The plain chain, update and update + apply, against JAX's streaming
    kernels; the corner triangles come out exact."""
    st, (v, h, g), want, want_g = _case(n, r)
    got = splu_upd.chain_plain(*_fields(st), v, h, 0.05)
    assert got[4] is None
    _close(got[:4], want)
    got_g = splu_upd.chain_plain(*_fields(st), v, h, 0.05, g)
    _close(got_g, want_g)
    L1, U1 = got_g[0][:, :r].T, got_g[2][:, :r]
    assert torch.equal(L1, torch.tril(L1)) and torch.equal(U1, torch.triu(U1))


class _Ranks:
    """Reductions over `size` simulated shard ranks, each a thread: every
    rank puts its value, all wait, and each takes the sum (in rank order)
    or the max of the stacked values."""

    def __init__(self, size):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=120)

    def reduce(self, rank, op):
        def f(x):
            self.slots[rank] = x
            self.barrier.wait()
            stacked = torch.stack(self.slots)
            out = stacked.sum(0) if op == "sum" else stacked.amax(0)
            self.barrier.wait()  # every rank has read the slots
            return out

        return f


def _sharded(st, v, h, g, size=2):
    """The chain on `size` ranks' slices of the tail (`policies.shard_state`
    and `slice_vec`: zero columns and l3 = u3 = 1 past the real lanes), the
    three reductions taken over the ranks; the results gathered: (Lt', l3',
    U12', u3', P' g or None), the corner results of rank 0, whether every
    rank's corner came out the same, and each rank's padding lanes."""
    r, n = st.U12.shape
    ranks, out, errors = _Ranks(size), [None] * size, []

    def run(k):
        try:
            mesh = types.SimpleNamespace(shard=size, shard_rank=k)
            loc = policies.shard_state(mesh, st)
            vl, hl = policies.slice_vec(mesh, loc, v), policies.slice_vec(mesh, loc, h)
            gl = policies.slice_vec(mesh, loc, g) if g is not None else None
            out[k] = (loc.tail_valid, loc.l3.shape[0] - loc.tail_valid, splu_upd.chain_plain(
                *_fields(loc), vl, hl, 0.05, gl, loc.tail_valid, ranks.reduce(k, "sum"),
                ranks.reduce(k, "max")))
        except Exception as e:  # reported by the main thread
            errors.append(e)
            ranks.barrier.abort()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(size)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    if errors:
        raise errors[0]
    res = [o[2] for o in out]
    tail = lambda i, cols: torch.cat([x[i][..., r:r + o[0]] if cols else x[i][:o[0]]
                                      for o, x in zip(out, res)], -1)
    lt = torch.cat([res[0][0][:, :r], tail(0, True)], 1)
    u12 = torch.cat([res[0][2][:, :r], tail(2, True)], 1)
    pre = torch.cat([res[0][4][:r], tail(4, True)]) if g is not None else None
    same = all(torch.equal(x[0][:, :r], res[0][0][:, :r])
               and torch.equal(x[2][:, :r], res[0][2][:, :r]) for x in res)
    return (lt, tail(1, False), u12, tail(3, False), pre), same, [o[1] for o in out]


@pytest.mark.parametrize("n,r", SHAPES)
def test_sharded_chain_matches_stream_interpret(n, r):
    """The chain split over two shard ranks (the last one's tail padded:
    nvalid < its lanes where n - r is odd), gathered, against JAX's
    unsharded streaming kernels and the unsharded plain chain, update and
    update + apply; every rank computes the same corner."""
    st, (v, h, g), want, want_g = _case(n, r)
    got, same, pads = _sharded(st, v, h, None)
    assert same and got[4] is None and pads == [0, (n - r) % 2]
    _close(got[:4], want, **TOL_SHARDED)
    got_g, same, _ = _sharded(st, v, h, g)
    assert same
    _close(got_g, want_g, **TOL_SHARDED)
    _close(got_g, splu_upd.chain_plain(*_fields(st), v, h, 0.05, g), **TOL_SHARDED)


def _gram_inputs(n, r):
    st, (v, h, g), _, _ = _case(n, r)
    return st, v, h, g


@pytest.mark.parametrize("r", RANKS)
def test_corners_read_only_the_listed_gram_entries(r):
    """Every Gram entry outside `_gram_read` (and its mirror) set to NaN:
    corner A and, after stage 2, corner B give the same bits; corner C
    likewise with the apply's Gram."""
    n = {s[1]: s[0] for s in SHAPES}[r]
    st, v, h, g = _gram_inputs(n, r)
    Lt, l3, U12, u3 = _fields(st)
    z = 2 * r + 2

    def poisoned(gram, which):
        keep = torch.zeros(z, z, dtype=torch.bool)
        for a, b in _gram_read(r, which):
            keep[a, b] = keep[b, a] = True
        assert gram.shape == (z, z) and not keep.all() and keep.sum() < z * z
        return torch.where(keep, gram, torch.full_like(gram, float("nan")))

    gram, maxs3 = splu_upd.stage1_plain(Lt, l3, U12, u3, v, h)
    outs = []
    for gr in (gram, poisoned(gram, 1)):
        rs, cs = splu_upd.corner_a_plain(Lt, U12, v, h, gr, maxs3)
        maxs2 = splu_upd.stage2_plain(Lt, l3, U12, u3, v, h, rs[:, :8])
        outs.append((rs, cs, maxs2) + splu_upd.corner_b_plain(Lt, U12, rs, cs, maxs2, 0.05))
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)
    rs, cs = splu_upd.corner_a_plain(Lt, U12, v, h, gram, maxs3)
    coef3, scal, new_l1, new_u1 = outs[0][3:]
    *_, gram2 = splu_upd.stage3_plain(Lt, l3, U12, u3, v, h, coef3, scal, g)
    got = [splu_upd.corner_c_plain(new_l1, new_u1, g[:r], gr) for gr in (gram2, poisoned(gram2, 2))]
    for a, b in zip(*got, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which,size", [(1, 4), (1, 8), (2, 4)])
@pytest.mark.parametrize("r", RANKS + [128])
def test_gram_tiles_hold_every_entry_read(r, which, size):
    """Each entry `_gram_read` lists lies in a tile of `_gram_tiles` (on or
    above the diagonal; 4 x 4 tiles in the rank-32 kernels, 8 x 8 in the
    rank-generic stage 1), and the tiles cover each (a, b) of their
    (2r + 2)-square part at most once where the corners read it."""
    tiles = _gram_tiles(r, which, size)
    z = 2 * r + 2
    owners = {}
    for t, (a0, b0) in enumerate(tiles):
        assert a0 % 4 == 0 and a0 <= b0
        for a in range(a0, min(a0 + size, z)):
            for b in range(b0, min(b0 + size, z)):
                if a <= b:
                    owners.setdefault((a, b), []).append(t)
    for a, b in _gram_read(r, which):
        assert a <= b < z and (a, b) in owners, (a, b)
    if which == 1:  # stage 1's tiles partition the upper triangle
        assert all(len(ts) == 1 for ts in owners.values())
        assert len(owners) == z * (z + 1) // 2


@pytest.mark.parametrize("n,r", SHAPES)
def test_u2_dg2_as_w_and_lud(n, r):
    """The Gram reads U2 dg2 as (U2 w) . (l3 u3 dg2), w = 1 / (l3 u3): within
    the update's tolerance of the U2 form, both against float64."""
    st, v, h, _ = _gram_inputs(n, r)
    Lt, l3, U12, u3 = _fields(st)
    gram, _ = splu_upd.stage1_plain(Lt, l3, U12, u3, v, h)
    got = gram[r:2 * r, 2 * r + 1]
    u2_form = U12[:, r:] @ h[r:]
    exact = U12[:, r:].double() @ h[r:].double()
    scale = exact.abs().max().item()
    for x in (got, u2_form):
        np.testing.assert_allclose(x.double().numpy(), exact.numpy(), rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(1.0, scale))
    np.testing.assert_allclose(got.numpy(), u2_form.numpy(), rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(1.0, scale))


def test_sharded_maxima_leave_the_padding_out():
    """The balance's tail maxima of a rank whose slice is mostly padding."""
    st, (v, h, _), _, _ = _case(*SHAPES[2])
    r = st.rank
    mesh = types.SimpleNamespace(shard=4, shard_rank=3)
    loc = policies.shard_state(mesh, st)
    assert 0 < loc.tail_valid < loc.l3.shape[0]
    _, maxs = splu_upd.stage1_plain(*_fields(loc), policies.slice_vec(mesh, loc, v),
                                    policies.slice_vec(mesh, loc, h), loc.tail_valid)
    k = loc.tail_valid
    assert maxs.tolist() == [loc.l3[:k].max().item(), loc.u3[:k].max().item()]
    assert splu.SpLUState is type(loc) and loc.Lt.shape[1] == r + loc.l3.shape[0]
