"""Port parity for the sharded kernels and the parallel package: K14 (the
lane-sharded lra update, plain and pipelined), the sharded K16, the ring
reductions, the placement policies' round trips, make_mesh and comm_model.

The port runs in spawned gloo ranks on the CPU (`torch_parallel_workers`),
where the wrappers take the kernels' plain stages with the same
collectives; the JAX package runs here on the 8-device virtual CPU mesh,
its Pallas kernels in interpret mode, as `tests/test_parallel.py` runs
them. Tolerances are that file's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as workers
from psgd_tf_tpu.groups import lra as jlra
from psgd_tf_tpu.groups import splu as jsplu
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops import pallas as jpallas
from psgd_tf_tpu.ops.pallas import lra_upd as jlra_upd
from psgd_tf_tpu.ops.pallas import splu_upd as jsplu_upd
from psgd_tf_tpu.parallel import make_mesh as jmake_mesh
from psgd_tf_tpu.parallel import overlap as joverlap
from psgd_tf_tpu_torch import interop
from psgd_tf_tpu_torch.groups import lra, splu
from psgd_tf_tpu_torch.ops.hopper import lra_upd, splu_upd
from psgd_tf_tpu_torch.parallel import overlap, policies

torch.set_num_threads(1)

WORLD = 4
SHARDS = (2, 4)
COINS = [(False, False), (False, True), (True, False), (True, True)]
LRA_SIZES = [(64, 4), (100, 5), (257, 3)]  # 100 and 257 pad on 4 shards
SPLU_SIZES = [(64, 4), (103, 5)]
TINY = jlinalg.tiny(jnp.float32)


def _coin_keys():
    """One JAX key per coin pair (balance, update_u), as `lra.update` splits it."""
    keys, i = {}, 0
    while len(keys) < 4:
        k = jax.random.PRNGKey(300000 + i)
        i += 1
        k_bal, k_uv = jax.random.split(k)
        coins = (bool(jax.random.uniform(k_bal, dtype=jnp.float32) < 0.01),
                 bool(jax.random.uniform(k_uv, dtype=jnp.float32) < 0.5))
        keys.setdefault(coins, k)
    return keys


def _vecs(n, seed, count=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(count)]


def _lra_state(n, r, seed):
    st = jlra.init(jax.random.PRNGKey(seed), n, rank=r, init_scale=0.8)
    return jlra.pack(st.U * 3.0, st.V, st.d)  # imbalanced: a rebalance moves it


def _splu_state(n, r, seed):
    """A legacy state off the identity, with l3 spread below 1 so that the
    tail's 1-padding would move the balance if it were counted."""
    rng = np.random.default_rng(seed)
    st = jsplu.init(n, rank=r, init_scale=0.7)
    for k in range(3):
        v, h = _vecs(n, seed + 10 + k, 2)
        st = jsplu.update(st, jnp.asarray(v), jnp.asarray(h), step=0.1)
    l3 = np.asarray(st.l3) * (0.3 + 0.5 * rng.random(n - r)).astype(np.float32)
    return jsplu.SpLUState(Lt=st.Lt, l3=jnp.asarray(l3), U12=st.U12, u3=st.u3)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(data=2, shard=4)


@pytest.fixture(scope="module")
def cases():
    keys = _coin_keys()
    lra_cases = {}
    for n, r in LRA_SIZES:
        st = _lra_state(n, r, n + r)
        v, h, g = _vecs(n, n)
        for coins in COINS:
            lra_cases[(n, r, coins)] = (np.asarray(st.UV), np.asarray(st.d), v, h, g, coins)
    n = 65536
    pst = jlra.init(jax.random.PRNGKey(9), n, rank=3)
    pv, ph = _vecs(n, 9, 2)
    pipe = (np.asarray(pst.UV), np.asarray(pst.d), pv, ph, (False, True))
    splu_cases = {}
    for n, r in SPLU_SIZES:
        st = _splu_state(n, r, n)
        splu_cases[(n, r)] = tuple(np.asarray(x) for x in (st.Lt, st.l3, st.U12, st.u3)) \
            + tuple(_vecs(n, n + 1))
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    states = {
        "dense": ((np.triu(f(7, 7)),), 7), "diag": ((f(11),), 11),
        "lra": ((f(6, 11), f(11)), 11), "splu": ((f(3, 11), f(8), f(3, 11), f(8)), 11),
        "xmat": ((f(2, 5), f(2, 5), np.float32(0.5), False), 10),
        "xmat_odd": ((f(2, 5), f(2, 5), np.float32(0.5), True), 11),
        "shift": ((f(2, 6), f(2, 6), np.float32(0.5), False), 12),
        "shift_odd": ((f(2, 1), f(2, 1), np.float32(0.5), True), 3),
        "kron": ([(f(3, 3), f(4, 4), ("dense", "dense")), (f(2, 5), f(6), ("norm", "scale"))], 0),
    }
    outs = workers.run(workers.job_kernels, WORLD, _tmp(), SHARDS, lra_cases, pipe, splu_cases,
                       states)
    return dict(keys=keys, lra=lra_cases, pipe=pipe, splu=splu_cases, states=states, outs=outs,
                jax={})


def _jax_ref(cases, name, key, compute):
    """compute(), once per module for each (name, key): the JAX side of a
    case is the same for every shard count of the port."""
    memo = cases["jax"]
    if (name, key) not in memo:
        memo[(name, key)] = compute()
    return memo[(name, key)]


def _tmp():
    import tempfile

    return tempfile.mkdtemp(prefix="psgd_dist_")


def _same_on_every_rank(outs, key):
    """The gathered results are the same bits on every rank."""
    first = outs[0][key]
    for o in outs[1:]:
        for a, b in zip(_leaves(first), _leaves(o[key])):
            np.testing.assert_array_equal(a, b)
    return first


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for e in x for y in _leaves(e)]
    if isinstance(x, dict):
        return [y for e in x.values() for y in _leaves(e)]
    return [np.asarray(x)] if isinstance(x, np.ndarray) else []


# ------------------------------------------------------------------ K14

@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n,r", LRA_SIZES)
@pytest.mark.parametrize("coins", COINS, ids=str)
def test_k14_matches_jax_sharded(cases, jmesh, S, n, r, coins):
    """K14's update and update + apply on S shards (the plain stages with
    the collectives) against JAX `fused_update(_apply)_sharded` on
    (data=2, shard=4) and the port's unsharded K13 chain."""
    UV, d, v, h, g, _ = cases["lra"][(n, r, coins)]
    key = cases["keys"][coins]
    uv1, d1, uv2, d2, pre = _same_on_every_rank(cases["outs"], ("lra", S, (n, r, coins)))
    fn = _jax_ref(cases, "k14 fn", None, lambda: jax.jit(lambda UV, d, v, h, g, key: (
        jlra_upd.fused_update_sharded(UV, d, v, h, 0.05, key, TINY, mesh=jmesh, interpret=True),
        jlra_upd.fused_update_apply_sharded(UV, d, v, h, g, 0.05, key, TINY, mesh=jmesh,
                                            interpret=True))))
    (j_uv, j_d), (ja_uv, ja_d, ja_pre) = _jax_ref(cases, "k14", (n, r, coins),
                                                  lambda: fn(UV, d, v, h, g, key))
    t = lambda x: torch.from_numpy(np.array(x, copy=True))
    p_uv, p_d, p_pre = lra_upd.fused_update_apply(t(UV), t(d), t(v), t(h), t(g), 0.05, coins)
    tol = dict(rtol=2e-5, atol=1e-5)
    for got, want, port in [(uv1, j_uv, p_uv), (d1, j_d, p_d), (uv2, ja_uv, p_uv),
                            (d2, ja_d, p_d), (pre, ja_pre, p_pre)]:
        np.testing.assert_allclose(got, np.asarray(want), **tol)
        np.testing.assert_allclose(got, port.numpy(), **tol)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("mode", ["async", "ring"])
def test_k14_pipelined_matches_plain_and_oracle(cases, S, mode):
    """The pipelined K14 (stage 1 in four lane chunks, each reduced as it is
    launched, over either transport) at n = 65,536, r = 3 against the
    one-pass K14 and the JAX package's XLA path
    (`tests/test_parallel.py:171-201`); CPU ranks pick JAX's ring."""
    UV, d, v, h, coins = cases["pipe"]
    outs = cases["outs"]
    assert all(o[("ring pick", S)] is True for o in outs)
    got = _same_on_every_rank(outs, ("pipe", S, mode))
    plain = _same_on_every_rank(outs, ("pipe", S, "plain"))
    key = cases["keys"][coins]
    ref = jlra.update(jlra.LRAState(UV=jnp.asarray(UV), d=jnp.asarray(d)), jnp.asarray(v),
                      jnp.asarray(h), step=0.05, key=key)
    for a, b, c in zip(got, plain, (ref.UV, ref.d)):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(a, np.asarray(c), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("coins", COINS, ids=str)
def test_lra_direct_form_sharded_matches_jax(cases, S, coins):
    """The direct form on the slice, every reduction over the shard ranks
    (what other dtypes take under the sharding context), and the sharded
    apply, against the JAX package's XLA path."""
    n, r = LRA_SIZES[1]
    UV, d, v, h, g, _ = cases["lra"][(n, r, coins)]
    uv, dd, pre = _same_on_every_rank(cases["outs"], ("direct", S, (n, r, coins)))
    ref = jlra.update(jlra.LRAState(UV=jnp.asarray(UV), d=jnp.asarray(d)), jnp.asarray(v),
                      jnp.asarray(h), step=0.05, key=cases["keys"][coins])
    tol = dict(rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(uv, np.asarray(ref.UV), **tol)
    np.testing.assert_allclose(dd, np.asarray(ref.d), **tol)
    np.testing.assert_allclose(pre, np.asarray(jlra.apply(ref, jnp.asarray(g))), **tol)


# ------------------------------------------------------------------ sharded K16

@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n,r", SPLU_SIZES)
def test_sharded_splu_matches_jax(cases, jmesh, S, n, r):
    """The sharded K16 (update, and update + apply) against JAX
    `splu_upd.fused_update(mesh=...)` in interpret mode and the port's
    unsharded chain; 103 leaves a ragged tail on every mesh, and l3 below 1
    catches a balance that counted the tail's 1-padding."""
    Lt, l3, U12, u3, v, h, g = cases["splu"][(n, r)]
    with_g, pre, without_g = _same_on_every_rank(cases["outs"], ("splu", S, (n, r)))
    want = _jax_ref(cases, "splu", (n, r), lambda: jax.jit(lambda *a: jsplu_upd.fused_update(
        *a, 0.05, TINY, mesh=jmesh, interpret=True, g=jnp.asarray(g)))(Lt, l3, U12, u3, v, h))
    t = lambda x: torch.from_numpy(np.array(x, copy=True))
    port = splu_upd.chain_plain(*map(t, (Lt, l3, U12, u3, v, h)), 0.05, t(g))
    tol = dict(rtol=2e-5, atol=1e-5)
    for k in range(4):
        np.testing.assert_allclose(with_g[k], np.asarray(want[k]), **tol)
        np.testing.assert_allclose(with_g[k], port[k].numpy(), **tol)
        np.testing.assert_array_equal(without_g[k], with_g[k])
    np.testing.assert_allclose(pre, np.asarray(want[4]), **tol)
    np.testing.assert_allclose(pre, port[4].numpy(), **tol)


def test_sharded_splu_balance_leaves_the_padding_out():
    """The tail maxima of the balance are taken over the real lanes alone."""
    l3 = torch.tensor([0.5, 0.25, 1.0, 1.0])
    Lt = torch.zeros(1, 5)
    _, maxs = splu_upd.stage1_plain(Lt, l3, Lt, l3, torch.ones(5), torch.ones(5), nvalid=2)
    assert maxs.tolist() == [0.5, 0.5]
    _, maxs = splu_upd.stage1_plain(Lt, l3, Lt, l3, torch.ones(5), torch.ones(5), nvalid=0)
    assert maxs.tolist() == [-np.inf, -np.inf]


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_splu_stream_state_matches_jax(cases, jmesh, S):
    """A JAX stream-layout state under the sharding context takes the
    legacy path on its logical views (`groups/splu.py:223-262`); the port,
    which keeps one layout, updates those views through the sharded K16."""
    n, r = SPLU_SIZES[1]
    Lt, l3, U12, u3, v, h, g = cases["splu"][(n, r)]
    stream = jsplu._pack_stream(n, jnp.asarray(Lt[:, :r]), jnp.asarray(U12[:, :r]),
                                jnp.asarray(Lt[:, r:]), jnp.asarray(U12[:, r:]),
                                jnp.asarray(l3), jnp.asarray(u3))
    with jpallas.sharding(jmesh):
        new, pre = jax.jit(lambda st: jsplu.update_apply(st, jnp.asarray(v), jnp.asarray(h),
                                                         jnp.asarray(g), step=0.05))(stream)
    state = interop.splu_state(*(np.asarray(x) for x in (stream.Lt, stream.l3, stream.U12,
                                                         stream.u3)), device="cpu")
    assert [np.array_equal(np.asarray(a), b) for a, b in
            zip((state.Lt, state.l3, state.U12, state.u3), (Lt, l3, U12, u3))] == [True] * 4
    with_g, got_pre, _ = _same_on_every_rank(cases["outs"], ("splu", S, (n, r)))
    tol = dict(rtol=2e-5, atol=1e-5)
    for a, b in zip(with_g, (new.Lt, new.l3, new.U12, new.u3)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)
    np.testing.assert_allclose(got_pre, np.asarray(pre), **tol)


# ------------------------------------------------------------------ parallel/

@pytest.mark.parametrize("S", SHARDS)
def test_ring_reduce_matches_psum(cases, S):
    """overlap.ring_reduce / ring_max against the all-reduce: exact, since
    the ring folds the ranks' values in rank order."""
    for o in cases["outs"]:
        d_sum, d_max = o[("ring", S)]
        assert np.abs(d_sum).max() <= 1e-5 * 32 * S and np.abs(d_max).max() == 0.0


def test_mesh_layout_and_validation(cases):
    """Ranks lie on the mesh as JAX lays devices; a mesh larger than the
    job raises (`tests/test_parallel.py:264`)."""
    outs = cases["outs"]
    assert all("needs" in o["mesh_error"] for o in outs)
    for S in SHARDS:
        assert [o[("layout", S)] for o in outs] == [(k // S, k % S, "gloo") for k in range(WORLD)]
    with pytest.raises(ValueError):
        jmake_mesh(data=5, shard=3)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name", ["dense", "diag", "lra", "splu", "xmat", "xmat_odd", "shift",
                                  "shift_odd", "kron"])
def test_shard_gather_round_trip_is_exact(cases, S, name):
    """A full state from numpy, to each rank's slice (`interop.local_state`,
    padded) and back (`interop.global_arrays`, trimmed), is every family's
    state exactly (`tests/test_parallel.py:255`)."""
    arrays, _ = cases["states"][name]
    got = _same_on_every_rank(cases["outs"], ("roundtrip", S, name))
    if name == "kron":
        for (ql, qr, fmt), (a, b, f) in zip(got, arrays, strict=True):
            assert fmt == f and np.array_equal(ql, a) and np.array_equal(qr, b)
        return
    want = [np.asarray(a) for a in arrays if not isinstance(a, bool)]
    assert len(got) == len(want)
    for a, b in zip(got.values(), want):
        np.testing.assert_array_equal(a, b)


def test_state_sharding_structure():
    """The placement specs of JAX's `state_sharding` (`tests/test_parallel.py:255-261`)."""
    from psgd_tf_tpu_torch import PSGD

    opt = PSGD(preconditioner="lra", rank=2)
    state = opt.init([torch.zeros(10)], seed=0)
    sh = policies.state_sharding(None, state)
    assert sh.precond.UV == tuple(P(None, "shard")) and sh.precond.d == tuple(P("shard"))
    assert sh.hyper == tuple(P())
    with pytest.raises(TypeError):
        policies.precond_sharding(None, object())


# ------------------------------------------------------------------ comm_model

FAMILIES = ["lra", "splu", "dense", "diag", "xmat", "shift", "kron"]


@pytest.mark.parametrize("family", FAMILIES)
def test_comm_model_matches_jax(family):
    for kw in [dict(n_params=12_424_273), dict(n_params=1021, rank=4, dtype_bytes=2)]:
        assert overlap.comm_model(family, **kw) == joverlap.comm_model(family, **kw)


def test_comm_model_tp_accounting_matches_jax():
    """The tensor-parallel accounting (`tests/test_parallel.py:357-401`):
    the port's copy, given plain tuples for the specs, gives JAX's numbers
    for JAX's PartitionSpecs, including the error for specs without a mesh."""
    shapes = [(24, 24)] * 6
    specs = [(None, "shard") if i % 2 == 0 else ("shard", None) for i in range(6)]
    jspecs = [P(*s) for s in specs]
    for mesh_shape in [{"data": 4, "shard": 2}, {"shard": 2}, {"data": 8}]:
        for ps, js in [(specs, jspecs), ([None] * 6, [None] * 6)]:
            got = overlap.comm_model("kron", rank=10, param_shapes=shapes, param_specs=ps,
                                     mesh_shape=mesh_shape)
            assert got == joverlap.comm_model("kron", rank=10, param_shapes=shapes,
                                              param_specs=js, mesh_shape=mesh_shape)
    odd = overlap.comm_model("kron", param_shapes=[(25, 24)], param_specs=[("shard", None)],
                             mesh_shape={"shard": 2})
    assert odd["dp_bytes_per_step"] == 2 * 13 * 24 * 4
    assert odd["tp_gather_bytes_per_step"] == 3 * 13 * 24 * 4
    with pytest.raises(ValueError, match="mesh_shape"):
        overlap.comm_model("kron", param_shapes=[(25, 24)], param_specs=[("shard", None)])
    with pytest.raises(ValueError, match="mesh_shape"):
        joverlap.comm_model("kron", param_shapes=[(25, 24)], param_specs=[P("shard", None)])
    with pytest.raises(ValueError):
        overlap.comm_model("kron")
    assert overlap.comm_model("kron", param_shapes=[(25, 24)], param_specs=[None])[
        "tp_gather_bytes_per_step"] == 0
