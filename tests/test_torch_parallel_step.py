"""Port parity for the sharded training step (`parallel.build_sharded_step`):
the NMT model under lra and kron on meshes (2, 2) and (1, 2), a 20-step lra
trajectory, the replicated kron and dense paths, the routing of lra and
splu to their sharded wrappers, a stream-layout splu state, and
`nmt_attention.run(mesh=...)`.

The port runs in spawned gloo ranks on the CPU (`torch_parallel_workers`);
the JAX package here on the 8-device virtual CPU mesh (its kernels in
interpret mode), with the probes and coins of its step recovered from the
step's key and injected into the port. Tolerances are
`tests/test_parallel.py`'s, and 2e-3 for the 20-step lra trajectory
(ROADMAP's parity harness)."""
import tempfile
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psgd_tf_tpu as jpsgd
import psgd_tf_tpu.hvp as jhvp
import torch_parallel_workers as workers
from psgd_tf_tpu.data import translation as jtranslation
from psgd_tf_tpu.groups import dense as jdense
from psgd_tf_tpu.groups.splu import SpLUStreamState
from psgd_tf_tpu.models import nmt as jnmt
from psgd_tf_tpu.ops.pallas import dense_upd as jdense_upd
from psgd_tf_tpu.ops.pallas import splu_one as jsplu_one
from psgd_tf_tpu.parallel import build_sharded_step as jbuild_sharded_step
from psgd_tf_tpu.parallel import make_mesh as jmake_mesh
from psgd_tf_tpu_torch import PSGD, interop
from psgd_tf_tpu_torch.models import nmt

torch.set_num_threads(1)

JCFG = jnmt.Config(vocab_src=16, vocab_tgt=16, embed=8, units=16, attn=4)
RANK = 4
KW = dict(lr_params=0.01, lr_preconditioner=0.01, grad_clip_max_norm=1.0)
TRAJ_STEPS = 20
NMT_STEPS = 20
MESHES = [(2, 2), (1, 2)]


def _np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _draws(fam, key, jparams):
    """The probes and lra coins JAX's step draws from `key`."""
    _, k_probe, k_prec = jax.random.split(key, 3)
    if fam == "kron":
        return _np(jhvp.random_like(k_probe, jparams)), None
    n = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    v = np.asarray(jax.random.normal(k_probe, (n,), jnp.float32))
    shapes = [x.shape for x in jax.tree_util.tree_leaves(jparams)]
    probes = [p.reshape(s) for p, s in zip(np.split(v, np.cumsum([np.prod(s) for s in
                                                                   shapes])[:-1]), shapes)]
    k_bal, k_uv = jax.random.split(k_prec)
    return probes, (bool(jax.random.uniform(k_bal) < 0.01), bool(jax.random.uniform(k_uv) < 0.5))


def _jopt(fam, **extra):
    if fam == "kron":
        return jpsgd.PSGD(preconditioner="kron", kron_formats=jnmt.kron_formats(JCFG), **KW,
                          **extra)
    return jpsgd.PSGD(preconditioner=fam, rank=RANK, **KW, **extra)


def _port_opt(fam):
    if fam == "kron":
        return dict(preconditioner="kron", kron_formats=nmt.kron_formats(nmt.Config(*JCFG)), **KW)
    return dict(preconditioner=fam, rank=RANK, **KW)


def _one_step_case(fam):
    key = jax.random.PRNGKey(0)
    jparams = jnmt.init(key, JCFG)
    src, tgt = jtranslation.batch(jax.random.fold_in(key, 1), 16, 8, content_vocab=13)
    jopt = _jopt(fam)
    jstate = jopt.init(jparams, jax.random.fold_in(key, 2))
    k_step = jax.random.fold_in(key, 3)
    probes, coins = _draws(fam, k_step, jparams)
    run = dict(loss="nmt", opt=_port_opt(fam), params=_np(jparams),
               batches=[(np.asarray(src), np.asarray(tgt))], probes=[probes], coins=[coins])
    if fam == "lra":
        run["precond"] = ("lra", (np.asarray(jstate.precond.UV), np.asarray(jstate.precond.d)))
    return dict(run=run, jparams=jparams, jstate=jstate, jopt=jopt, key=k_step, src=src, tgt=tgt)


def _trajectory_case():
    key = jax.random.PRNGKey(1)
    jparams = jnmt.init(key, JCFG)
    jopt = _jopt("lra")
    jstate = jopt.init(jparams, jax.random.fold_in(key, 2))
    run = dict(loss="nmt", opt=_port_opt("lra"), params=_np(jparams), batches=[], probes=[],
               coins=[], precond=("lra", (np.asarray(jstate.precond.UV),
                                          np.asarray(jstate.precond.d))))
    jstep = jax.jit(partial(jopt.step, jnmt.loss))
    losses = []
    for i in range(TRAJ_STEPS):
        src, tgt = jtranslation.batch(jax.random.fold_in(key, 200 + i), 16, 8, content_vocab=13)
        k = jax.random.fold_in(key, 100 + i)
        probes, coins = _draws("lra", k, jparams)
        run["batches"].append((np.asarray(src), np.asarray(tgt)))
        run["probes"].append(probes)
        run["coins"].append(coins)
        jparams, jstate, aux = jstep(jparams, jstate, k, src, tgt)
        losses.append(float(aux["loss"]))
    return dict(run=run, losses=losses, params=_np(jparams),
                precond=(np.asarray(jstate.precond.UV), np.asarray(jstate.precond.d)))


def _mlp_case():
    """`tests/test_parallel.py:105-141`: three (dense, dense) layers below
    the batching crossover, one K1 list, replicated."""
    key = jax.random.PRNGKey(5)
    shapes = [(9, 12), (12, 7), (7, 3)]
    jparams = [0.4 * jax.random.normal(jax.random.fold_in(key, i), s) for i, s in enumerate(shapes)]
    x = jax.random.normal(jax.random.fold_in(key, 9), (16, 9))

    def loss(ws, x):
        y = x
        for w in ws:
            y = jnp.tanh(y @ w)
        return jnp.mean(jnp.sum(y * y, axis=-1))

    hyper = dict(preconditioner="kron", lr_params=0.05, lr_preconditioner=0.05,
                 grad_clip_max_norm=1.0, kron_batch_min=99)
    jopt = jpsgd.PSGD(**hyper)
    jstate = jopt.init(jparams, jax.random.fold_in(key, 2))
    k = jax.random.fold_in(key, 3)
    probes, _ = _draws("kron", k, jparams)
    jp, _, aux = jax.jit(partial(jopt.step, loss))(jparams, jstate, k, x)
    run = dict(loss="mlp", opt=hyper, params=_np(jparams), batches=[(np.asarray(x),)],
               probes=[probes], coins=[None])
    return dict(run=run, loss=float(aux["loss"]), params=_np(jp))


def _stream_splu_case():
    """`tests/test_parallel.py:404-444`: a stream-layout splu state; the
    port holds its logical views."""
    params = [0.3 * jax.random.normal(jax.random.PRNGKey(0), (40, 24))]

    def loss(ws, x):
        y = jnp.tanh(x @ ws[0].T)
        return jnp.mean(jnp.sum(y * y, axis=-1))

    jopt = jpsgd.PSGD(preconditioner="splu", rank=4, lr_params=0.05, grad_clip_max_norm=1.0)
    with mock.patch.object(jsplu_one, "fits", lambda r, n: False):
        jstate = jopt.init(params, jax.random.PRNGKey(1))
    assert isinstance(jstate.precond, SpLUStreamState)
    x = jax.random.normal(jax.random.PRNGKey(2), (8, 24))
    pre = jstate.precond
    run = dict(loss="row", opt=dict(preconditioner="splu", rank=4, lr_params=0.05,
                                    grad_clip_max_norm=1.0),
               params=_np(params), batches=[], probes=[], coins=[],
               precond=("splu", tuple(np.asarray(a) for a in (pre.Lt, pre.l3, pre.U12, pre.u3))))
    single = jax.jit(partial(jopt.step, loss))
    p, s = params, jstate
    for i in range(3):
        k = jax.random.PRNGKey(10 + i)
        probes, _ = _draws("splu", k, p)
        run["batches"].append((np.asarray(x),))
        run["probes"].append(probes)
        run["coins"].append(None)
        p, s, aux = single(p, s, k, x)
    return dict(run=run, params=_np(p))


def _linear_lra_case():
    """`tests/test_parallel.py:224-252`: the sharding context routes the
    optimizer's with-update branch to K14's update + apply."""
    key = jax.random.PRNGKey(0)
    w = np.asarray(jax.random.normal(key, (40,)))
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 2), (16, 40)))
    rng = np.random.default_rng(0)
    return dict(loss="linear", opt=dict(preconditioner="lra", rank=3, lr_params=0.05),
                params=[w], batches=[(x,)], probes=[[rng.standard_normal(40).astype(np.float32)]],
                coins=[(False, True)])


def _dense_over_cap_case():
    """`tests/test_parallel.py:269-300`: dense past dense_upd.MAX_N."""
    n = jdense_upd.MAX_N + 64
    key = jax.random.PRNGKey(11)
    state = jdense.init(n, init_scale=0.1)
    v, h, g = (jax.random.normal(jax.random.fold_in(key, i), (n,)) for i in (1, 2, 3))
    ref_st, ref_out = jax.jit(lambda st: jdense.update_apply(st, v, h, g, step=0.05))(state)
    return dict(args=tuple(_np([state.Q, v, h, g])), Q=np.asarray(ref_st.Q),
                pre=np.asarray(ref_out))


@pytest.fixture(scope="module")
def cases():
    """Every multi-rank run of this file, in one spawn per world size: the
    training runs on each mesh; on (2, 2) also the NMT workload; on (1, 2)
    also dense over its cap and the refusals."""
    one = {fam: _one_step_case(fam) for fam in ("lra", "kron")}
    traj = _trajectory_case()
    mlp, stream = _mlp_case(), _stream_splu_case()
    lin = _linear_lra_case()
    dense = _dense_over_cap_case()
    runs = [one["lra"]["run"], one["kron"]["run"], traj["run"], mlp["run"], stream["run"], lin]
    extra = {(2, 2): [(workers.job_nmt_run, (2, 2, NMT_STEPS))],
             (1, 2): [(workers.job_dense_over_cap, dense["args"]), (workers.job_errors, ())]}
    started = {(data, shard): workers.start(
        workers.job_many, data * shard, tempfile.mkdtemp(prefix="psgd_dist_"),
        [(workers.job_train, (data, shard, runs))] + extra[(data, shard)])
        for data, shard in MESHES}
    outs, more = {}, {}
    try:
        for mesh, handle in list(started.items()):
            res = workers.join(started.pop(mesh))
            outs[mesh] = [r[0] for r in res]
            more[mesh] = [r[1:] for r in res]
    finally:
        for handle in started.values():  # a job failed: stop the others' ranks too
            workers.stop(handle)
    return dict(one=one, traj=traj, mlp=mlp, stream=stream, dense=dense, outs=outs, memo={},
                nmt_run=[m[0] for m in more[(2, 2)]],
                dense_over_cap=[m[0] for m in more[(1, 2)]],
                errors=[m[1] for m in more[(1, 2)]])


def _ranks_agree(outs, k):
    """Every rank holds the same parameters: the ranks branched alike."""
    for o in outs[1:]:
        for a, b in zip(o[k]["params"], outs[0][k]["params"]):
            np.testing.assert_array_equal(a, b)
        assert o[k]["losses"] == outs[0][k]["losses"]
    return outs[0][k]


def _once(cases, key, compute):
    """compute(), once per module for each key: the references of a case
    are the same for every mesh of the port."""
    if key not in cases["memo"]:
        cases["memo"][key] = compute()
    return cases["memo"][key]


def _port_unsharded(run):
    """The same run through the port's plain `PSGD.step` in this process."""
    from psgd_tf_tpu_torch.models import nmt as tnmt

    losses_fn = {"nmt": tnmt.loss, "mlp": workers.mlp_loss, "row": workers.row_loss,
                 "linear": workers.linear_loss}[run["loss"]]
    params = interop.tensors(run["params"], device="cpu")
    opt = PSGD(**run["opt"])
    state = opt.init(params)
    if "precond" in run:
        state = state.replace(precond=workers._build_state(*run["precond"]))
    losses = []
    for batch, probes, coins in zip(run["batches"], run["probes"], run["coins"]):
        batch = [torch.from_numpy(np.array(b)).long() if b.dtype.kind == "i" else
                 torch.from_numpy(np.array(b)) for b in batch]
        params, state, aux = opt.step(losses_fn, params, state, None, *batch,
                                      probes=interop.tensors(probes, device="cpu"), coins=coins)
        losses.append(aux["loss"].item())
    return losses, [p.numpy() for p in params]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("fam", ["lra", "kron"])
def test_sharded_step_matches_jax(cases, mesh, fam):
    """One step of the NMT model at the toy widths, batch 16, under lra
    (rank 4) and kron: the port's sharded step against JAX's sharded step
    on (data=2, shard=4) and the port's unsharded step
    (`tests/test_parallel.py:75-102`)."""
    c = cases["one"][fam]
    got = _ranks_agree(cases["outs"][mesh], ["lra", "kron"].index(fam))

    def jax_step():
        step = jbuild_sharded_step(c["jopt"], jnmt.loss, jmake_mesh(data=2, shard=4),
                                   c["jstate"], c["jparams"], donate=False)
        return step(c["jparams"], c["jstate"], c["key"], c["src"], c["tgt"])

    jp, _, jaux = _once(cases, ("jax", fam), jax_step)
    assert got["losses"][0] == pytest.approx(float(jaux["loss"]), rel=1e-5)
    losses, params = _once(cases, ("port", fam), lambda: _port_unsharded(c["run"]))
    assert got["losses"][0] == pytest.approx(losses[0], rel=1e-5)
    for a, b, p in zip(got["params"], _np(jp), params):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(a, p, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharded_lra_trajectory_matches_jax(cases, mesh):
    """20 lra steps of the NMT model: the port's sharded step against the
    JAX step (whose sharded step `tests/test_parallel.py` holds to it) and
    the port's unsharded step, at 2e-3; the state gathered back too."""
    t = cases["traj"]
    got = _ranks_agree(cases["outs"][mesh], 2)
    np.testing.assert_allclose(got["losses"], t["losses"], rtol=2e-3)
    for a, b in zip(got["params"], t["params"]):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["precond"]["UV"], t["precond"][0], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["precond"]["d"], t["precond"][1], rtol=2e-3, atol=2e-3)
    losses, params = _once(cases, ("port", "traj"), lambda: _port_unsharded(t["run"]))
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-3)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharded_kron_multi_step_matches_jax(cases, mesh):
    """Three (dense, dense) layers through one K1 list, replicated
    (`tests/test_parallel.py:105-141`)."""
    got = _ranks_agree(cases["outs"][mesh], 3)
    assert got["losses"][0] == pytest.approx(cases["mlp"]["loss"], rel=1e-5)
    for a, b in zip(got["params"], cases["mlp"]["params"]):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharded_step_with_stream_splu_state(cases, mesh):
    """A JAX stream-layout splu state's logical views, three sharded steps
    (the sharded K16's chain, one call a step), against the JAX
    single-device step (`tests/test_parallel.py:404-444`)."""
    got = _ranks_agree(cases["outs"][mesh], 4)
    assert got["calls"]["splu_sharded"] == 3
    rel = max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))
              for a, b in zip(got["params"], cases["stream"]["params"]))
    assert np.isfinite(got["losses"][-1]) and rel < 1e-4, rel


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharding_ctx_routes_to_the_sharded_wrappers(cases, mesh):
    """Under the sharding context lra's with-update branch calls K14's
    update + apply, and splu the sharded K16, once a step; the unsharded
    paths stay untouched (`tests/test_parallel.py:224-252`)."""
    outs = cases["outs"][mesh]
    lin, one_lra, one_kron = outs[0][5], outs[0][0], outs[0][1]
    assert lin["calls"] == {"lra_sharded": 1, "splu_sharded": 0} and np.isfinite(lin["losses"][0])
    assert one_lra["calls"]["lra_sharded"] == 1
    assert one_kron["calls"] == {"lra_sharded": 0, "splu_sharded": 0}
    assert all(c == 0 for c in lin["counts"].values())  # the CPU launches no kernel


def test_sharded_dense_over_cap_matches_jax(cases):
    """dense past dense_upd.MAX_N replicates under the sharding context
    (`tests/test_parallel.py:269-300`)."""
    ref = cases["dense"]
    for q, pre in cases["dense_over_cap"]:
        np.testing.assert_allclose(q, ref["Q"], rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(pre, ref["pre"], rtol=2e-5, atol=1e-4)


def test_nmt_attention_run_with_a_mesh_matches_run(cases):
    """`nmt_attention.run(mesh=...)` (batch over `data`, kron replicated),
    20 steps, against `run()` without a mesh."""
    outs = cases["nmt_run"]
    plain = outs[0][1]
    for sharded, _ in outs:
        assert sharded["steps"] == plain["steps"] == NMT_STEPS
        for k in ("loss", "first_loss", "token_accuracy"):
            assert sharded[k] == pytest.approx(plain[k], rel=5e-4, abs=5e-4)
        assert sharded == outs[0][0]


def test_build_sharded_step_refusals(cases):
    """Tensor-parallel `param_specs` are not ported and say so; a batch
    that `data` does not divide raises."""
    for out in cases["errors"]:
        assert "tensor-parallel" in out["param_specs"] and "ROADMAP" in out["param_specs"]
        assert "divisible by data=2" in out["batch"]
