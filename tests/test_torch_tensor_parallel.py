"""Port parity for tensor-parallel parameters
(`parallel.build_sharded_step(param_specs=...)`): the three-layer MLP of
`tests/test_parallel.py:304-354` under kron and lra, the `kron-tp` dry-run
configuration (`__graft_entry__.py:157-172`), the NMT model at the test
widths with its embeddings and RNN weights split over `shard`, the
collective payload of one step against `overlap.comm_model`, and
`policies.shard_params`/`gather_params` round trips.

The port runs in spawned gloo ranks on the CPU (`torch_parallel_workers`),
every case of one world size in one spawn; the JAX package here on the
8-device virtual CPU mesh (its kernels in interpret mode), with the
probes and coins of its step recovered from the step's key and injected
into the port. Tolerances are `tests/test_parallel.py`'s for one to three
steps, 5e-4 for trajectories and 2e-3 for lra's (ROADMAP's parity
harness)."""
import tempfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import psgd_tf_tpu as jpsgd
import psgd_tf_tpu.hvp as jhvp
import torch_parallel_workers as workers
from psgd_tf_tpu.data import translation as jtranslation
from psgd_tf_tpu.models import nmt as jnmt
from psgd_tf_tpu.parallel import build_sharded_step as jbuild_sharded_step
from psgd_tf_tpu.parallel import make_mesh as jmake_mesh
from psgd_tf_tpu.parallel import overlap as joverlap
from psgd_tf_tpu_torch.models import nmt
from psgd_tf_tpu_torch.parallel import overlap

MESHES = [(2, 2), (1, 2)]
RANK = 4
# `tests/test_parallel.py:304-354`
MLP_SHAPES = [(16, 32), (32, 32), (32, 4)]
MLP_SPECS = [(None, "shard"), ("shard", None), None]
MLP_STEPS = 3
# `__graft_entry__.py:127-172`: six (24, 24) layers, col- and row-split in turn
DRY_SHAPES = [(24, 24)] * 6
DRY_SPECS = [(None, "shard") if i % 2 == 0 else ("shard", None) for i in range(6)]
DRY_STEPS = 20
# the NMT model at `tests/test_torch_parallel_step.py`'s widths, split as
# `chip_smoke.py` S4 splits the reference widths: the encoder embedding by
# rows, the encoder RNN, the decoder embedding and the decoder RNN by
# columns; attention and the fc replicate
JCFG = jnmt.Config(vocab_src=16, vocab_tgt=16, embed=8, units=16, attn=4)
NMT_SPECS = [("shard", None), (None, "shard"), None, None, (None, "shard"), (None, "shard"),
             None]
NMT_KW = dict(lr_params=0.01, lr_preconditioner=0.01, grad_clip_max_norm=1.0)
NMT_STEPS = 5
# shard_params/gather_params round trips, on (data, shard) = (2, 2) and
# (1, 4): 1-D, 2-D by rows and by columns, a LeNet5 conv kernel (HWIO,
# 5 x 5 x 6 -> 16) by output channels, and a replicated leaf
ROUNDTRIP = [("1d", (12,), ("shard",)), ("2d_rows", (8, 12), ("shard", None)),
             ("2d_cols", (8, 12), (None, "shard")),
             ("4d_conv_out", (5, 5, 6, 16), (None, None, None, "shard")),
             ("replicated", (7, 3), None)]
ROUNDTRIP_MESHES = [(2, 2), (1, 4)]


def _np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _jspecs(specs):
    return [None if s is None else P(*s) for s in specs]


def _draws(fam, key, jparams):
    """The probes and lra coins JAX's step draws from `key`."""
    _, k_probe, k_prec = jax.random.split(key, 3)
    if fam == "kron":
        return _np(jhvp.random_like(k_probe, jparams)), None
    shapes = [x.shape for x in jax.tree_util.tree_leaves(jparams)]
    v = np.asarray(jax.random.normal(k_probe, (sum(int(np.prod(s)) for s in shapes),)))
    probes = [p.reshape(s) for p, s in zip(np.split(v, np.cumsum([np.prod(s) for s in
                                                                   shapes])[:-1]), shapes)]
    k_bal, k_uv = jax.random.split(k_prec)
    return probes, (bool(jax.random.uniform(k_bal) < 0.01), bool(jax.random.uniform(k_uv) < 0.5))


def _case(fam, jopt, port_opt, loss, params, seed_key, batches, keys, specs):
    """The port's run (inputs and the JAX step's draws) and the JAX
    single-device trajectory over the same keys, computed later."""
    jstate = jopt.init(params, seed_key)
    run = dict(loss=loss, opt=port_opt, params=_np(params), specs=specs, batches=[],
               probes=[], coins=[])
    if fam == "lra":
        run["precond"] = ("lra", (np.asarray(jstate.precond.UV), np.asarray(jstate.precond.d)))
    for batch, k in zip(batches, keys):
        probes, coins = _draws(fam, k, params)
        run["batches"].append(tuple(np.asarray(b) for b in batch))
        run["probes"].append(probes)
        run["coins"].append(coins)
    return dict(run=run, jopt=jopt, jstate=jstate, jparams=params, batches=batches, keys=keys)


def _jax_single(c, loss):
    """(losses, params) of JAX's single-device step over the case's keys."""
    step = jax.jit(partial(c["jopt"].step, loss))
    p, s, losses = c["jparams"], c["jstate"], []
    for batch, k in zip(c["batches"], c["keys"]):
        p, s, aux = step(p, s, k, *batch)
        losses.append(float(aux["loss"]))
    return losses, _np(p)


def _jax_tp(c, loss, specs, mesh=(2, 4)):
    """(losses, params) of JAX's `build_sharded_step(param_specs=...)` on
    (data, shard) = `mesh`, (2, 4) as `tests/test_parallel.py:304-354` runs
    it."""
    step = jbuild_sharded_step(c["jopt"], loss, jmake_mesh(data=mesh[0], shard=mesh[1]),
                               c["jstate"], c["jparams"], donate=False,
                               param_specs=_jspecs(specs))
    p, s, losses = c["jparams"], c["jstate"], []
    for batch, k in zip(c["batches"], c["keys"]):
        p, s, aux = step(p, s, k, *batch)
        losses.append(float(aux["loss"]))
    return losses, _np(p)


def _mean_sq(ws, x):
    y = x
    for w in ws:
        y = jnp.tanh(y @ w)
    return jnp.mean(y**2)


def _sum_sq(ws, x):
    y = x
    for w in ws:
        y = jnp.tanh(y @ w)
    return jnp.mean(jnp.sum(y * y, axis=-1))


def _mlp_case(fam, specs=MLP_SPECS):
    key = jax.random.PRNGKey(7)
    params = [0.4 * jax.random.normal(jax.random.fold_in(key, i), s)
              for i, s in enumerate(MLP_SHAPES)]
    x = jax.random.normal(jax.random.fold_in(key, 9), (16, 16))
    kw = dict(lr_params=0.05, lr_preconditioner=0.05)
    if fam == "kron":
        jopt = jpsgd.PSGD(preconditioner="kron", kron_formats=[("dense", "dense")] * 3, **kw)
        port = dict(preconditioner="kron", kron_formats=[("dense", "dense")] * 3, **kw)
    else:
        jopt = jpsgd.PSGD(preconditioner="lra", rank=RANK, **kw)
        port = dict(preconditioner="lra", rank=RANK, **kw)
    return _case(fam, jopt, port, "mean_sq", params, jax.random.fold_in(key, 2),
                 [(x,)] * MLP_STEPS, [jax.random.fold_in(key, 100 + i) for i in range(MLP_STEPS)],
                 specs)


def _dry_case(fam, steps=DRY_STEPS):
    k_w, k_x = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 6))
    params = [0.5 * jax.random.normal(jax.random.fold_in(k_w, i), s)
              for i, s in enumerate(DRY_SHAPES)]
    x = jax.random.normal(k_x, (16, 24))
    kw = dict(lr_params=0.05, grad_clip_max_norm=1.0)
    if fam == "kron":
        extra = dict(preconditioner="kron", kron_formats=[("dense", "dense")] * 6,
                     kron_batched=False)
    else:
        extra = dict(preconditioner="lra", rank=RANK)
    return _case(fam, jpsgd.PSGD(**extra, **kw), dict(**extra, **kw), "mlp", params,
                 jax.random.PRNGKey(1), [(x,)] * steps,
                 [jax.random.fold_in(k_x, 100 + i) for i in range(steps)], DRY_SPECS)


def _nmt_case(fam, specs=NMT_SPECS):
    key = jax.random.PRNGKey(3)
    params = jnmt.init(key, JCFG)
    if fam == "kron":
        jopt = jpsgd.PSGD(preconditioner="kron", kron_formats=jnmt.kron_formats(JCFG), **NMT_KW)
        port = dict(preconditioner="kron", kron_formats=nmt.kron_formats(nmt.Config(*JCFG)),
                    **NMT_KW)
    else:
        jopt = jpsgd.PSGD(preconditioner="lra", rank=RANK, **NMT_KW)
        port = dict(preconditioner="lra", rank=RANK, **NMT_KW)
    batches = [jtranslation.batch(jax.random.fold_in(key, 200 + i), 16, 8, content_vocab=13)
               for i in range(NMT_STEPS)]
    return _case(fam, jopt, port, "nmt", params, jax.random.fold_in(key, 2), batches,
                 [jax.random.fold_in(key, 100 + i) for i in range(NMT_STEPS)], specs)


FAMS = ["kron", "lra"]
RUNS = [("mlp", f) for f in FAMS] + [("dry", "kron")] + [("nmt", f) for f in FAMS]


@pytest.fixture(scope="module")
def cases():
    """Every multi-rank run of this file, in one spawn per world size: the
    training runs on each mesh of MESHES; on (2, 2) also the payload of one
    step and the round trips on (2, 2) and (1, 4)."""
    build = {"mlp": _mlp_case, "dry": _dry_case, "nmt": _nmt_case}
    made = {(model, fam): build[model](fam) for model, fam in RUNS}
    runs = [made[r]["run"] for r in RUNS]
    payload = [_dry_case(fam, steps=1)["run"] for fam in FAMS]
    rng = np.random.default_rng(0)
    leaves = [(rng.standard_normal(shape).astype(np.float32), spec)
              for _, shape, spec in ROUNDTRIP]
    extra = {(2, 2): [(workers.job_tp_payload, (2, 2, payload)),
                      (workers.job_tp_roundtrip, (ROUNDTRIP_MESHES, leaves))],
             (1, 2): []}
    started = {(data, shard): workers.start(
        workers.job_many, data * shard, tempfile.mkdtemp(prefix="psgd_tp_"),
        [(workers.job_train, (data, shard, runs))] + extra[(data, shard)], timeout=240.0)
        for data, shard in MESHES}
    try:
        # the JAX references, while the ranks run
        loss = {"mlp": _mean_sq, "dry": _sum_sq, "nmt": jnmt.loss}
        single = {r: _jax_single(made[r], loss[r[0]]) for r in RUNS}
        tp = {("mlp", f): _jax_tp(made[("mlp", f)], _mean_sq, MLP_SPECS) for f in FAMS}
        outs, more = {}, {}
        for mesh in MESHES:
            res = workers.join(started.pop(mesh))
            outs[mesh] = [r[0] for r in res]
            more[mesh] = [r[1:] for r in res]
    finally:
        for handle in started.values():  # a job failed: stop the others' ranks too
            workers.stop(handle)
    return dict(single=single, tp=tp, outs=outs, payload=[m[0] for m in more[(2, 2)]],
                roundtrip=[m[1] for m in more[(2, 2)]], leaves=leaves)


def _got(cases, mesh, run):
    """The run's result on rank 0, after checking that every rank holds the
    same losses and gathered params (the ranks branched alike)."""
    k = RUNS.index(run)
    outs = cases["outs"][mesh]
    for o in outs[1:]:
        assert o[k]["losses"] == outs[0][k]["losses"]
        for a, b in zip(o[k]["params"], outs[0][k]["params"]):
            np.testing.assert_array_equal(a, b)
    return outs[0][k]


def _slices(shapes, specs, shard):
    out = []
    for s, spec in zip(shapes, specs):
        s = list(s)
        if spec is not None:
            s[list(spec).index("shard")] //= shard
        out.append(tuple(s))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("fam", FAMS)
def test_tensor_parallel_params_match_jax(cases, mesh, fam):
    """`tests/test_parallel.py:304-354`: the MLP with its first layer split
    by columns and its second by rows, 3 steps: the port's TP step against
    JAX's TP step on (data=2, shard=4) and JAX's single-device step, at
    that test's tolerances; the step returns the split leaves as slices."""
    got = _got(cases, mesh, ("mlp", fam))
    assert got["shapes"] == _slices(MLP_SHAPES, MLP_SPECS, mesh[1]) == [(16, 16), (16, 32),
                                                                        (32, 4)]
    for losses, params in (cases["tp"][("mlp", fam)], cases["single"][("mlp", fam)]):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for a, b in zip(got["params"], params):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_kron_tp_dryrun_trajectory_matches_jax(cases, mesh):
    """`__graft_entry__.py:157-172`'s `kron-tp`: six (24, 24) (dense,
    dense) layers, col- and row-split in turn, `kron_batched=False`, 20
    steps, against JAX's single-device trajectory at 5e-4."""
    got = _got(cases, mesh, ("dry", "kron"))
    losses, params = cases["single"][("dry", "kron")]
    assert got["shapes"] == _slices(DRY_SHAPES, DRY_SPECS, mesh[1])
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], losses, rtol=5e-4)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("fam", FAMS)
def test_nmt_tensor_parallel_matches_jax(cases, mesh, fam):
    """The NMT model at the test widths with its embeddings and RNN weights
    split over `shard`, under kron (the hand formats) and lra (rank 4), 5
    steps, against JAX's single-device trajectory: 5e-4, 2e-3 for lra."""
    got = _got(cases, mesh, ("nmt", fam))
    losses, params = cases["single"][("nmt", fam)]
    assert got["shapes"] == _slices(jnmt.layer_shapes(JCFG), NMT_SPECS, mesh[1])
    tol = 2e-3 if fam == "lra" else 5e-4
    np.testing.assert_allclose(got["losses"], losses, rtol=tol)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol if fam == "lra" else 5e-5)


@pytest.mark.parametrize("fam", FAMS)
def test_tp_step_payload_matches_comm_model(cases, fam):
    """One TP step of the `kron-tp` layout on (2, 2): the elements each rank
    all-reduces over `data` (the loss aside) and receives in the gathers
    over `shard` (parameters, gradients and Hvps: three a split leaf) are
    `comm_model`'s `dp_bytes_per_step` and `tp_gather_bytes_per_step`, in
    the JAX package and in the port's copy."""
    k = FAMS.index(fam)
    mesh_shape = {"data": 2, "shard": 2}
    for model in (joverlap.comm_model(fam, rank=RANK, param_shapes=DRY_SHAPES,
                                      param_specs=_jspecs(DRY_SPECS), mesh_shape=mesh_shape),
                  overlap.comm_model(fam, rank=RANK, param_shapes=DRY_SHAPES,
                                     param_specs=DRY_SPECS, mesh_shape=mesh_shape)):
        for moved in cases["payload"]:
            assert 4 * moved[k]["data"] == model["dp_bytes_per_step"] == 2 * 6 * 288 * 4
            assert 4 * moved[k]["shard"] == model["tp_gather_bytes_per_step"] == 3 * 6 * 288 * 4


@pytest.mark.parametrize("mesh", ROUNDTRIP_MESHES, ids=str)
@pytest.mark.parametrize("case", [c[0] for c in ROUNDTRIP])
def test_shard_params_gather_params_roundtrip(cases, mesh, case):
    """`shard_params` gives each rank its slice of a split leaf along the
    spec's axis, `gather_params` joins the slices back (all the leaves in
    one gather), and a replicated leaf passes through as the same tensor."""
    i = [c[0] for c in ROUNDTRIP].index(case)
    full, spec = cases["leaves"][i]
    for res in cases["roundtrip"]:
        r = res[mesh]
        np.testing.assert_array_equal(r["full"][i], full)
        assert r["same"][i]
        if spec is None:
            np.testing.assert_array_equal(r["local"][i], full)
            continue
        ax = list(spec).index("shard")
        want = np.split(full, mesh[1], axis=ax)[r["shard_rank"]]
        np.testing.assert_array_equal(r["local"][i], want)
