"""Port parity for tensor-parallel parameters split over `data`, alone or
with `shard` (`parallel.build_sharded_step(param_specs=...)` with specs that
name `data`): the three-layer MLP of `tests/test_parallel.py:304-354` under
kron and lra with two spec lists on (data, shard) = (2, 2) and the
`data`-only list on (2, 1) and (4, 1); the NMT model at the test widths with
every spec form of `chip_smoke.py` S5 on (2, 2); one step's payload by axis;
`shard_params`/`gather_params` round trips against the blocks JAX places on
each device; `overlap.comm_model` against the JAX package's.

Each case holds the port's gloo ranks on the CPU (`torch_parallel_workers`)
against JAX's `build_sharded_step` on a `make_mesh` of the same (data,
shard) on the 8-device virtual CPU mesh (its kernels in interpret mode) and
against JAX's single-device step, with the probes and coins of JAX's step
injected into the port. Tolerances are `tests/test_parallel.py`'s for the
three MLP steps (loss 1e-5 relative, parameters rtol 5e-4 and atol 5e-5), and
5e-4 for the NMT's five-step trajectories, 2e-3 under lra."""
import tempfile

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as workers
from psgd_tf_tpu.models import nmt as jnmt
from psgd_tf_tpu.parallel import make_mesh as jmake_mesh
from psgd_tf_tpu.parallel import overlap as joverlap
from psgd_tf_tpu_torch.parallel import overlap
from test_torch_tensor_parallel import (JCFG, MLP_SHAPES, _jax_single, _jax_tp, _jspecs,
                                        _mean_sq, _mlp_case, _nmt_case)

RANK = 4
# the Motivation's two spec lists of the MLP: `data` alone; both axes, on
# one dimension in both orders and on two dimensions
DATA_ONLY = [("data", None), (None, "data"), None]
BOTH = [(("data", "shard"), None), ("data", "shard"), (("shard", "data"), None)]
MLP_RUNS = [((2, 2), "data_only", DATA_ONLY), ((2, 2), "both", BOTH),
            ((2, 1), "data_only", DATA_ONLY), ((4, 1), "data_only", DATA_ONLY)]
# S5's specs at the test widths (the layer order of `models/nmt.py`: encoder
# embedding, encoder RNN, attention in and out, decoder embedding, decoder
# RNN, fc)
NMT_SPECS = [("data", "shard"), (None, ("data", "shard")), ("data", None), None,
             (None, ("shard", "data")), (None, "data"), None]
FAMS = ["kron", "lra"]
# round trips on (2, 2), (4, 1) and (1, 4): each spec form, a LeNet5 conv
# kernel (HWIO) split over `data` by output channels, and a replicated leaf
ROUNDTRIP = [("data_1d", (12,), ("data",)), ("tuple_ds", (8, 12), (("data", "shard"), None)),
             ("tuple_sd", (8, 12), (("shard", "data"), None)),
             ("two_dims", (8, 12), ("data", "shard")),
             ("conv_out_data", (5, 5, 6, 16), (None, None, None, "data")),
             ("replicated", (7, 3), None)]
ROUNDTRIP_MESHES = [(2, 2), (4, 1), (1, 4)]


def _shape(shape, spec, mesh):
    """The block shape of a leaf under `spec` on (data, shard) = `mesh`."""
    deg = {"data": mesh[0], "shard": mesh[1]}
    out = list(shape)
    for k, entry in enumerate(spec or ()):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            out[k] //= deg[a]
    return tuple(out)


@pytest.fixture(scope="module")
def cases():
    """Every multi-rank run of this file: one spawn of four ranks (the
    training on (2, 2) and (4, 1), the payload on (2, 2), the round trips)
    and one of two ranks (the training on (2, 1)), side by side."""
    mlp = {(mesh, name, fam): _mlp_case(fam, specs) for mesh, name, specs in MLP_RUNS
           for fam in FAMS}
    nmt = {fam: _nmt_case(fam, NMT_SPECS) for fam in FAMS}
    rng = np.random.default_rng(1)
    leaves = [(rng.standard_normal(shape).astype(np.float32), spec)
              for _, shape, spec in ROUNDTRIP]

    def runs(mesh):
        return [mlp[(m, name, fam)]["run"] for m, name, _ in MLP_RUNS if m == mesh
                for fam in FAMS]

    jobs = {4: [(workers.job_train, (2, 2, runs((2, 2)) + [nmt[f]["run"] for f in FAMS])),
                (workers.job_train, (4, 1, runs((4, 1)))),
                (workers.job_tp_payload, (2, 2, [nmt[f]["run"] for f in FAMS])),
                (workers.job_tp_roundtrip, (ROUNDTRIP_MESHES, leaves))],
            2: [(workers.job_train, (2, 1, runs((2, 1))))]}
    started = {world: workers.start(workers.job_many, world,
                                    tempfile.mkdtemp(prefix="psgd_dsplit_"), js, timeout=300.0)
               for world, js in jobs.items()}
    try:
        # the JAX references, while the ranks run
        single = {fam: _jax_single(mlp[((2, 2), "data_only", fam)], _mean_sq) for fam in FAMS}
        single.update({("nmt", fam): _jax_single(nmt[fam], jnmt.loss) for fam in FAMS})
        specs = {(m, n): s for m, n, s in MLP_RUNS}
        tp = {key: _jax_tp(c, _mean_sq, specs[key[:2]], mesh=key[0]) for key, c in mlp.items()}
        tp.update({("nmt", fam): _jax_tp(nmt[fam], jnmt.loss, NMT_SPECS, mesh=(2, 2))
                   for fam in FAMS})
        placed = {mesh: _jax_blocks(leaves, mesh) for mesh in ROUNDTRIP_MESHES}
        res = {world: workers.join(started.pop(world)) for world in list(started)}
    finally:
        for handle in started.values():  # a job failed: stop the others' ranks too
            workers.stop(handle)
    four, two = res[4], res[2]
    return dict(single=single, tp=tp, placed=placed, leaves=leaves,
                train={(2, 2): [r[0] for r in four], (4, 1): [r[1] for r in four],
                       (2, 1): [r[0] for r in two]},
                payload=[r[2] for r in four], roundtrip=[r[3] for r in four])


def _jax_blocks(leaves, mesh):
    """{(d, s): [the block of each leaf JAX places on the device at mesh
    coordinate (d, s)]} under `NamedSharding(make_mesh(*mesh), P(*spec))`."""
    jmesh = jmake_mesh(data=mesh[0], shard=mesh[1])
    where = {dev.id: (d, s) for (d, s), dev in np.ndenumerate(jmesh.devices)}
    out = {}
    for x, spec in leaves:
        arr = jax.device_put(x, NamedSharding(jmesh, P() if spec is None else P(*spec)))
        for sh in arr.addressable_shards:
            out.setdefault(where[sh.device.id], []).append(np.asarray(sh.data))
    return out


def _rank0(outs, k):
    """Run k's result on rank 0, after checking that every rank holds the
    same losses and gathered params."""
    for o in outs[1:]:
        assert o[k]["losses"] == outs[0][k]["losses"]
        for a, b in zip(o[k]["params"], outs[0][k]["params"]):
            np.testing.assert_array_equal(a, b)
    return outs[0][k]


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("mesh,name,specs", MLP_RUNS, ids=[f"{m}-{n}" for m, n, _ in MLP_RUNS])
def test_mlp_data_split_matches_jax(cases, mesh, name, specs, fam):
    """The MLP, 3 steps, with its leaves split over `data` (and `shard`):
    the port's step against JAX's sharded step on the same mesh and JAX's
    single-device step at `tests/test_parallel.py`'s tolerances; every rank
    returns its block of each split leaf."""
    outs = cases["train"][mesh]
    k = [(n, f) for m, n, _ in MLP_RUNS if m == mesh for f in FAMS].index((name, fam))
    got = _rank0(outs, k)
    assert all(o[k]["shapes"] == [_shape(s, sp, mesh) for s, sp in zip(MLP_SHAPES, specs)]
               for o in outs)
    for losses, params in (cases["tp"][(mesh, name, fam)], cases["single"][fam]):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for a, b in zip(got["params"], params):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("fam", FAMS)
def test_nmt_data_split_matches_jax(cases, fam):
    """The NMT model at the test widths with S5's spec forms on (2, 2), 5
    steps under kron (the hand formats) and lra (rank 4): against JAX's
    sharded step on (2, 2) and its single-device step, 5e-4 (2e-3 under
    lra); every rank returns its blocks."""
    outs = cases["train"][(2, 2)]
    k = len([m for m, _, _ in MLP_RUNS if m == (2, 2)]) * len(FAMS) + FAMS.index(fam)
    got = _rank0(outs, k)
    shapes = jnmt.layer_shapes(JCFG)
    assert all(o[k]["shapes"] == [_shape(s, sp, (2, 2)) for s, sp in zip(shapes, NMT_SPECS)]
               for o in outs)
    tol = 2e-3 if fam == "lra" else 5e-4
    for losses, params in (cases["tp"][("nmt", fam)], cases["single"][("nmt", fam)]):
        np.testing.assert_allclose(got["losses"], losses, rtol=tol)
        for a, b in zip(got["params"], params):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol if fam == "lra" else 5e-5)


@pytest.mark.parametrize("fam", FAMS)
def test_data_split_payload(cases, fam):
    """One step of the NMT case on (2, 2), by axis, against the arithmetic
    of the port's collectives: the all-reduce over `data` carries of each
    gradient and Hvp the part its data group holds (the block times the
    `data` degree of a leaf split over `data`); the gathers over `shard`
    receive (shard - 1) such parts of each leaf that names `shard` for the
    gradient and the Hvp and (shard - 1) blocks for the parameter; the
    gather over `data` receives the parameters' remaining (data - 1)
    parts. The parameters' gathers move what `comm_model` charges one of
    its three gathers."""
    shapes = jnmt.layer_shapes(JCFG)
    blocks = [int(np.prod(_shape(s, sp, (2, 2)))) for s, sp in zip(shapes, NMT_SPECS)]
    names = [set() if sp is None else {a for e in sp if e is not None
                                       for a in ((e,) if isinstance(e, str) else e)}
             for sp in NMT_SPECS]
    part = [b * (2 if "data" in n else 1) for b, n in zip(blocks, names)]
    want = {"data": 2 * sum(part),
            "shard": sum(b + 2 * p for b, p, n in zip(blocks, part, names) if "shard" in n),
            "data gather": sum(b * (2 if "shard" in n else 1)
                               for b, n in zip(blocks, names) if "data" in n)}
    model = overlap.comm_model(fam, rank=RANK, param_shapes=shapes, param_specs=NMT_SPECS,
                               mesh_shape={"data": 2, "shard": 2})
    for moved in cases["payload"]:
        assert moved[FAMS.index(fam)] == want
        assert 4 * (want["data gather"] + sum(b for b, n in zip(blocks, names)
                                              if "shard" in n)) == \
            model["tp_gather_bytes_per_step"] / 3


@pytest.mark.parametrize("mesh", ROUNDTRIP_MESHES, ids=str)
@pytest.mark.parametrize("case", [c[0] for c in ROUNDTRIP])
def test_data_split_roundtrip_matches_jax_placement(cases, mesh, case):
    """`shard_params` gives the rank at (d, s) the block that JAX's
    `NamedSharding` places on the device at (d, s) (GSPMD's block order,
    a tuple's first axis the major one), which is numpy's slicing at block
    d * shard + s under ("data", "shard") and s * data + d under
    ("shard", "data"); `gather_params` joins the blocks back, and a
    replicated leaf passes through as the same tensor."""
    i = [c[0] for c in ROUNDTRIP].index(case)
    full, spec = cases["leaves"][i]
    data, shard = mesh
    for res in cases["roundtrip"]:
        r = res[mesh]
        d, s = r["data_rank"], r["shard_rank"]
        np.testing.assert_array_equal(r["full"][i], full)
        assert r["same"][i]
        np.testing.assert_array_equal(r["local"][i], cases["placed"][mesh][(d, s)][i])
        want = full
        for k, entry in enumerate(spec or ()):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            if axes:
                deg = {"data": data, "shard": shard}
                coord = {"data": d, "shard": s}
                block = 0
                for a in axes:
                    block = block * deg[a] + coord[a]
                want = np.split(want, int(np.prod([deg[a] for a in axes])), axis=k)[block]
        np.testing.assert_array_equal(r["local"][i], want)


COMM_CASES = [("mlp_data_only", MLP_SHAPES, DATA_ONLY), ("mlp_both", MLP_SHAPES, BOTH),
              ("nmt", jnmt.layer_shapes(JCFG), NMT_SPECS),
              ("roundtrip", [c[1] for c in ROUNDTRIP], [c[2] for c in ROUNDTRIP])]


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1), (4, 1), (1, 4)], ids=str)
@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("case", [c[0] for c in COMM_CASES])
def test_comm_model_matches_jax(case, fam, mesh):
    """The port's copy of `overlap.comm_model` gives the JAX package's
    numbers for specs that name `data`, alone and with `shard`."""
    _, shapes, specs = [c for c in COMM_CASES if c[0] == case][0]
    mesh_shape = {"data": mesh[0], "shard": mesh[1]}
    assert overlap.comm_model(fam, rank=RANK, param_shapes=shapes, param_specs=specs,
                              mesh_shape=mesh_shape) == \
        joverlap.comm_model(fam, rank=RANK, param_shapes=shapes, param_specs=_jspecs(specs),
                            mesh_shape=mesh_shape)
