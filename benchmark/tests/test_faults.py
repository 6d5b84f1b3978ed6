"""A run with the timed path broken underneath comes out not correct: the
whole run but the look for a card, at tiny sizes on the CPU, once for each
fault a training cell can have. A sound run of each cell comes out
correct."""
import pytest

from benchmark import harness
from benchmark.tests import tiny

SEED = 2**31 + 12345


def state_unchanged(prog):
    """The step returns the parameters and the state it was given."""
    step = prog._step
    prog._step = lambda params, st, *a: (params, st, step(params, st, *a)[2])


def half_batch(prog):
    """Half of every batch left out, the mean taken over the rest."""
    step = prog._step
    prog._step = lambda params, st, batch, *a: step(
        params, st, tuple(x[: x.shape[0] // 2] for x in batch), *a)


def no_data_exchange(prog):
    """The all-reduce over the data ranks left out: each data rank keeps its own mean."""
    from psgd_tf_tpu_torch.parallel import _collectives

    _collectives.data_mean = lambda mesh, tensors: list(tensors)


def no_shard_exchange(prog):
    """The sums over the shard ranks (K14's rank-space reductions and the
    apply's) left out: each rank sums its own lanes."""
    from psgd_tf_tpu_torch.parallel import mesh

    mesh.Mesh.psum = lambda self, x: x


@pytest.fixture(autouse=True)
def restore():
    """A fault patches modules in this process too (rank 0): undo it."""
    from psgd_tf_tpu_torch.parallel import _collectives, mesh

    saved = _collectives.data_mean, mesh.Mesh.psum
    yield
    _collectives.data_mean, mesh.Mesh.psum = saved


def _run(name, fault=None, mesh_fault=False):
    cell = tiny.cell(name)
    kw = {"fault": fault, "child_fault": fault} if mesh_fault else {"fault": fault}
    return harness.measure(cell, SEED, 0.1, False, 0.0, device="cpu", **kw)


@pytest.mark.parametrize("name", ["nmt_kron.tok127k", "nmt_lra.tok127k", "nmt_kron.tok127k.p10",
                                  "nmt_lra.mesh2x2"])
def test_sound_runs_are_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
@pytest.mark.parametrize("name", ["nmt_kron.tok127k", "nmt_lra.tok127k", "nmt_kron.tok127k.p10"])
def test_a_broken_step_is_not_correct(name, fault):
    res = _run(name, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, no_data_exchange,
                                   no_shard_exchange])
def test_a_broken_mesh_step_is_not_correct(fault):
    res = _run("nmt_lra.mesh2x2", fault, mesh_fault=True)
    assert not res["correct"], res["checks"]
