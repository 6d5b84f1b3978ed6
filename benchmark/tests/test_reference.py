"""The frozen reference against the program at tiny widths: one kron step
and one lra step (and three on the mesh's traffic) from the same weights,
batches, probes and coins."""
import pytest
import torch

from benchmark import check, harness
from benchmark.reference.psgd import Trainer
from benchmark.tests import tiny
from benchmark.traffic import Traffic


@pytest.mark.parametrize("name", ["nmt_kron.tok127k", "nmt_lra.tok127k"])
def test_one_step_matches_the_program(name):
    cell = tiny.cell(name)
    dev = torch.device("cpu")
    prog = harness.Program(cell, 2**33 + 5, dev)
    feed = Traffic(cell, 2**33 + 5, dev)
    batch, probes, coins = feed.next()
    with harness.Capture() as cap:
        aux = prog.step(batch, probes, coins)
    ref = Trainer(cell.config["optimizer"], prog.p0, cell.reference_family, seed=prog.opt_seed,
                  **cell.family.reference_kwargs(cell.config, cell.model))
    params, loss, grads = ref.step(cell.model.reference_loss(), prog.p0, batch, probes, True, coins)
    assert float(aux["loss"]) == pytest.approx(float(loss), rel=1e-6)
    for a, b in zip(cap.got[1], grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    for a, b in zip(prog.params, params):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert any(not torch.equal(a, b) for a, b in zip(prog.params, prog.p0))


@pytest.mark.parametrize("name", ["nmt_kron.tok127k", "nmt_lra.tok127k", "nmt_kron.tok127k.p10"])
def test_three_steps_read_under_the_limits(name):
    cell = tiny.cell(name)
    res = harness.measure(cell, 987654321987, 0.2, False, 0.0, device="cpu")
    assert res["correct"], res["checks"]
    assert all(v["value"] < 1e-5 for v in res["checks"].values())
    assert check.NUMBERS == tuple(res["checks"])
