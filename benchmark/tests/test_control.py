"""The control of each one-card cell's check, on the card at a batch a test
run can hold: the reference computed with TF32 on, put in the program's
place, and the reference with half of every batch left out, each come out
not correct against the cell's limits, while the reference with every
batch's rows in another order (sound, with other round-off) comes out
correct. The full-size readings come from `benchmark/control.py` on the
card (PERF.md)."""
import pytest
import torch

from benchmark import check, control, spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from benchmark import harness

    harness.set_precision()
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["nmt_kron.tok127k", "nmt_lra.tok127k", "nmt_kron.tok127k.p10"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails(card, name, seed):
    cell = spec.load(name)
    r = control.readings(cell, seed, card, batch=512)
    for kind in ("tf32", "half_batch"):
        ok, nums = check.judge(r[kind], cell.limits)
        assert not ok, (kind, nums)
    ok, nums = check.judge(r["reordered"], cell.limits)  # sound, with other round-off
    assert ok, nums
