"""The yardstick's numbers: the bounds in PERF.md's kernel table and the
NMT model's FLOPs."""
import pytest

from benchmark import work

NMT = dict(vocab_tgt=4935, embed=256, units=1024, attn=10, src_len=18, tgt_len=13)


def test_k13_bound_at_2_20():
    nbytes, flops = work.family_work("lra", 1 << 20, 10)
    assert work.bound_ms(nbytes, flops) == pytest.approx(0.0576, abs=1e-4)
    assert work.bound_by(nbytes, flops) == "bytes"


def test_k10_bound_at_the_three_nmt_layers():
    # the reference's three (scale, dense) layers, as K10 takes them
    layers = [(256, 9414), (10, 2048), (256, 4935)]
    total = sum(work.bound_ms(*work.kron_work(("dense", "scale"), s)) for s in layers)
    assert total == pytest.approx(0.0568, abs=1e-4)  # the table gives 4 digits
    mirrored = sum(work.bound_ms(*work.kron_work(("scale", "dense"), (n, m))) for m, n in layers)
    assert mirrored == pytest.approx(total)


def test_apply_alone_is_part_of_the_pair():
    for fmt, shape in ((("norm", "scale"), (2305, 1024)), (("scale", "dense"), (9414, 256)),
                       (("dense", "dense"), (1, 10))):
        b0, f0 = work.kron_work(fmt, shape)
        b1, f1 = work.kron_work(fmt, shape, apply=True)
        ba, fa = work.kron_apply_work(fmt, shape)
        assert ba == b0 and b1 == b0 + 4 * shape[0] * shape[1]
        assert fa == pytest.approx(f1 - f0)


def test_nmt_forward_flops_per_sentence():
    enc = 18 * 2 * (256 + 1024) * 1024
    assert enc / 18 == pytest.approx(2.62e6, rel=1e-3)
    out_layer = 2 * 1024 * 4935
    assert out_layer == pytest.approx(10.1e6, rel=1e-3)
    per_dec = (work.nmt_forward_flops(**NMT) - enc) / 12
    assert per_dec == pytest.approx(15.25e6, rel=1e-3)
    assert work.nmt_forward_flops(**NMT) == pytest.approx(230.2e6, rel=1e-4)


def test_step_flops_at_the_cell():
    from benchmark.models import nmt
    from benchmark import spec

    cell = spec.load("nmt_kron.tok127k")
    fwd = nmt.forward_flops(cell.config, cell.traffic)
    assert 6 * fwd == pytest.approx(5.66e12, rel=1e-3)
