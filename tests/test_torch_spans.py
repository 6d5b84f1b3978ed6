"""The port's phase spans (`utils.profiling.scope` in `PSGD.step`, `hvp.py`
and `parallel/step.py`), on the CPU: one profiled step of a small model per
step kind (an FD update step of kron, stacked kron, lra and diag, a
gradient-only step, an exact-Hvp step). The names and the count of each
span a step, their nesting, that the step's every CPU op lies inside
`psgd_step`, that a profiler changes no output bit, that `scope` calls no
`record_function` while no profiler runs, and `psgd_exchange` on a 2-rank
gloo mesh."""
from __future__ import annotations

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parallel_workers as workers
from psgd_tf_tpu_torch import PSGD
from psgd_tf_tpu_torch.optim.psgd import KronPrecond
from psgd_tf_tpu_torch.utils import _tree, profiling

PHASES = ("psgd_step", "psgd_forward", "psgd_grad", "psgd_hvp", "psgd_exchange",
          "psgd_q_update", "psgd_apply")

# name: (PSGD's options, the spans a step opens, by name)
_UPDATE = {"psgd_step": 1, "psgd_grad": 1, "psgd_hvp": 1, "psgd_forward": 2,
           "psgd_q_update": 1}
_GRAD_ONLY = {"psgd_step": 1, "psgd_grad": 1, "psgd_forward": 1, "psgd_apply": 1}
_EXACT = {"psgd_step": 1, "psgd_hvp": 1, "psgd_forward": 1, "psgd_q_update": 1}
CASES = {
    "kron_fd": (dict(preconditioner="kron", kron_batched=False), {**_UPDATE, "psgd_apply": 1}),
    "kron_stacked_fd": (dict(preconditioner="kron"), {**_UPDATE, "psgd_apply": 1}),
    "lra_fd": (dict(preconditioner="lra", rank=2), _UPDATE),  # one sweep updates and applies
    "diag_fd": (dict(preconditioner="diag"), {**_UPDATE, "psgd_apply": 1}),
    "kron_grad_only": (dict(preconditioner="kron", preconditioner_update_probability=0.0),
                       _GRAD_ONLY),
    "lra_grad_only": (dict(preconditioner="lra", rank=2, preconditioner_update_probability=0.0),
                      _GRAD_ONLY),
    "kron_exact": (dict(preconditioner="kron", exact_hessian_vector_product=True),
                   {**_EXACT, "psgd_apply": 1}),
    "lra_exact": (dict(preconditioner="lra", rank=2, exact_hessian_vector_product=True), _EXACT),
}


def mlp_loss(ws, x):
    y = x
    for w in ws[:-1]:
        y = torch.tanh(y @ w)
    y = y + ws[-1]
    return torch.mean(torch.sum(y * y, dim=-1))


def _setup(case):
    kw, _ = CASES[case]
    gen = torch.Generator().manual_seed(3)
    params = ([torch.randn(6, 6, generator=gen) / 2.5 for _ in range(4)]
              + [torch.randn(6, generator=gen)])
    x = torch.randn(10, 6, generator=gen)
    opt = PSGD(lr_params=0.1, lr_preconditioner=0.1, grad_clip_max_norm=1.0,
               **{"exact_hessian_vector_product": False, **kw})
    return opt, params, opt.init(params, seed=5), x


def _step(case, profiled):
    """(params, state, aux, the profile's events or None) of one step."""
    opt, params, state, x = _setup(case)
    step = lambda: opt.step(mlp_loss, params, state, torch.Generator().manual_seed(7), x)
    if not profiled:
        return (*step(), None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step()
    return (*out, prof.events())


def _spans(events):
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in events
            if e.name in PHASES]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_names_and_counts(case):
    events = _step(case, True)[3]
    assert dict(collections.Counter(s[0] for s in _spans(events))) == CASES[case][1]


def test_stacked_case_takes_the_stacked_update():
    _, _, state, _ = _setup("kron_stacked_fd")
    assert isinstance(state.precond, KronPrecond) and state.precond.batches


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_nesting(case):
    spans = _spans(_step(case, True)[3])
    (step,) = [s for s in spans if s[0] == "psgd_step"]
    assert {s[3] for s in spans} == {step[3]}  # all on the calling thread
    assert all(_within(s, step) for s in spans)
    curvature = [s for s in spans if s[0] in ("psgd_grad", "psgd_hvp")]
    for f in (s for s in spans if s[0] == "psgd_forward"):
        assert any(_within(f, c) for c in curvature)
    phases = [s for s in spans if s[0] in ("psgd_grad", "psgd_hvp", "psgd_q_update",
                                            "psgd_apply")]
    for a, b in zip(sorted(phases, key=lambda s: s[1]), sorted(phases, key=lambda s: s[1])[1:]):
        assert a[2] <= b[1], (a, b)  # the phases follow one another


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_op_of_the_step_is_inside_psgd_step(case):
    events = _step(case, True)[3]
    (step,) = [s for s in _spans(events) if s[0] == "psgd_step"]
    ops = [(e.name, e.time_range.start, e.time_range.end) for e in events if e.name not in PHASES]
    assert ops
    assert [o for o in ops if not (step[1] <= o[1] and o[2] <= step[2])] == []


def _state_leaves(state):
    gens = [g.get_state() for g in (state.coin, state.branch) if g is not None]
    return _tree.tensors_with_path(state.precond), gens, state.count


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_profiler_changes_no_output_bit(case):
    p0, s0, a0, _ = _step(case, False)
    p1, s1, a1, _ = _step(case, True)
    assert all(torch.equal(x, y) for x, y in zip(p0, p1)) and len(p0) == len(p1)
    (t0, g0, c0), (t1, g1, c1) = _state_leaves(s0), _state_leaves(s1)
    t0, t1 = list(t0), list(t1)
    assert [k for k, _ in t0] == [k for k, _ in t1] and c0 == c1
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(t0, t1))
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))
    assert a0.keys() == a1.keys()
    assert all(torch.equal(torch.as_tensor(a0[k]), torch.as_tensor(a1[k])) for k in a0)


@pytest.mark.parametrize("case", ["kron_fd", "lra_fd", "kron_grad_only"])
def test_scope_records_only_under_a_profiler(case, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _step(case, False)
    assert calls == []
    _step(case, True)
    assert collections.Counter(calls) == collections.Counter(CASES[case][1])


def test_scope_as_a_decorator_nests():
    @profiling.scope("psgd_outer_test")
    def f(n):
        return f(n - 1) + torch.ones(()) if n else torch.zeros(())

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert f(3).item() == 3  # each call its own scope: the calls nest
        assert f(0).item() == 0
    ranges = sorted(e.time_range.start for e in prof.events() if e.name == "psgd_outer_test")
    assert len(ranges) >= 2
    assert f(2).item() == 2


# ------------------------------------------------------------------ a 2-rank gloo mesh

MESH_RUNS = [
    # (name, mesh (data, shard), PSGD's options, tensor-parallel specs) and the
    # psgd_exchange spans a step opens: inside psgd_step, outside it
    (dict(name="kron_data", mesh=(2, 1), opt=dict(preconditioner="kron")), (1, 0)),
    (dict(name="lra_shard", mesh=(1, 2), opt=dict(preconditioner="lra", rank=2)), (1, 0)),
    (dict(name="lra_data_grad_only", mesh=(2, 1),
          opt=dict(preconditioner="lra", rank=2, preconditioner_update_probability=0.0)), (2, 0)),
    (dict(name="kron_data_specs", mesh=(2, 1), opt=dict(preconditioner="kron"),
          specs=[("data",), None, None]), (1, 2)),
]


def test_exchange_spans_on_a_gloo_mesh(tmp_path):
    out = workers.run(workers.job_spans, 2, tmp_path, [r for r, _ in MESH_RUNS])
    for rank_out in out:
        for (run, want), got in zip(MESH_RUNS, rank_out):
            assert (got["exchange_inside"], got["exchange_outside"]) == want, run["name"]
            assert got["counts"]["psgd_step"] == 1
            assert got["counts"]["psgd_forward"] >= 1
