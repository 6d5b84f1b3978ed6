"""Port parity for `utils/` (metrics, finite checks, profiling, checkpoint),
`config.py` and the CLI: psgd_tf_tpu_torch against psgd_tf_tpu on the
CPU, on the same numpy arrays, and checkpoint resume bit for bit."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu import config as jconfig
from psgd_tf_tpu.utils import checks as jchecks
from psgd_tf_tpu.utils import metrics as jmetrics
from psgd_tf_tpu.workloads import hello_psgd as jhello_psgd
from psgd_tf_tpu.workloads import nmt_attention as jnmt_attention
from psgd_tf_tpu_torch import PSGD, config
from psgd_tf_tpu_torch.__main__ import WORKLOADS, main
from psgd_tf_tpu_torch.data import mnist
from psgd_tf_tpu_torch.models import lenet5, nmt, rosenbrock, tensor_decomp
from psgd_tf_tpu_torch.optim.psgd import KronPrecond, PSGDState
from psgd_tf_tpu_torch.utils import checkpoint, checks, metrics, profiling
from psgd_tf_tpu_torch.workloads import hello_psgd, nmt_attention

torch.set_num_threads(1)


def _arrays(seed, bad=False):
    """A nested dict/list tree of numpy arrays; with `bad`, NaN and Inf in
    two of its leaves."""
    rng = np.random.default_rng(seed)
    tree = {"b": rng.standard_normal((3, 4)).astype(np.float32),
            "a": [rng.standard_normal(5).astype(np.float32),
                  {"z": rng.standard_normal((2, 2)).astype(np.float32),
                   "y": rng.standard_normal(()).astype(np.float32)}],
            "c": (rng.standard_normal(7).astype(np.float32),)}
    if bad:
        tree["a"][1]["z"][0, 1] = np.nan
        tree["c"][0][3] = np.inf
    return tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _both(seed, bad=False):
    tree = _arrays(seed, bad)
    return _map(tree, torch.from_numpy), _map(tree, jnp.asarray)


# ------------------------------------------------------------------ metrics and checks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    t, j = _both(seed)
    assert abs(metrics.tree_norm(t).item() - float(jmetrics.tree_norm(j))) <= 1e-6 * float(
        jmetrics.tree_norm(j))
    assert metrics.finite_fraction(t).item() == pytest.approx(
        float(jmetrics.finite_fraction(j)), abs=1e-6)
    tb, jb = _both(seed, bad=True)
    assert metrics.finite_fraction(tb).item() == pytest.approx(
        float(jmetrics.finite_fraction(jb)), abs=1e-6)
    assert metrics.finite_fraction(tb).item() < 1.0


@pytest.mark.parametrize("bad", [False, True])
def test_checks_match_jax(bad):
    t, j = _both(3, bad)
    ok = checks.all_finite(t)
    assert isinstance(ok, torch.Tensor) and ok.dim() == 0 and ok.dtype == torch.bool
    assert bool(ok) == bool(jchecks.all_finite(j)) == (not bad)
    assert checks.first_nonfinite(t) == jchecks.first_nonfinite(j)
    assert checks.first_nonfinite(t) == (["['a'][1]['z']", "['c'][0]"] if bad else [])
    if bad:
        with pytest.raises(FloatingPointError, match=r"non-finite values in params.*\['c'\]\[0\]"):
            checks.assert_finite(t, "params")
    else:
        checks.assert_finite(t, "params")
    assert bool(checks.all_finite({}))


def test_checks_walk_the_ports_states():
    params = rosenbrock.init(device="cpu")
    state = PSGD(preconditioner="lra", rank=2).init(params)
    assert checks.first_nonfinite(state) == []
    bad = state.replace(precond=state.precond.__class__(
        UV=state.precond.UV, d=torch.full_like(state.precond.d, float("nan"))))
    assert checks.first_nonfinite({"opt": bad, "params": params}) == ["['opt'].precond.d"]
    with pytest.raises(FloatingPointError, match="opt"):
        checks.assert_finite(bad, "opt")


def test_reporter_history_and_jsonl(tmp_path):
    hist, jhist = metrics.History(), jmetrics.History()
    rep, jrep = metrics.Reporter([hist], every=2), jmetrics.Reporter([jhist], every=2)
    for step in range(6):
        rep.push(step, {"loss": torch.tensor(float(step))})
        jrep.push(step, {"loss": jnp.asarray(float(step))})
    assert hist.rows == jhist.rows == [{"step": s, "loss": float(s)} for s in (0, 2, 4)]
    path = tmp_path / "m.jsonl"
    sink = metrics.JsonlSink(str(path))
    metrics.Reporter([sink]).push(3, {"loss": torch.tensor(0.5), "grad_norm": torch.tensor(2.0)})
    sink.close()
    row = json.loads(path.read_text().strip())
    assert row["step"] == 3 and row["loss"] == 0.5 and row["grad_norm"] == 2.0 and "t" in row


def test_profiling_scope_trace_and_timer(tmp_path):
    @profiling.scope("decorated")
    def f(x):
        return x * 2

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.scope("psgd_region"):
            y = f(torch.ones(3)).sum()
    assert y.item() == 6.0
    names = {e.key for e in prof.key_averages()}
    assert {"psgd_region", "decorated"} <= names
    files = [p for p in os.listdir(tmp_path) if p.endswith(".pt.trace.json")]
    assert len(files) == 1
    assert "psgd_region" in (tmp_path / files[0]).read_text()


# ------------------------------------------------------------------ config and CLI


def test_schema_matches_jax_for_every_workload():
    import importlib

    for name in WORKLOADS:
        ours = config.schema(importlib.import_module(f"psgd_tf_tpu_torch.workloads.{name}").run)
        theirs = jconfig.schema(importlib.import_module(f"psgd_tf_tpu.workloads.{name}").run)
        assert ours.pop("device") == "cuda"  # the port's one extra key
        assert set(ours) == set(theirs), name
        for k, v in ours.items():
            assert (tuple(v) if isinstance(v, tuple) else v) == (
                tuple(theirs[k]) if isinstance(theirs[k], tuple) else theirs[k]), (name, k)
    s = config.schema(hello_psgd.run)
    assert s["steps"] == 500 and s["preconditioner"] == "dense" and s["lr_params"] == 0.5


def test_load_file_overrides_and_coercion_match_jax(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"steps": 10, "lr_params": 0.3}))
    for sets in (["steps=20", "seed=7"], ["lr_params=0.25", "steps=3"], []):
        cfg = config.load(hello_psgd.run, str(p), sets)
        assert cfg == jconfig.load(jhello_psgd.run, str(p), sets)
    cfg = config.load(hello_psgd.run, None, ["lr_params=0.25", "steps=3", "device=cpu"])
    assert cfg == {"lr_params": 0.25, "steps": 3, "device": "cpu"}
    assert isinstance(cfg["steps"], int)
    # a NamedTuple default takes a JSON object; None a JSON literal; bools
    sets = ['cfg={"embed": 8, "units": 16}', "lr=0.05", "exact_hvp=yes", "data_path=spa.txt"]
    cfg = config.load(nmt_attention.run, None, sets)
    jcfg = jconfig.load(jnmt_attention.run, None, sets)
    assert cfg["cfg"] == nmt.Config(embed=8, units=16) and isinstance(cfg["cfg"], nmt.Config)
    assert tuple(cfg["cfg"]) == tuple(jcfg["cfg"])
    assert {k: v for k, v in cfg.items() if k != "cfg"} == {
        k: v for k, v in jcfg.items() if k != "cfg"} == {
        "lr": 0.05, "exact_hvp": True, "data_path": "spa.txt"}


@pytest.mark.parametrize("bad,match", [(["nope=1"], "unknown config keys"),
                                       (["steps"], "not key=value"),
                                       (['cfg=[1, 2]'], "expected a JSON object")])
def test_load_refusals_match_jax(bad, match):
    run, jrun = (nmt_attention.run, jnmt_attention.run)
    with pytest.raises(ValueError, match=match):
        config.load(run, None, bad)
    with pytest.raises(ValueError, match=match):
        jconfig.load(jrun, None, bad)


def test_cli_list_and_run(capsys):
    assert main(["list"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [l.split(":")[0] for l in out] == WORKLOADS
    assert json.loads(out[0].split(": ", 1)[1])["device"] == "cuda"
    rc = main(["run", "hello_psgd", "--set", "steps=120", "--set", "device=cpu"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == 120 and "loss" in result
    assert rc == (0 if result["success"] else 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["bench"])


# ------------------------------------------------------------------ checkpoint


def _rosenbrock_lra(steps):
    opt = PSGD(preconditioner="lra", rank=2, init_scale=0.1, lr_params=0.01,
               lr_preconditioner=0.1)
    params = rosenbrock.init(device="cpu")
    state = opt.init(params, seed=0)
    g = torch.Generator().manual_seed(1)
    for _ in range(steps):
        params, state, _ = opt.step(rosenbrock.loss, params, state, g)
    return opt, params, state, g


def _leaves_equal(a, b):
    ta = [x for _, x in checkpoint._tree.tensors_with_path(a)]
    tb = [x for _, x in checkpoint._tree.tensors_with_path(b)]
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


def test_checkpoint_roundtrip_lra_rosenbrock(tmp_path):
    opt, params, state, g = _rosenbrock_lra(5)
    train_state = {"params": params, "opt": state, "gen": g}
    checkpoint.save(str(tmp_path), 5, train_state)
    assert checkpoint.latest_step(str(tmp_path)) == 5
    fresh = {"params": rosenbrock.init(device="cpu"),
             "opt": opt.init(rosenbrock.init(device="cpu"), seed=3),
             "gen": torch.Generator().manual_seed(0)}
    restored = checkpoint.restore(str(tmp_path), like=fresh)
    _leaves_equal(restored, train_state)
    assert isinstance(restored["opt"], PSGDState) and restored["opt"].count == 5
    assert restored["opt"].hyper == state.hyper
    assert torch.equal(restored["opt"].branch.get_state(), state.branch.get_state())
    assert torch.equal(restored["gen"].get_state(), g.get_state())
    # the restored Q factors, coins and generator resume the trajectory exactly
    _, _, aux = opt.step(rosenbrock.loss, params, state, g)
    _, _, aux_r = opt.step(rosenbrock.loss, restored["params"], restored["opt"], restored["gen"])
    assert aux["loss"].item() == aux_r["loss"].item()


def _kron_stacked():
    """LeNet5 under kron with a stacked bucket: its three (128, 128)-padded
    layers at kron_batch_min=2."""
    opt = PSGD(preconditioner="kron", kron_formats=[("dense", "dense")] * 5, lr_params=0.1,
               lr_preconditioner=0.1, grad_clip_max_norm=5.0, kron_batch_min=2)
    g = torch.Generator().manual_seed(0)
    params = lenet5.init(g)
    return opt, params, g, lambda g: mnist.synthetic_hard(g, 16), lenet5.loss


def _splu_coin():
    """The tensor decomposition under splu with an update coin (probability
    0.5): the coin generator decides which steps update."""
    opt = PSGD(preconditioner="splu", rank=3, init_scale=0.1, lr_params=0.1,
               lr_preconditioner=0.1, preconditioner_update_probability=0.5)
    g = torch.Generator().manual_seed(0)
    target = tensor_decomp.make_target(g, (4, 5, 6))
    params = tensor_decomp.init(g, (4, 5, 6), rank=3)
    return opt, params, g, lambda g: (target,), tensor_decomp.loss


def _lra_coins():
    opt = PSGD(preconditioner="lra", rank=2, init_scale=0.1, lr_params=0.1,
               lr_preconditioner=0.1, preconditioner_update_probability=0.7)
    g = torch.Generator().manual_seed(0)
    target = tensor_decomp.make_target(g, (4, 5, 6))
    params = tensor_decomp.init(g, (4, 5, 6), rank=3)
    return opt, params, g, lambda g: (target,), tensor_decomp.loss


@pytest.mark.parametrize("make", [_kron_stacked, _splu_coin, _lra_coins],
                         ids=["kron_stacked", "splu_coin", "lra_coins"])
def test_checkpoint_resume_is_bit_equal(tmp_path, make):
    """5 steps, save, restore into a fresh init, 5 more: bit-equal to 10
    uninterrupted steps, params and every state leaf and generator."""
    def steps(opt, params, state, g, batch, loss, n):
        for _ in range(n):
            params, state, _ = opt.step(loss, params, state, g, *batch(g))
        return params, state

    opt, params, g, batch, loss = make()
    state = opt.init(params, seed=4)
    if opt.preconditioner == "kron":
        assert isinstance(state.precond, KronPrecond) and state.precond.batched_idx == ((0, 3, 4),)
    else:
        assert state.coin is not None
    p10, s10 = steps(opt, params, state, g, batch, loss, 10)
    g10 = g.get_state()

    opt, params, g, batch, loss = make()
    state = opt.init(params, seed=4)
    params, state = steps(opt, params, state, g, batch, loss, 5)
    checkpoint.save(str(tmp_path), 5, {"params": params, "opt": state, "gen": g})
    _, fresh_params, fresh_g, _, _ = make()
    like = {"params": fresh_params, "opt": opt.init(fresh_params, seed=99), "gen": fresh_g}
    r = checkpoint.restore(str(tmp_path), like=like)
    assert r["opt"].count == 5 and r["gen"] is not fresh_g
    p, s = steps(opt, r["params"], r["opt"], r["gen"], batch, loss, 5)
    assert bool(checks.all_finite(p10))
    _leaves_equal({"p": p, "s": s}, {"p": p10, "s": s10})
    assert s.count == s10.count == 10
    assert torch.equal(r["gen"].get_state(), g10)
    for name in ("coin", "branch"):
        a, b = getattr(s, name), getattr(s10, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.get_state(), b.get_state())


def test_checkpoint_latest_step_and_overwrite(tmp_path):
    _, params, state, _ = _rosenbrock_lra(2)
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        checkpoint.restore(str(tmp_path / "none"))
    for s in (1, 3, 10, 2):
        checkpoint.save(str(tmp_path), s, {"params": params, "step": s})
    assert checkpoint.latest_step(str(tmp_path)) == 10
    assert checkpoint.restore(str(tmp_path))["step"] == 10
    assert checkpoint.restore(str(tmp_path), step=3)["step"] == 3
    with pytest.raises(FileExistsError):
        checkpoint.save(str(tmp_path), 3, {"params": params, "step": 33})
    checkpoint.save(str(tmp_path), 3, {"params": params, "step": 33}, force=True)
    assert checkpoint.restore(str(tmp_path), step=3)["step"] == 33
    assert sorted(os.listdir(tmp_path)) == ["1", "10", "2", "3"]


def test_checkpoint_on_disk_is_plain_data(tmp_path):
    """The file holds tensors, dicts, lists, numbers and strings under a
    format version, with the dataclass type names beside their fields."""
    opt, params, state, g = _rosenbrock_lra(3)
    checkpoint.save(str(tmp_path), 3, {"params": params, "opt": state, "gen": g})
    raw = torch.load(str(tmp_path / "3" / "state.pt"), weights_only=True)
    assert raw["format"] == checkpoint.FORMAT

    def walk(x):
        if isinstance(x, dict):
            assert all(isinstance(k, str) for k in x)
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        else:
            assert x is None or isinstance(x, (torch.Tensor, bool, int, float, str)), type(x)

    walk(raw)
    opt_rec = raw["tree"]["items"]["opt"]
    assert opt_rec["__type__"] == "psgd_tf_tpu_torch.optim.psgd.PSGDState"
    assert opt_rec["fields"]["hyper"]["__type__"] == "psgd_tf_tpu_torch.optim.psgd.Hyper"
    assert opt_rec["fields"]["precond"]["__type__"] == "psgd_tf_tpu_torch.groups.lra.LRAState"
    assert opt_rec["fields"]["branch"]["__type__"] == "torch.Generator"
    # without `like`, the tree as stored
    plain = checkpoint.restore(str(tmp_path))
    assert isinstance(plain["params"], list) and plain["opt"]["fields"]["count"] == 3
    assert torch.equal(plain["opt"]["fields"]["precond"]["fields"]["UV"], state.precond.UV)


def test_checkpoint_refuses_a_mismatched_like(tmp_path):
    opt, params, state, g = _rosenbrock_lra(3)
    checkpoint.save(str(tmp_path), 3, {"params": params, "opt": state, "gen": g})
    fresh = rosenbrock.init(device="cpu")
    good = {"params": fresh, "opt": opt.init(fresh), "gen": torch.Generator()}
    cases = [
        ({**good, "opt": dataclasses.replace(opt, rank=3).init(fresh)},
         r"\['opt'\]\.precond\.UV: shape \(4, 2\) in the checkpoint, \(6, 2\)"),
        ({**good, "opt": PSGD(preconditioner="diag").init(fresh)},
         r"\['opt'\]\.precond: psgd_tf_tpu_torch\.groups\.lra\.LRAState in the checkpoint, "
         r"psgd_tf_tpu_torch\.groups\.diag\.DiagState"),
        ({**good, "params": fresh + [fresh[0]]}, r"\['params'\]: a list of 2 in the checkpoint"),
        ({k: v for k, v in good.items() if k != "gen"}, r"\['gen'\]: only in the checkpoint"),
        ({**good, "gen": torch.zeros(())}, r"\['gen'\]: a tensor in `like`"),
    ]
    for like, match in cases:
        with pytest.raises(ValueError, match=match):
            checkpoint.restore(str(tmp_path), like=like)
    # a stacked-bucket layout that differs is refused, not restored silently
    kopt, kparams, kg, _, _ = _kron_stacked()
    checkpoint.save(str(tmp_path), 4, kopt.init(kparams))
    for other, match in [(dataclasses.replace(kopt, kron_batch_min=4),
                          r"\.precond: a list of 5 in `like`|\.precond: .*KronPrecond"),
                         (dataclasses.replace(kopt, kron_formats=[("dense", "dense")] * 4
                                              + [("scale", "dense")]),
                          r"\.precond\.batches\[0\]\.ql: shape \(3, 128, 128\) in the checkpoint, "
                          r"\(2, 128, 128\) in `like`")]:
        with pytest.raises(ValueError, match=match):
            checkpoint.restore(str(tmp_path), step=4, like=other.init(kparams))
    # another format version is refused
    raw = torch.load(str(tmp_path / "3" / "state.pt"), weights_only=True)
    raw["format"] = checkpoint.FORMAT + 1
    torch.save(raw, str(tmp_path / "3" / "state.pt"))
    with pytest.raises(ValueError, match="format"):
        checkpoint.restore(str(tmp_path), step=3, like=good)
