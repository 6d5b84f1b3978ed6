"""The Kronecker family: a factor pair a weight, in the model's formats."""
from __future__ import annotations

from benchmark import work


def program_kwargs(cfg: dict, model) -> dict:
    return {"kron_formats": model.formats(cfg)}


def coins(generator):
    return None  # kron draws no coin of its own


def span_targets():
    from psgd_tf_tpu_torch.groups import kron
    return [(kron, "update_multi"), (kron, "apply")]


def _layers(cfg, model):
    return list(zip(model.formats(cfg), model.shapes(cfg)))


def step_flops(cfg: dict, model) -> tuple[float, float]:
    layers = _layers(cfg, model)
    return (sum(work.kron_work(f, s, apply=True)[1] for f, s in layers),
            sum(work.kron_apply_work(f, s)[1] for f, s in layers))


def bound_ms(cfg: dict, model, calls: dict, steps: int, mesh=None) -> float:
    """An update step's `update_multi` updates and applies every layer; a
    step without it applies them (`kron.apply`)."""
    layers = _layers(cfg, model)
    upd = sum(work.bound_ms(*work.kron_work(f, s, apply=True)) for f, s in layers)
    app = sum(work.bound_ms(*work.kron_apply_work(f, s)) for f, s in layers)
    n_upd = calls.get("kron.update_multi", 0)
    return n_upd * upd + max(0, steps - n_upd) * app


def reference_kwargs(cfg: dict, model) -> dict:
    return {"formats": model.formats(cfg)}
