"""The low-rank family: one flat Q = (I + U V^T) diag(d) of rank `rank`
over all parameters raveled; on a mesh its lanes split over `shard`."""
from __future__ import annotations

import math

import torch

from benchmark import work


def program_kwargs(cfg: dict, model) -> dict:
    return {"rank": int(cfg["optimizer"]["rank"])}


def coins(generator):
    """(rebalance, update U): probabilities 0.01 and 0.5."""
    balance = torch.rand((), generator=generator).item() < 0.01
    return balance, torch.rand((), generator=generator).item() < 0.5


def span_targets():
    from psgd_tf_tpu_torch.optim import psgd
    mod = psgd._FLAT_FAMILIES.get("lra")
    return [] if mod is None else [(mod, "update_apply"), (mod, "apply")]


def _n(cfg, model) -> int:
    return sum(math.prod(s) for s in model.shapes(cfg))


def step_flops(cfg: dict, model) -> tuple[float, float]:
    n, r = _n(cfg, model), int(cfg["optimizer"]["rank"])
    return work.family_work("lra", n, r)[1], work.lra_apply_work(n, r)[1]


def bound_ms(cfg: dict, model, calls: dict, steps: int, mesh=None) -> float:
    """Each call over this rank's lanes (a `shard`-th of them on a mesh)."""
    lanes, r = _n(cfg, model), int(cfg["optimizer"]["rank"])
    if mesh is not None:
        lanes = -(-lanes // mesh.shard)
    return (calls.get("lra.update_apply", 0) * work.bound_ms(*work.family_work("lra", lanes, r))
            + calls.get("lra.apply", 0) * work.bound_ms(*work.lra_apply_work(lanes, r)))


def reference_kwargs(cfg: dict, model) -> dict:
    return {"rank": int(cfg["optimizer"]["rank"])}
