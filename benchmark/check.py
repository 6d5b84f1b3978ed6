"""The comparison that decides `correct`.

The program's first three steps, taken in set-up through the window's own
call and feed, against the plain reference following the same three steps
from the same weights, batches, probes and coins:

  loss_gap    the largest relative gap of a step's loss
  grad_gap    the first step's gradient as the optimizer gets it: the gap
              between the program's norm of a leaf and the reference's
  change_gap  the parameters' change in each step that the cell's limits
              name (`change_steps`, step 1 where none are named), likewise,
              the worst step: in step 1 the gradient, the FD Hvp, the Q
              update, the apply, the clip and the descent; in a
              gradient-only step the gradient, the apply with Q left as
              it is, the clip and the descent. A later update step takes
              its FD Hvp at parameters that differ by round-off, which the
              difference quotient amplifies by 1/delta (~2,900), so only a
              cell's first update step is compared (PERF.md).

A leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger, and the worst leaf counts. Leaves
whose reference gradient is under a thousandth of the median leaf's move
by round-off alone and are left out of both leaf gaps. Each number has the
cell's limit (`limits/<cell>.json`); a missing or non-finite number fails.
"""
from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def _norms(xs):
    return [float(torch.linalg.vector_norm(x.double())) for x in xs]


def leaf_gap(prog, ref, keep=None) -> float:
    """max over the kept leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn)
    idx = range(len(rn)) if keep is None else keep
    return max(abs(p - q) / max(q, med, 1e-30) for p, q in ((pn[i], rn[i]) for i in idx))


def kept_leaves(ref_grads) -> list[int]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    rn = _norms(ref_grads)
    med = statistics.median(rn)
    return [i for i, q in enumerate(rn) if q >= 1e-3 * med]


def change_gaps(prog: dict, ref: dict, p0, keep=None) -> list[list[float]]:
    """Each step's leaf gaps of the parameters' change in that step: the
    parameters after it less those before it, on each side."""
    out = []
    before = (list(p0), list(p0))
    for pp, rp in zip(prog["params"], ref["params"]):
        pn = _norms([p - q for p, q in zip(pp, before[0])])
        rn = _norms([p - q for p, q in zip(rp, before[1])])
        before = (pp, rp)
        med = statistics.median(rn)
        idx = range(len(rn)) if keep is None else keep
        out.append([abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in idx])
    return out


def gaps(prog: dict, ref: dict, p0, change_steps=(1,)) -> dict:
    """The three numbers from the program's and the reference's readings:
    each a dict with `losses` (a float a step), `grads` (step 1's
    gradient) and `params` (the parameters after each step); `p0` the
    weights both started from; `change_steps` the steps, from 1, whose
    change is compared."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    keep = kept_leaves(ref["grads"])
    grad = leaf_gap(prog["grads"], ref["grads"], keep)
    by_step = change_gaps(prog, ref, p0, keep)
    change = max(max(by_step[k - 1]) for k in change_steps)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def change_steps(limits: dict) -> tuple[int, ...]:
    """The steps, from 1, whose change a cell's limits name (step 1 by
    default)."""
    return tuple(int(k) for k in limits.get("change_steps", (1,)))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at or
    under its limit."""
    out, ok = {}, True
    for name in NUMBERS:
        v, lim = numbers.get(name), float(limits[name])
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        out[name] = {"value": v, "limit": lim}
    return ok, out
