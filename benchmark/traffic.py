"""The one traffic generator: a closed loop of training steps.

A traffic file (`traffic/<name>.json`) gives the global batch and the
model's input sizes (for the NMT model the padded source and target
lengths), the preconditioner's update probability, the mesh the step runs
on and the traced run's `trace_steps`. Every step's inputs, probes and
coins come from `--seed` alone, so both the program and the reference get
the same: the inputs drawn by the model's `inputs` (`models/<model>.py`),
one N(0, 1) probe per parameter tensor, and the family's own coins
(`families/<family>.py`). The update coin, which the optimizer draws from
its own CPU generator, is the same in every run (`OPTIMIZER_SEED`).
"""
from __future__ import annotations

import torch

_MASK = (1 << 63) - 1
# The optimizer's own seed (its update coin, lra's initial U and V), one for
# every run: the update coin decides which steps carry the Hvp and the Q
# update, so a seed of its own would change the window's work (by 1.6% of
# the tokens a window at probability 0.1). At 0.1 this one updates at step
# 1 and not at steps 2-4, and on 38 of the 376 steps after the first four.
OPTIMIZER_SEED = 64


def sub_seed(seed: int, k: int) -> int:
    """A seed of its own for each stream drawn from one run's seed."""
    return (seed * 1_000_003 + k * 7_919) & _MASK


class Traffic:
    """Step i's inputs, drawn in step order from generators seeded once."""

    def __init__(self, cell, seed: int, device):
        self.traffic, self.cfg = cell.traffic, cell.config
        self.model, self.family = cell.model, cell.family
        self.shapes = [tuple(s) for s in self.model.shapes(self.cfg)]
        self.device = torch.device(device)
        self.data = torch.Generator(self.device).manual_seed(sub_seed(seed, 1))
        self.probe = torch.Generator(self.device).manual_seed(sub_seed(seed, 2))
        self.coin = torch.Generator().manual_seed(sub_seed(seed, 3))

    def probes(self):
        return [torch.randn(s, generator=self.probe, device=self.device) for s in self.shapes]

    def next(self):
        """(inputs, probes, coins) of the next step."""
        return (self.model.inputs(self.traffic, self.cfg, self.data), self.probes(),
                self.family.coins(self.coin))


def update_flags(seed: int, probability: float, steps: int) -> list[bool]:
    """Which of the first `steps` steps update the preconditioner: the coin
    the optimizer draws from a CPU generator seeded with `seed`, one
    uniform draw a step, below `probability`."""
    if probability >= 1.0:
        return [True] * steps
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand((), generator=gen).item() < probability for _ in range(steps)]
