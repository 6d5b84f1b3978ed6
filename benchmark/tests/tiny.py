"""Tiny cells for the CPU tests: the real configurations and traffic with
every size shrunk, and the real cells' limits."""
from __future__ import annotations

import copy

from benchmark import spec

TINY_MODEL = {"vocab_src": 40, "vocab_tgt": 30, "embed": 8, "units": 16, "attn": 4}


def cell(name: str) -> spec.Cell:
    c = copy.deepcopy(spec.load(name))
    c.config.update(TINY_MODEL)
    c.traffic.update(batch=16 if c.mesh else 8, src_len=5, tgt_len=4, trace_steps=2)
    return c
